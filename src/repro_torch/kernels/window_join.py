"""CUDA kernels for the CEP masked windowed cross-join: build, bind, launch.

The hot loop of the vectorized CEP engine is, per plan step, a dense
cross-evaluation of ``C`` constraint rows between ``M`` partial matches and
``B`` buffered events, for every fleet partition ``k``:

    ok[k, m, b] = AND_c cmp(op[k, c], L[k, c, m], R[k, c, b], theta[k, c]).

Every join and count takes the thresholds as one ``(C,)`` vector shared
by the batch (the order and tree engines) or as ``(K, C)``, a row per
batch element (the rulebook, whose rules differ in window and predicate
thresholds); the kernel reads ``thetas[k * th_stride + c]`` with
``th_stride`` 0 or C, so a shared vector is neither copied nor expanded.

Five kernels, written by hand for Hopper in ``csrc/window_join.cu``:

* ``window_join_packed_bits_cuda`` replaces ``window_join_packed_pallas``:
  the order engine's join step, validity as two uint8 vectors.  Out: the
  mask as bit words ``(K, M, ceil(B/32))`` int32 (bit ``j`` of word ``w``
  in row ``m`` is cell ``b = 32 w + j``; tail bits past ``B`` are 0) and
  each row's survivor count ``(K, M)`` int32.
* ``window_join_bits_cuda`` replaces ``window_join_pallas``: the tree
  engine's join step, validity as two ordinary f32 rows; the same two
  outputs.
* ``select_survivors_cuda`` replaces the reference's fixed-size
  ``jnp.nonzero`` in ``_compact`` (not a TPU kernel): from the bit words
  and row counts, the row-major flat indices ``m * B + b`` of the first
  ``out_cap`` survivors, ``M * B`` after the last one.  It reads only the
  rows that hold a survivor below ``out_cap``.
* ``window_join_rowcount_cuda`` replaces ``window_join_rowcount_pallas``:
  per-row counts ``(K, M)`` int32 of the unpacked join's mask for the
  negation veto and the Kleene count; the mask is never stored.
* ``window_join_count_cuda`` replaces ``window_join_count_pallas``: the
  total of the unpacked mask per partition, ``(K,)`` int32; the mask is
  never stored.

The two joins and the two counts are one kernel body that evaluates
32-row strips in registers; only what each writes differs.

``window_join_packed_cuda`` and ``window_join_cuda`` give the bool mask of
the two bit-word joins (unpacked from their words) for callers that want
it; the engine compacts from the words and never unpacks them.

Build.  The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, under
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the source and flags (a changed source rebuilds, an unchanged one loads).
It is loaded with ``ctypes``.  Nothing here runs at import: the module
imports on a machine without ``nvcc`` or a GPU, and only a launch builds.

Launch.  Each wrapper checks device, dtype, shape and contiguity, allocates
its outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the C launcher returns a CUDA error.  It adds one to its entry
of ``LAUNCHES`` where it launches, and nowhere else.  The kernels are
capture-safe: they allocate nothing and never synchronise, so a step that
calls them can be captured as a CUDA graph; a replay adds the launches
its capture recorded to ``GRAPH_LAUNCHES`` instead.

Small shapes.  The JAX package's ``_tile_waste`` sends mostly-padding
shapes to its jnp reference instead of the TPU kernel.  The port does not
carry that rule over: a CUDA tensor always launches the kernel.  Its
threshold would be re-derived from H100 launch times, once they exist.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from . import ref as _ref

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "window_join.cu"
_REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launch counts per kernel, bumped only where a kernel is launched.
LAUNCHES: Dict[str, int] = {"window_join_packed": 0,
                            "window_join_rowcount": 0,
                            "window_join": 0,
                            "window_join_count": 0,
                            "select_survivors": 0}

# Launches replayed from captured CUDA graphs (``core/scan.py``): a replay
# calls no wrapper, so each replay adds the launches its capture recorded.
GRAPH_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, GRAPH_LAUNCHES):
        for key in counts:
            counts[key] = 0


@contextlib.contextmanager
def capturing():
    """Around a CUDA-graph capture: yields a dict that receives the
    launches the capture recorded, and leaves ``LAUNCHES`` as it was (a
    capture runs no kernel)."""
    before = dict(LAUNCHES)
    recorded: Dict[str, int] = {}
    try:
        yield recorded
    finally:
        for key in LAUNCHES:
            recorded[key] = LAUNCHES[key] - before[key]
            LAUNCHES[key] = before[key]


def count_replay(recorded: Dict[str, int]) -> None:
    """One replay of a graph whose capture recorded ``recorded``."""
    for key, n in recorded.items():
        GRAPH_LAUNCHES[key] += n


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"window_join_{digest[:16]}.so"


def build() -> Path:
    """Compile the kernels (if this source has not been built yet) and
    return the shared library's path.  Records the compiler's resource
    report and the build seconds in ``BUILD_INFO``."""
    so = library_path()
    if so.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "(cached)")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial
    BUILD_INFO["seconds"] = time.perf_counter() - t
    BUILD_INFO["log"] = proc.stdout + proc.stderr
    return so


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.wj_packed.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.wj_join.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        for fn in (lib.wj_rowcount, lib.wj_count):
            fn.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        lib.wj_select.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        for fn in (lib.wj_packed, lib.wj_join, lib.wj_rowcount, lib.wj_count,
                   lib.wj_select):
            fn.restype = i32
        lib.wj_error_string.argtypes = [i32]
        lib.wj_error_string.restype = ctypes.c_char_p
        lib.wj_max_c.argtypes = []
        lib.wj_max_c.restype = i32
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _as_u8(t):
    """A validity vector as the uint8 bytes the kernel tests for != 0:
    bool and int8 (the JAX package's packed strips) are viewed, not
    copied."""
    return t.view(torch.uint8) if t.dtype in (torch.bool, torch.int8) else t


def _dims(L, R):
    """(K, C, M, B) of a launch, checked before anything is built."""
    if L.dim() != 3 or R.dim() != 3:
        raise ValueError("L and R must be (K, C, M) and (K, C, B)")
    if L.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {L.device} tensor")
    lib = load_library()
    K, C, M = L.shape
    B = R.shape[2]
    if C > lib.wj_max_c():
        raise ValueError(f"C={C} constraint rows exceed the kernel's "
                         f"limit of {lib.wj_max_c()}")
    # grid.z holds K; grid.x the ceil(M/32) 32-row strips of the joins and
    # counts (the selection on a join's output, ceil(M/8) 8-row blocks).
    # M and B reach the launchers as C ints, so both grids fit whenever M
    # does.
    if K >= 65536 or max(M, B) >= 2 ** 31:
        raise ValueError(f"shape (K={K}, M={M}, B={B}) exceeds the grid")
    return lib, (K, C, M, B)


def _launched(rc, lib, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.wj_error_string(rc).decode()})")
    LAUNCHES[name] += 1


def _th_stride(thetas, K, C, device) -> int:
    """Checks ``thetas`` as one ``(C,)`` vector shared by the batch or a
    ``(K, C)`` row per batch element; returns the kernel's batch stride
    (0 or C)."""
    shared = thetas.dim() == 1
    _check("thetas", thetas, torch.float32, (C,) if shared else (K, C),
           device)
    return 0 if shared else C


def _bit_outputs(K, M, B, device):
    """Empty bit words (K, M, ceil(B/32)) and row counts (K, M), int32."""
    return (torch.empty((K, M, -(-B // 32)), dtype=torch.int32,
                        device=device),
            torch.empty((K, M), dtype=torch.int32, device=device))


def window_join_packed_bits_cuda(L, R, ops8, thetas, mvalid, bvalid):
    """The packed join's mask as bit words and row counts:
    ``(K, M, ceil(B/32))`` int32 and ``(K, M)`` int32.

    L: (K, C, M) f32, R: (K, C, B) f32, ops8: (K, C) int8, thetas: (C,)
    or (K, C) f32, mvalid: (K, M), bvalid: (K, B) int8, uint8 or bool
    (nonzero is valid, as in the plain version); all contiguous on one
    CUDA device.
    """
    lib, (K, C, M, B) = _dims(L, R)
    dev = L.device
    mvalid, bvalid = _as_u8(mvalid), _as_u8(bvalid)
    _check("L", L, torch.float32, (K, C, M), dev)
    _check("R", R, torch.float32, (K, C, B), dev)
    _check("ops8", ops8, torch.int8, (K, C), dev)
    th_stride = _th_stride(thetas, K, C, dev)
    _check("mvalid", mvalid, torch.uint8, (K, M), dev)
    _check("bvalid", bvalid, torch.uint8, (K, B), dev)
    bits, counts = _bit_outputs(K, M, B, dev)
    if counts.numel() == 0:
        return bits, counts
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wj_packed(L.data_ptr(), R.data_ptr(), ops8.data_ptr(),
                           thetas.data_ptr(), mvalid.data_ptr(),
                           bvalid.data_ptr(), bits.data_ptr(),
                           counts.data_ptr(), K, C, M, B, th_stride,
                           stream)
    _launched(rc, lib, "window_join_packed")
    return bits, counts


def window_join_packed_cuda(L, R, ops8, thetas, mvalid, bvalid):
    """ok[k, m, b] = mvalid & bvalid & AND_c sel_c — (K, M, B) bool,
    unpacked from ``window_join_packed_bits_cuda``'s words."""
    bits, _ = window_join_packed_bits_cuda(L, R, ops8, thetas, mvalid,
                                           bvalid)
    return _ref.unpack_bits(bits, R.shape[2])


def _unpacked(L, R, ops, thetas):
    """Checks the unpacked operands: L (K, C, M) f32, R (K, C, B) f32,
    ops (K, C) int32, thetas (C,) or (K, C) f32, all contiguous on one
    CUDA device.  Returns the library and the launch's (K, C, M, B,
    th_stride)."""
    lib, (K, C, M, B) = _dims(L, R)
    dev = L.device
    _check("L", L, torch.float32, (K, C, M), dev)
    _check("R", R, torch.float32, (K, C, B), dev)
    _check("ops", ops, torch.int32, (K, C), dev)
    return lib, (K, C, M, B, _th_stride(thetas, K, C, dev))


def _launch(lib, fn, name, L, R, ops, thetas, outs, dims):
    """Launches ``fn`` on the current stream of the outputs' device."""
    dev = outs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(L.data_ptr(), R.data_ptr(), ops.data_ptr(),
                thetas.data_ptr(), *(o.data_ptr() for o in outs), *dims,
                stream)
    _launched(rc, lib, name)


def window_join_rowcount_cuda(L, R, ops, thetas):
    """cnt[k, m] = sum_b AND_c cmp(...) — (K, M) int32."""
    lib, dims = _unpacked(L, R, ops, thetas)
    K, _, M, _, _ = dims
    out = torch.empty((K, M), dtype=torch.int32, device=L.device)
    if out.numel() == 0:
        return out
    _launch(lib, lib.wj_rowcount, "window_join_rowcount", L, R, ops, thetas,
            (out,), dims)
    return out


def window_join_bits_cuda(L, R, ops, thetas):
    """The unpacked join's mask, ok[k, m, b] = AND_c cmp(op[k, c],
    L[k, c, m], R[k, c, b], th[k, c]), as bit words and row counts:
    ``(K, M, ceil(B/32))`` int32 and ``(K, M)`` int32."""
    lib, dims = _unpacked(L, R, ops, thetas)
    K, _, M, B, _ = dims
    bits, counts = _bit_outputs(K, M, B, L.device)
    if counts.numel() == 0:
        return bits, counts
    _launch(lib, lib.wj_join, "window_join", L, R, ops, thetas,
            (bits, counts), dims)
    return bits, counts


def window_join_cuda(L, R, ops, thetas):
    """ok[k, m, b] — (K, M, B) bool, unpacked from
    ``window_join_bits_cuda``'s words."""
    bits, _ = window_join_bits_cuda(L, R, ops, thetas)
    return _ref.unpack_bits(bits, R.shape[2])


def window_join_count_cuda(L, R, ops, thetas):
    """cnt[k] = sum_{m, b} AND_c cmp(...) — (K,) int32, without storing
    the mask."""
    lib, dims = _unpacked(L, R, ops, thetas)
    K, _, M, B, _ = dims
    if M * B >= 2 ** 31:
        raise ValueError(f"M*B = {M * B} pairs overflow the int32 count")
    out = torch.zeros((K,), dtype=torch.int32, device=L.device)
    if K == 0 or M * B == 0:
        return out
    _launch(lib, lib.wj_count, "window_join_count", L, R, ops, thetas,
            (out,), dims)
    return out


def select_survivors_cuda(bits, row_counts, b, out_cap):
    """idx[k, j] = m * b + col of partition k's j-th surviving cell in
    row-major order, for j < out_cap; ``M * b`` after the last survivor —
    (K, out_cap) int64.

    bits: (K, M, ceil(b/32)) int32 bit words, row_counts: (K, M) int32
    (their popcounts), both contiguous on one CUDA device.  The inclusive
    prefix of the row counts is a ``torch.cumsum`` over (K, M), as the
    reference's ``jnp.nonzero`` computes its ranks outside any kernel.
    """
    if bits.dim() != 3 or bits.device.type != "cuda":
        raise ValueError("select_survivors_cuda needs (K, M, W) bit words "
                         f"on a CUDA device, got {tuple(bits.shape)} on "
                         f"{bits.device}")
    K, M, _ = bits.shape
    dev = bits.device
    _check("bits", bits, torch.int32, (K, M, -(-b // 32)), dev)
    _check("row_counts", row_counts, torch.int32, (K, M), dev)
    if K >= 65536 or M * b >= 2 ** 31 or out_cap >= 2 ** 31:
        raise ValueError(f"shape (K={K}, M={M}, B={b}, out_cap={out_cap}) "
                         "exceeds the selection's grid or int32 ranks")
    lib = load_library()
    if K * M * out_cap == 0:
        return torch.full((K, out_cap), M * b, dtype=torch.int64,
                          device=dev)
    ends = torch.cumsum(row_counts, dim=1, dtype=torch.int32)
    idx = torch.empty((K, out_cap), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wj_select(bits.data_ptr(), row_counts.data_ptr(),
                           ends.data_ptr(), idx.data_ptr(), K, M, b, out_cap,
                           stream)
    _launched(rc, lib, "select_survivors")
    return idx
