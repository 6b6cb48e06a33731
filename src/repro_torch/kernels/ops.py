"""Entry points for the CEP join kernels, with backend dispatch.

* A CUDA tensor launches the hand-written CUDA kernel
  (``window_join.py``); a CPU tensor runs the plain PyTorch version
  (``ref.py``).  A CUDA tensor never reaches the plain version unless the
  caller asks for it.
* ``backend="ref"`` runs the plain version on either device (the
  comparison run of ``chip_smoke.py``).
* ``backend="cuda"`` on a CPU tensor raises.
* Without a per-call ``backend``, ``get_backend`` decides: the name
  ``set_backend`` forced, else ``default_backend``: the
  ``REPRO_KERNEL_BACKEND`` environment override ("ref" | "cuda",
  validated as in the reference), else "cuda" for a CUDA tensor and
  "ref" for a CPU one.  An override of "cuda" on a CPU tensor raises as
  the explicit one does: nothing gives way silently.

The engines call these through one ``backend`` field of their config, so
the whole data plane switches with one flag.  A join step runs
``window_join_packed_bits`` (order plans) or ``window_join_bits`` (tree
plans), which give the mask as bit words plus row counts, then
``select_survivors``; ``window_join_packed`` and ``window_join`` give the
same mask as bool (on the card unpacked from the words), for tests.  The
CUDA kernels take a leading fleet axis K (``(K, C, M)``); the plain
versions take it or not.  Every join and count takes its thresholds as
``(C,)`` (shared by the batch) or ``(K, C)`` (one row per batch element,
the rulebook's rules).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from . import ref as _ref
from . import window_join as _wj

LAUNCHES = _wj.LAUNCHES
GRAPH_LAUNCHES = _wj.GRAPH_LAUNCHES
reset_launch_counts = _wj.reset_launch_counts


BACKENDS = ("ref", "cuda")
_BACKEND = None


def default_backend(x=None) -> str:
    """The environment's backend if ``REPRO_KERNEL_BACKEND`` is set, else
    the device's: "cuda" for a CUDA tensor or device ``x`` ("cuda"
    whenever torch sees a GPU if ``x`` is None), "ref" otherwise."""
    env = os.environ.get("REPRO_KERNEL_BACKEND")
    if env:
        if env not in BACKENDS:
            raise ValueError(f"REPRO_KERNEL_BACKEND={env!r} is not one of "
                             "'ref' | 'cuda'")
        return env
    if x is None:
        return "cuda" if torch.cuda.is_available() else "ref"
    dev = x.device if torch.is_tensor(x) else torch.device(x)
    return "cuda" if dev.type == "cuda" else "ref"


def set_backend(name: Optional[str]) -> None:
    """Force a kernel backend for every call without its own: 'ref' |
    'cuda', or None to go back to ``default_backend``."""
    global _BACKEND
    if name not in BACKENDS + (None,):
        raise ValueError(f"unknown kernel backend {name!r}")
    _BACKEND = name


def get_backend(x=None) -> str:
    return _BACKEND or default_backend(x)


def resolve_backend(backend: Optional[str], x) -> str:
    """The backend a call on tensor ``x`` runs: explicit, else
    ``get_backend(x)``."""
    be = backend or get_backend(x)
    if be not in BACKENDS:
        raise ValueError(f"unknown kernel backend {be!r} "
                         "(expected 'ref' or 'cuda')")
    if be == "cuda" and not x.is_cuda:
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {x.device}")
    return be


def window_join_packed(L, R, ops8, thetas, mvalid, bvalid, *,
                       backend: Optional[str] = None):
    """Packed-strip join: ok = mvalid & bvalid & AND_c row_c — (..., M, B)
    bool."""
    if resolve_backend(backend, L) == "ref":
        return _ref.window_join_packed_ref(L, R, ops8, thetas, mvalid,
                                           bvalid)
    return _wj.window_join_packed_cuda(L, R, ops8, thetas, mvalid, bvalid)


def window_join_packed_bits(L, R, ops8, thetas, mvalid, bvalid, *,
                            backend: Optional[str] = None):
    """Packed-strip join as (bit words (..., M, ceil(B/32)) int32, row
    counts (..., M) int32)."""
    if resolve_backend(backend, L) == "ref":
        return _ref.window_join_packed_bits_ref(L, R, ops8, thetas, mvalid,
                                                bvalid)
    return _wj.window_join_packed_bits_cuda(L, R, ops8, thetas, mvalid,
                                            bvalid)


def window_join_rowcount(L, R, ops, thetas, *,
                         backend: Optional[str] = None):
    """Per-m row counts — (..., M) int32 — without materializing (M, B)."""
    if resolve_backend(backend, L) == "ref":
        return _ref.window_join_rowcount_ref(L, R, ops, thetas)
    return _wj.window_join_rowcount_cuda(L, R, ops, thetas)


def window_join(L, R, ops, thetas, *, backend: Optional[str] = None):
    """ok[m, b] = AND_c cmp(op[c], L[c, m], R[c, b], theta[c]) — (..., M, B)
    bool; the tree engine's join."""
    if resolve_backend(backend, L) == "ref":
        return _ref.window_join_ref(L, R, ops, thetas)
    return _wj.window_join_cuda(L, R, ops, thetas)


def window_join_bits(L, R, ops, thetas, *, backend: Optional[str] = None):
    """The tree engine's join as (bit words (..., M, ceil(B/32)) int32, row
    counts (..., M) int32)."""
    if resolve_backend(backend, L) == "ref":
        return _ref.window_join_bits_ref(L, R, ops, thetas)
    return _wj.window_join_bits_cuda(L, R, ops, thetas)


def select_survivors(bits, row_counts, b: int, out_cap: int, *,
                     backend: Optional[str] = None):
    """Row-major flat indices ``m * b + col`` of the first ``out_cap``
    survivors of a bit-word mask, ``M * b`` after the last one —
    (..., out_cap) int64 (the reference's fixed-size ``jnp.nonzero``)."""
    if resolve_backend(backend, bits) == "ref":
        return _ref.select_survivors_ref(bits, row_counts, b, out_cap)
    return _wj.select_survivors_cuda(bits, row_counts, b, out_cap)


def window_join_count(L, R, ops, thetas, *, backend: Optional[str] = None):
    """Count of matching pairs without materializing the mask — a 0-d
    int32 without a fleet axis (the plain version only), (K,) with one."""
    if resolve_backend(backend, L) == "ref":
        return _ref.window_join_count_ref(L, R, ops, thetas)
    return _wj.window_join_count_cuda(L, R, ops, thetas)
