"""Entry points for the CEP join kernels, with backend dispatch.

* A CUDA tensor launches the hand-written CUDA kernel
  (``window_join.py``); a CPU tensor runs the plain PyTorch version
  (``ref.py``).  A CUDA tensor never reaches the plain version unless the
  caller asks for it.
* ``backend="ref"`` runs the plain version on either device (the
  comparison run of ``chip_smoke.py``).
* ``backend="cuda"`` on a CPU tensor raises.

The engines call these through one ``backend`` field of their config, so
the whole data plane switches with one flag.  The CUDA kernels take a
leading fleet axis K (``(K, C, M)``); the plain versions take it or not.
The JAX package's ``REPRO_KERNEL_BACKEND`` environment override keeps its
JAX meaning and is not read here.
"""

from __future__ import annotations

from typing import Optional

from . import ref as _ref
from . import window_join as _wj

LAUNCHES = _wj.LAUNCHES
reset_launch_counts = _wj.reset_launch_counts


def resolve_backend(backend: Optional[str], x) -> str:
    """The backend a call on tensor ``x`` runs: explicit, else by device."""
    be = backend or ("cuda" if x.is_cuda else "ref")
    if be not in ("ref", "cuda"):
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


def window_join_count(L, R, ops, thetas, *, backend: Optional[str] = None):
    """Count of matching pairs without materializing the mask — a 0-d
    int32 without a fleet axis (the plain version only), (K,) with one."""
    if resolve_backend(backend, L) == "ref":
        return _ref.window_join_count_ref(L, R, ops, thetas)
    return _wj.window_join_count_cuda(L, R, ops, thetas)
