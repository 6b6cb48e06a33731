"""Operation counts of an eager torch step, taken on ``meta`` tensors.

The port's stand-in for the XLA analyses the reference's dry-run reads
(``compiled.cost_analysis()`` and ``memory_analysis()``).  Eager torch
has no lowering to analyse, so each helper runs a function and counts
what the aten dispatcher sees.  On ``meta`` tensors nothing is allocated
or computed: the counts follow from shapes and dtypes alone, so a
full-size step of any configuration is counted on a CPU host in seconds.

* ``flop_count``: ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, convolutions and attention; elementwise work counts 0, which
  XLA's ``flops`` would count).
* ``bytes_accessed``: the input and output bytes of every aten op that is
  not a view.  These are the port's eager ops, unfused, which is what the
  port reads and writes: XLA's ``bytes accessed`` counts its fused
  kernels, so it is smaller where XLA fuses elementwise chains.
* ``peak_live_bytes``: the largest sum of the storages made inside the
  call that are alive at once.  A storage counts from the op that makes
  it until it is freed (a weakref finalizer); views and in-place results
  share their storage and add nothing.  Storages that existed before the
  call (the arguments, first seen as an op's input) are not counted.

Each returns plain numbers; no process group and no device are needed.
Python loops (the layer stack, flash attention's KV blocks, the SSD
chunk scan) run every iteration, so every block is counted: the
reference's loop-body probe corrections are 0 here.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

_aten = torch.ops.aten
# Ops that move no bytes though their schema does not mark them views.
_NO_TRAFFIC = {
    _aten._unsafe_view.default, _aten.empty.memory_format,
    _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
}


def _moves_bytes(func) -> bool:
    return not (func.is_view or func in _NO_TRAFFIC)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class BytesAccessed(TorchDispatchMode):
    """Sums the input and output bytes of every non-view aten op."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _moves_bytes(func):
            self.total += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                           + _tensor_bytes(out))
        return out


class PeakLive(TorchDispatchMode):
    """Tracks the bytes of the storages made inside the mode that are
    alive, and their peak.  A storage first seen among an op's inputs
    existed before the mode (an argument): it counts 0, and so do the
    views and in-place results that share it."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key)

    def _track(self, tree, count: bool) -> None:
        for t in tree_leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            self._seen[key] = st.nbytes() if count else 0
            self.live += self._seen[key]
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._track((args, kwargs), count=False)
        out = func(*args, **(kwargs or {}))
        self._track(out, count=True)
        self.peak = max(self.peak, self.live)
        return out


def flop_count(fn: Callable[[], Any]) -> int:
    """FLOPs of ``fn()`` as ``FlopCounterMode`` counts them."""
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def bytes_accessed(fn: Callable[[], Any]) -> int:
    """Input plus output bytes of every non-view aten op of ``fn()``."""
    with BytesAccessed() as mode:
        fn()
    return mode.total


def flops_and_bytes(fn: Callable[[], Any]) -> Tuple[int, int]:
    """``flop_count`` and ``bytes_accessed`` of one run of ``fn()``."""
    with FlopCounterMode(display=False) as fc, BytesAccessed() as mode:
        fn()
    return int(fc.get_total_flops()), mode.total


def peak_live_bytes(fn: Callable[[], Any]) -> int:
    """The peak of the live bytes of the storages ``fn()`` makes."""
    mode = PeakLive()
    with mode:
        out = fn()
    del out
    return mode.peak
