"""Carry state across from the JAX package to the port.

The JAX package's engine state is a set of NamedTuples of arrays:
``Buffers`` (ring buffers), ``MonitorState`` (statistics rings) and
``LoweredInvariants`` (the lowered invariant matrix).  The port's state has
the same fields.  These functions take any object with those fields —
JAX arrays, numpy arrays, anything ``np.asarray`` reads — and return the
port's tensors on ``device``, so a stream run partly by the reference can
be continued by the port (as weights are loaded into a model).  Plans need
no conversion: both sides hold order rows as numpy.

Shapes follow the fleet layout of both packages: every field leads with
the partition axis K.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import Buffers
from .invariants import LoweredInvariants
from .stats import MonitorState


def _convert(cls, obj, device):
    # np.array makes a writable host copy (JAX arrays read as read-only).
    return cls(*(torch.as_tensor(np.array(getattr(obj, f)), device=device)
                 for f in cls._fields))


def buffers_to_torch(buffers, device="cuda") -> Buffers:
    """A fleet's ring buffers (ts, attr, valid, ptr) -> ``Buffers``."""
    return _convert(Buffers, buffers, device)


def monitor_to_torch(monitor, device="cuda") -> MonitorState:
    """A fleet's statistics rings -> the device ``MonitorState``."""
    return _convert(MonitorState, monitor, device)


def lowered_to_torch(lowered, device="cuda") -> LoweredInvariants:
    """A stacked lowered invariant set -> device tensors, as
    ``StackedLowered.device()`` holds them."""
    return _convert(LoweredInvariants, lowered, device)
