"""Helpers of the CPU twins that hold the port's host code to the JAX
package's: a plain form of the host structures for exact comparison, and
the example draws of ``tests/_prop.py``'s seeded sweep.

``plain(x)`` turns a dataclass, named tuple, enum, numpy array or scalar,
and the lists, tuples and dicts of them, into nested tuples of Python
values, with every float as ``float.hex`` (so equal means equal to the
bit) and every class named by its class name only.  Two packages' copies of
one structure (a ``Pattern``, an ``OrderPlan``, a DCS list, a ``Stat``)
are then equal exactly when ``plain`` of each is.

``prop_draws(module, qualname, max_examples, **strategies)`` gives the
examples that ``_prop.given`` draws for the test ``module.qualname`` where
hypothesis is not installed: the same per-test seed, the same cap of 20
examples, the strategies sampled in the order given.  Where hypothesis is
installed the reference tests draw fresh random examples each run, so a
twin takes these fixed ones.  A strategy is
``("int", lo, hi)`` or ``("float", lo, hi)``, inclusive as in ``st``.
"""

from __future__ import annotations

import dataclasses
import enum
import zlib

import numpy as np

FALLBACK_MAX_EXAMPLES = 20


def plain(x):
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, plain(x.value))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, plain(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple(
            (f, plain(getattr(x, f))) for f in x._fields)
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape,
                tuple(plain(v) for v in x.ravel().tolist()))
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, bool) or x is None or isinstance(x, (int, str)):
        return x
    if isinstance(x, float):
        return float.hex(x)
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((plain(k), plain(v)) for k, v in x.items()))
    raise TypeError(f"no plain form for {type(x).__name__}")


def prop_draws(module, qualname, max_examples, **strategies):
    seed0 = zlib.crc32(f"{module}.{qualname}".encode())
    out = []
    for i in range(min(max_examples, FALLBACK_MAX_EXAMPLES)):
        rng = np.random.default_rng(seed0 + i)
        drawn = {}
        for name, (kind, lo, hi) in strategies.items():
            drawn[name] = (int(rng.integers(lo, hi + 1)) if kind == "int"
                           else float(rng.uniform(lo, hi)))
        out.append(drawn)
    return out
