"""Parameter definition machinery — one source of truth per architecture.

The port's copy of ``repro.models.params``.  Each model family provides a
nested dict of ``ParamDef``s (shape, logical axes, initializer).  From that
single structure we derive:

* a module tree of parameters (``ParamTree``): a leaf becomes an
  ``nn.Parameter``, a dict a sub-module, so a parameter's dotted name is
  its path in the reference's pytree;
* random initialisation from an explicit ``torch.Generator``
  (``init_params``), with the reference's scales (its samples differ:
  ``jax.random`` is another generator);
* ``load_params``, which carries a reference parameter pytree (layer
  leaves stacked ``(L, ...)``) into a model, and ``count_params`` /
  ``param_bytes``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones
    scale: Optional[float] = None   # None -> 1/sqrt(fan_in) with fan_in =
                                    # last-but-one dim (matmul convention)

    def stacked(self, n: int) -> "ParamDef":
        return ParamDef((n,) + self.shape, ("layers",) + self.axes,
                        self.init, self.scale)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _leaves(defs):
    if is_def(defs):
        yield defs
        return
    for v in defs.values():
        yield from _leaves(v)


def param_bytes(defs, dtype) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    return sum(math.prod(d.shape) * itemsize for d in _leaves(defs))


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for d in _leaves(defs))


def init_scale(d: ParamDef) -> float:
    """The reference's normal-init scale (``params._init_leaf``)."""
    if d.scale is not None:
        return d.scale
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


class ParamTree(nn.Module):
    """The parameters of one nested ``ParamDef`` dict, made at zero.
    ``p["wq"]`` reads a parameter or a sub-tree, as the reference's layer
    functions index their parameter dicts."""

    def __init__(self, defs: dict, dtype, device):
        super().__init__()
        self.defs = defs
        for name, d in defs.items():
            if is_def(d):
                self.register_parameter(name, nn.Parameter(
                    torch.zeros(d.shape, dtype=dtype, device=device)))
            else:
                self.add_module(name, ParamTree(d, dtype, device))

    def __getitem__(self, name):
        return getattr(self, name)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every ``ParamTree`` leaf under ``module`` in registration order:
    zeros, ones, or a standard normal (drawn in f32 on the generator's
    device) times the reference's scale.  A parameter on another device
    than the generator is filled through a copy."""
    for tree in module.modules():
        if not isinstance(tree, ParamTree):
            continue
        for name, d in tree.defs.items():
            if not is_def(d):
                continue
            p = getattr(tree, name)
            if d.init == "zeros":
                p.zero_()
            elif d.init == "ones":
                p.fill_(1.0)
            elif d.init == "normal":
                x = torch.randn(d.shape, generator=generator,
                                dtype=torch.float32, device=generator.device)
                p.copy_(x.mul_(init_scale(d)))
            else:
                raise ValueError(d.init)


@torch.no_grad()
def load_params(model: nn.Module, tree) -> None:
    """Carry a reference parameter pytree into ``model`` in place.

    ``tree`` is nested dicts whose leaves ``np.asarray`` reads (JAX arrays
    included); the leaves under ``"layers"`` are stacked ``(L, ...)``.  A
    parameter named ``layers.{i}.attn.wq`` takes
    ``tree["layers"]["attn"]["wq"][i]``; every other name is its path.
    Every leaf of ``tree`` must be consumed and every parameter filled.
    """
    stacked = {}
    used = set()
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            key = (parts[0],) + tuple(parts[2:])
            if key not in stacked:
                node = tree
                for k in key:
                    node = node[k]
                stacked[key] = np.asarray(node)
            src = stacked[key][int(parts[1])]
            used.add(key)
        else:
            node = tree
            for k in parts:
                node = node[k]
            src = np.asarray(node)
            used.add(tuple(parts))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree leaf {src.shape} != parameter "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(src)).to(p.dtype))
    want = set(_tree_paths(tree))
    if used != want:
        raise ValueError(f"tree leaves without a parameter: "
                         f"{sorted(want - used)}; parameters without a "
                         f"leaf: {sorted(used - want)}")


def _tree_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, prefix + (k,))
    else:
        yield prefix
