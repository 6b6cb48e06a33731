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
* logical-axis trees (``logical_axes``) for ``distributed.sharding``'s
  rules, and abstract trees of ``meta`` tensors (``abstract_params``:
  shapes and dtypes, nothing allocated), both in the defs' nested layout;
* ``load_params``, which carries a reference parameter pytree (layer
  leaves stacked ``(L, ...)``) into a model, its inverse
  ``params_to_tree``, ``opt_state_from_tree`` (a reference ``AdamWState``
  into the port's), and ``count_params`` / ``param_bytes``.
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


def _map_defs(fn, defs):
    if is_def(defs):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def logical_axes(defs):
    return _map_defs(lambda d: d.axes, defs)


def abstract_params(defs, dtype):
    return _map_defs(lambda d: torch.empty(d.shape, dtype=dtype,
                                           device="meta"), defs)


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


def _tree_key(name: str):
    """A parameter name -> (its path in the reference's tree, its layer
    index or None): ``layers.3.attn.wq`` -> (("layers", "attn", "wq"),
    3)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def _named_leaves(model: nn.Module, tree):
    """``{parameter name: numpy array}`` read from a reference tree (leaves
    under ``"layers"`` stacked ``(L, ...)``), shapes checked against the
    parameters; every leaf of ``tree`` must map to a parameter and every
    parameter to a leaf."""
    stacked, out = {}, {}
    for name, p in model.named_parameters():
        key, layer = _tree_key(name)
        if key not in stacked:
            node = tree
            for k in key:
                node = node[k]
            stacked[key] = np.asarray(node)
        src = stacked[key] if layer is None else stacked[key][layer]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree leaf {src.shape} != parameter "
                             f"{tuple(p.shape)}")
        out[name] = src
    want = set(_tree_paths(tree))
    if set(stacked) != want:
        raise ValueError(f"tree leaves without a parameter: "
                         f"{sorted(want - set(stacked))}; parameters without "
                         f"a leaf: {sorted(set(stacked) - want)}")
    return out


@torch.no_grad()
def load_params(model: nn.Module, tree) -> None:
    """Carry a reference parameter pytree into ``model`` in place.

    ``tree`` is nested dicts whose leaves ``np.asarray`` reads (JAX arrays
    included); the leaves under ``"layers"`` are stacked ``(L, ...)``.  A
    parameter named ``layers.{i}.attn.wq`` takes
    ``tree["layers"]["attn"]["wq"][i]``; every other name is its path.
    Every leaf of ``tree`` must be consumed and every parameter filled.
    """
    leaves = _named_leaves(model, tree)
    for name, p in model.named_parameters():
        p.copy_(torch.from_numpy(np.array(leaves[name])).to(p.dtype))


def params_to_tree(model: nn.Module, values=None) -> dict:
    """The inverse of ``load_params``: the reference's nested tree of numpy
    arrays, layer leaves stacked ``(L, ...)``.  ``values`` (``{parameter
    name: tensor}``, e.g. an optimizer moment) replaces the parameters'
    own values."""
    groups = {}
    for name, p in model.named_parameters():
        key, layer = _tree_key(name)
        x = (p if values is None else values[name]).detach().cpu()
        groups.setdefault(key, []).append((layer, x))
    tree = {}
    for key, items in groups.items():
        if items[0][0] is None:
            arr = items[0][1].numpy()
        else:
            arr = torch.stack([x for _, x in sorted(items, key=lambda i: i[0])
                               ]).numpy()
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = arr
    return tree


def opt_state_from_tree(model: nn.Module, state):
    """A reference ``AdamWState`` (JAX arrays or numpy; ``m``, ``v``,
    ``master`` and the error-feedback residuals ``ef`` in the parameters'
    tree layout, or ``()``) -> the port's, keyed by ``model``'s parameter
    names, on the model's device."""
    from ..train.optimizer import AdamWState

    dev = next(model.parameters()).device

    def conv(tree):
        if isinstance(tree, tuple) and tree == ():
            return ()
        return {n: torch.from_numpy(np.array(a, np.float32)).to(dev)
                for n, a in _named_leaves(model, tree).items()}

    return AdamWState(
        step=torch.as_tensor(np.array(state.step), dtype=torch.int32,
                             device=dev),
        m=conv(state.m), v=conv(state.v), master=conv(state.master),
        ef=conv(state.ef))


def _tree_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, prefix + (k,))
    else:
        yield prefix
