"""Distributed-optimization collectives: compressed gradient all-reduce.

The port of ``repro.distributed.collectives``.  ``compressed_psum_tree``
is an int8-on-the-wire data-parallel gradient all-reduce (mean) with
error feedback.  A ring f32 all-reduce moves ~8 bytes per element (4 B
reduce-scatter + 4 B all-gather); this moves ~2:

1. add the carried error-feedback residual to the local gradient (f32);
2. quantize to int8 with a *shared* per-tensor scale (the group's max of
   the local max-abs over 127, one f32 scalar all-reduce, plus 1e-12);
3. **reduce-scatter via int8 ``all_to_all_single``** (1 B/element on the
   wire), summing the received shards locally in int32 -- no overflow,
   since 512 x 127 << 2^31;
4. requantize the summed chunk to int8 with a second shared scale and
   **all-gather int8** (1 B/element);
5. dequantize and divide by the group size; the phase-1 quantization
   error becomes the new residual (error feedback compensates it over
   later steps).

The arithmetic is the reference's step for step: IEEE f32 elementwise
ops, an exact max, ``round`` half to even in both frameworks, an int32
sum, and the residual rounded once (the fused multiply-add XLA emits).
So equal inputs give bit-equal outputs on every device, and a group of
ranks holding the same gradient reproduces the reference's replicated
``P()`` input.  Only int8 tensors are handed to
``all_to_all_single`` and the all-gather.  The group is a
``torch.distributed`` process group (a mesh axis's:
``launch.mesh.HostMesh.get_group``): gloo carries CPU tensors, NCCL
CUDA ones.  A ``ShapeOnlyGroup`` stands in for a group where only the
shapes matter: the dry-run (``launch/dryrun.py``) runs the arithmetic of
one rank on ``meta`` tensors to count it, with no process group.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


class ShapeOnlyGroup:
    """A stand-in for a process group of ``size`` ranks on ``meta``
    tensors: each exchange writes its output with a local copy of the
    right shape (the values are not the exchange's) and adds the
    output's bytes to ``sent[kind]`` (``"all-reduce"``, ``"all-to-all"``,
    ``"all-gather"``): what one rank would receive."""

    def __init__(self, size: int):
        self.size = size
        self.sent: Dict[str, int] = {}

    def log(self, kind: str, out: torch.Tensor) -> None:
        self.sent[kind] = (self.sent.get(kind, 0)
                           + out.numel() * out.element_size())


def _max_over(m: torch.Tensor, group) -> None:
    if isinstance(group, ShapeOnlyGroup):
        group.log("all-reduce", m)
    else:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)


def _all_to_all(out: torch.Tensor, x: torch.Tensor, group) -> None:
    if isinstance(group, ShapeOnlyGroup):
        out.copy_(x)
        group.log("all-to-all", out)
    else:
        dist.all_to_all_single(out, x, group=group)


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    if isinstance(group, ShapeOnlyGroup):
        out.copy_(x.repeat(group.size))
        group.log("all-gather", out)
    else:
        dist.all_gather_into_tensor(out, x, group=group)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once: by a tensor of ``d`` on ``x``'s device (a
    Python number would make CUDA multiply by its rounded reciprocal)."""
    return x / torch.full_like(x, d)


def _shared_scale(x: torch.Tensor, group) -> torch.Tensor:
    """max |x| / 127 over the group (the reference's ``pmax``), + 1e-12."""
    m = _div(x.abs().max(), 127.0).reshape(1)
    _max_over(m, group)
    return m[0] + 1e-12


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _compressed_allreduce(x, ef, group, n_shards: int):
    """``x``, ``ef``: one shape on every rank of ``group``.  Returns (the
    group mean of ``x + ef``, the new residual ``ef``)."""
    shape = x.shape
    size = x.numel()
    x = x.float().reshape(-1) + ef.reshape(-1)

    pad = (-size) % n_shards
    xp = F.pad(x, (0, pad))
    chunk = xp.numel() // n_shards

    # Phase 1: shared-scale int8 quantization.
    scale1 = _shared_scale(xp, group)
    q1 = _quantize(xp, scale1)
    # The residual x - q1 * scale1 rounded once to f32, as the reference
    # computes it (XLA contracts it into a fused multiply-add): q1 * scale1
    # is exact in f64, and so is the difference of two such close values.
    new_ef = (x.double() - q1[:size].double() * scale1.double()).float() \
        .reshape(shape)

    # Phase 2: int8 reduce-scatter (all_to_all + local int32 sum).
    recv = torch.empty_like(q1)
    _all_to_all(recv, q1, group)
    ssum = recv.reshape(n_shards, chunk).to(torch.int32).sum(dim=0)
    part = ssum.float() * scale1                       # summed f32 chunk

    # Phase 3: requantize + int8 all-gather.
    scale2 = _shared_scale(part, group)
    q2 = _quantize(part, scale2)
    gathered = torch.empty(n_shards * chunk, dtype=torch.int8,
                           device=q2.device)
    _all_gather(gathered, q2, group)
    out = gathered.float()[:size] * scale2
    return _div(out, n_shards).reshape(shape), new_ef


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _rebuild(like, values):
    if isinstance(like, dict):
        return {k: _rebuild(v, values) for k, v in like.items()}
    return next(values)


def compressed_psum_tree(grads, ef_tree, mesh, axis: str = "data"
                         ) -> Tuple[Any, Any]:
    """Leaf-wise compressed all-reduce (mean) over mesh axis ``axis``.

    ``grads`` is a (nested) dict of tensors, each rank's own: the state
    right after a per-rank backward under data parallelism.  ``ef_tree``
    is the same structure of residuals, or ``()`` for zeros (the
    reference's convention).  Returns (the means, the new residuals), in
    ``grads``' structure; leaves go through the group one after another,
    in the dict's order, on every rank alike.
    """
    n_shards = mesh.shape[axis]
    group = mesh.get_group(axis)
    items = list(_leaves(grads))
    efs = ([torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for _, g in items] if isinstance(ef_tree, tuple) and ef_tree == ()
           else [e for _, e in _leaves(ef_tree)])
    if len(efs) != len(items):
        raise ValueError(f"{len(items)} gradients but {len(efs)} residuals")
    outs, nefs = [], []
    for (_, g), e in zip(items, efs):
        o, ne = _compressed_allreduce(g, e, group, n_shards)
        outs.append(o)
        nefs.append(ne)
    return _rebuild(grads, iter(outs)), _rebuild(grads, iter(nefs))
