"""The train step factory, and the sharding trees of its state.

The port of ``repro.train.train_step``.  ``make_train_step`` gives
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``:
the loss and its backward (autograd through ``Model.loss``, under the
model's ``remat``), then one AdamW update in place.  With ``microbatches
> 1`` the batch splits along dim 0 and the f32 gradients accumulate as
``acc + g / microbatches`` in order, as the reference's ``lax.scan``
does; the loss and every metric are the mean over microbatches.  With
``compressed_grads`` and a mesh that has a ``data`` axis, the gradients
go through ``distributed.collectives.compressed_psum_tree`` over that
axis (int8 on the wire, error feedback carried in ``opt_state.ef``)
before the update, the reference's condition.

``_opt_axes`` and ``tree_shardings`` resolve the logical axes of the
parameters, optimizer state and batches into DTensor placements under a
``MeshRules`` (``distributed.sharding``).  The reference's
``lower_train_step`` / ``lower_serve_step`` lower for its dry-run, which
is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..distributed.collectives import compressed_psum_tree
from ..distributed.sharding import MeshRules
from ..models.params import _tree_key
from .optimizer import AdamWConfig, AdamWState, apply_update


def tree_shardings(rules: MeshRules, structs, axes):
    """Resolve a tree of tensors (``meta`` ones included) and its
    logical-axes tree -> a tree of DTensor placements (one per mesh axis);
    a leaf whose axes are ``()`` or None is replicated.  Dicts, tuples
    and NamedTuples nest; ``structs`` gives the structure."""
    if hasattr(structs, "shape"):
        if axes == () or axes is None:
            return rules.sharding(structs.shape, (None,) * len(structs.shape))
        return rules.sharding(structs.shape, axes, tag=str(axes))
    if isinstance(structs, dict):
        return {k: tree_shardings(rules, v, axes[k])
                for k, v in structs.items()}
    if isinstance(structs, tuple):
        vals = [tree_shardings(rules, s, a) for s, a in zip(structs, axes)]
        return type(structs)(*vals) if hasattr(structs, "_fields") \
            else tuple(vals)
    raise TypeError(f"not a tensor tree: {type(structs).__name__}")


def _opt_axes(model, opt_cfg: AdamWConfig, zero1: bool = False):
    """The optimizer state's logical axes (``AdamWState`` of name-keyed
    dicts).  ``zero1``: the moments, master and residuals shard their
    d_model dims over "data" (``opt_embed``) even where the parameters
    replicate over it."""
    param_axes = model.axes()
    if zero1:
        param_axes = {n: tuple("opt_embed" if a == "embed" else a
                               for a in ax)
                      for n, ax in param_axes.items()}
    low_prec = model.cfg.param_dtype != "f32"
    return AdamWState(
        step=(),
        m=param_axes,
        v=param_axes,
        master=(param_axes if (opt_cfg.use_master and low_prec) else ()),
        ef=(param_axes if opt_cfg.error_feedback else ()),
    )


def _split(x, n: int):
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [x[i * (b // n):(i + 1) * (b // n)] for i in range(n)]


def _grads(model, batch):
    """loss, metrics (detached) and ``{name: grad or None}`` of one
    backward from zeroed gradients."""
    model.zero_grad(set_to_none=True)
    loss, metrics = model.loss(batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def compressed_grads_by_leaf(params, grads, ef, mesh, axis: str = "data"):
    """``compressed_psum_tree`` over ``axis`` per leaf of the reference's
    tree: the parameters of one stacked layer leaf (``layers.{i}.attn.wq``
    for every i) go through as one ``(L, ...)`` tensor, so they share its
    two scales, as in the reference.  ``grads`` and ``ef`` (or ``()``)
    are keyed by parameter name; a ``None`` gradient is zeros (JAX's
    gradient of a parameter the loss does not read).  Returns (the mean
    gradients, the new residuals), keyed by parameter name."""
    groups: Dict[tuple, list] = {}
    for name in params:
        groups.setdefault(_tree_key(name)[0], []).append(name)

    def stack(values, names):
        ts = [values[n] if values[n] is not None else torch.zeros(
            params[n].shape, dtype=torch.float32, device=params[n].device)
            for n in names]
        return ts[0] if len(ts) == 1 else torch.stack(ts)

    g = {k: stack(grads, ns) for k, ns in groups.items()}
    e = () if ef == () else {k: stack(ef, ns) for k, ns in groups.items()}
    out, new_ef = compressed_psum_tree(g, e, mesh, axis=axis)

    def unstack(tree):
        res = {}
        for k, ns in groups.items():
            for i, n in enumerate(ns):
                res[n] = tree[k] if len(ns) == 1 else tree[k][i]
        return res
    return unstack(out), unstack(new_ef)


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    compressed_grads: bool = False, mesh=None):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``metrics`` holds the loss's (``ce``, ``loss``,
    ``aux_loss``, ``expert_load`` for MoE), ``lr``, ``grad_norm`` and
    ``loss_out``.

    ``compressed_grads`` with a ``mesh`` (``launch.mesh.HostMesh``) that
    has a ``data`` axis averages the gradients over that axis through the
    int8 compressed all-reduce, carrying the residuals in
    ``opt_state.ef`` (``()`` means zeros); without a mesh, or with no
    ``data`` axis, it is a no-op, as in the reference.  Each data rank's
    gradient is the one its own batch gives it: with the same batch on
    every rank this is the reference's replicated input, and the two
    agree.  A parameter the loss does not read enters as zeros (JAX's
    gradient there)."""
    compress = (compressed_grads and mesh is not None
                and "data" in mesh.shape)

    def compute_grads(model, batch):
        if microbatches == 1:
            return _grads(model, batch)
        parts = {k: _split(v, microbatches) for k, v in batch.items()}
        acc, losses, metricses = None, [], []
        for i in range(microbatches):
            loss, metrics, grads = _grads(
                model, {k: v[i] for k, v in parts.items()})
            with torch.no_grad():
                if acc is None:
                    acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for n, p in model.named_parameters()}
                for n, g in grads.items():
                    if g is not None:
                        acc[n] = acc[n] + g.float() / microbatches
            losses.append(loss)
            metricses.append(metrics)
        metrics = {k: torch.stack([m[k] for m in metricses]).mean(dim=0)
                   for k in metricses[0]}
        return torch.stack(losses).mean(), metrics, acc

    def train_step(model, opt_state: AdamWState, batch: Dict[str, Any]):
        loss, metrics, grads = compute_grads(model, batch)
        params = dict(model.named_parameters())
        if compress:
            grads, ef = compressed_grads_by_leaf(params, grads,
                                                 opt_state.ef, mesh)
            opt_state = opt_state._replace(ef=ef)
        _, opt_state, om = apply_update(opt_cfg, params, grads, opt_state)
        return model, opt_state, {**metrics, **om, "loss_out": loss}

    return train_step


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``data.lm_data.make_batch``) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}
