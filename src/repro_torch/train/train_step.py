"""The train step factory.

The port of ``repro.train.train_step.make_train_step``: ``train_step(model,
opt_state, batch) -> (model, opt_state, metrics)`` runs the loss and its
backward (autograd through ``Model.loss``, under the model's ``remat``),
then one AdamW update in place.  With ``microbatches > 1`` the batch
splits along dim 0 and the f32 gradients accumulate as ``acc +
g / microbatches`` in order, as the reference's ``lax.scan`` does; the
loss and every metric are the mean over microbatches.

The sharding half of the reference (``tree_shardings``, ``_opt_axes``,
``lower_train_step``, ``lower_serve_step``) and the compressed gradient
all-reduce over a mesh belong to distribution (ROADMAP Queue 1 item
6(c)) and are not ported.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .optimizer import AdamWConfig, AdamWState, apply_update


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


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    compressed_grads: bool = False, mesh=None):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``metrics`` holds the loss's (``ce``, ``loss``,
    ``aux_loss``, ``expert_load`` for MoE), ``lr``, ``grad_norm`` and
    ``loss_out``.  ``compressed_grads`` without a mesh is the reference's
    no-op; with one it raises (not ported)."""
    if compressed_grads and mesh is not None:
        raise NotImplementedError(
            "compressed gradient all-reduce over a mesh "
            "(distributed/collectives.py) is ROADMAP Queue 1 item 6(c), "
            "not ported")

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
        _, opt_state, om = apply_update(opt_cfg, params, grads, opt_state)
        return model, opt_state, {**metrics, **om, "loss_out": loss}

    return train_step


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``data.lm_data.make_batch``) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}
