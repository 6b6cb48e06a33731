"""AdamW optimizer + LR schedules, built from scratch.

The port of ``repro.train.optimizer``, over ``{name: tensor}`` dicts of
parameters and gradients (for a ``Model``: ``dict(model.named_parameters())``):

* fp32 first/second moments regardless of parameter dtype;
* optional fp32 master copy when parameters are bf16 (mixed-precision
  training: updates accumulate in fp32, params round to bf16);
* global-norm gradient clipping;
* linear-warmup + cosine-decay schedule;
* optional error-feedback residuals for the compressed gradient
  all-reduce (``distributed.collectives``): they live next to the
  moments, so checkpoints capture them.

The arithmetic is the reference's, operation for operation in f32 (not
``torch.optim.AdamW``, whose decoupled decay and bias correction round
differently and which has no clipping or master copy).  ``apply_update``
writes parameters and moments in place under ``torch.no_grad()``, so a
model's ``nn.Parameter``s keep their identity.  A gradient that is
``None`` (a parameter the loss does not read: torch gives no gradient
where JAX gives zeros) counts as zeros, in the norm and in the update,
so weight decay still reaches it as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any
    master: Any       # fp32 master params, or () when params are fp32
    ef: Any           # error-feedback residuals, or () when uncompressed


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    use_master: bool = True         # fp32 master when params are low-prec
    error_feedback: bool = False    # allocate EF residuals


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor or int) as an f32
    tensor: linear warmup, then cosine decay to ``lr_min_ratio``."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr_peak * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(cfg: AdamWConfig, params: Dict[str, torch.Tensor]
               ) -> AdamWState:
    dev = next(iter(params.values())).device if params else None

    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    low_prec = any(p.dtype != torch.float32 for p in params.values())
    with torch.no_grad():
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={n: zeros32(p) for n, p in params.items()},
            v={n: zeros32(p) for n, p in params.items()},
            master=({n: p.detach().float().clone()
                     for n, p in params.items()}
                    if (cfg.use_master and low_prec) else ()),
            ef=({n: zeros32(p) for n, p in params.items()}
                if cfg.error_feedback else ()),
        )


def global_norm(tree: Dict[str, Any]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, leaf by leaf in
    the dict's order; a ``None`` leaf counts as zeros."""
    sq = None
    for x in tree.values():
        if x is None:
            continue
        s = torch.sum(torch.square(x.float()))
        sq = s if sq is None else sq + s
    if sq is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sq)


@torch.no_grad()
def apply_update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, Any], state: AdamWState
                 ) -> Tuple[Dict[str, torch.Tensor], AdamWState, dict]:
    """One AdamW step, in place.  Returns (params, state, metrics)."""
    step = state.step + 1
    lr = cosine_lr(cfg, step)

    gnorm = global_norm(grads).to(step.device)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    master = state.master if state.master != () else None

    for name, p in params.items():
        g = grads.get(name)
        g = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             if g is None else g.float() * scale)
        m, v = state.m[name], state.v[name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p32 = (master[name] if master is not None else p).float()
        d = (v / bc2).sqrt_().add_(cfg.eps)
        upd = (m / bc1).div_(d).add_(cfg.weight_decay * p32).mul_(lr)
        new = p32 - upd
        if master is not None:
            master[name].copy_(new)
        p.copy_(new)

    new_state = state._replace(step=step)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}


def state_logical_axes(param_axes, cfg: AdamWConfig, low_prec: bool):
    """Optimizer-state logical axes mirror the parameter axes."""
    return AdamWState(
        step=(),
        m=param_axes,
        v=param_axes,
        master=param_axes if (cfg.use_master and low_prec) else (),
        ef=param_axes if cfg.error_feedback else (),
    )
