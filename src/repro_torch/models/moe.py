"""Fine-grained mixture-of-experts FFN (DeepSeekMoE / DBRX style).

The port of ``repro.models.moe``'s dense path.  Shared experts (always
active) + top-k routed experts with sort-based capacity dispatch:

1. router logits -> fp32 softmax -> top-k (weight renormalized);
2. flatten the (token, slot) assignments, sort them stably by expert id,
   rank within each expert group and drop overflow beyond capacity ``C``;
3. gather tokens into an ``(E, C, D)`` buffer (dropped assignments land
   in one extra row that is sliced off, the reference's ``mode="drop"``);
4. batched per-expert SwiGLU via ``(E, C, D) x (E, D, F)`` products;
5. weighted scatter-add back to token order.

The sort must be stable: the rank within an expert decides which
assignments the capacity drops, and the reference's ``jnp.argsort`` is
stable.  The layer returns the per-expert token load and the
Switch-style load-balance auxiliary loss, in the reference's arithmetic.
The reference's expert-parallel path (``shard_map`` over a ``model`` mesh
axis) needs several devices and is not ported yet: ``moe_ffn`` always
runs the dense path.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import ffn_defs, swiglu
from .params import ParamDef


def moe_defs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    out = {
        "router": ParamDef((d, e), ("embed", "experts"), scale=0.02),
        "w_gate": ParamDef((e, d, f), ("experts", "embed", "ff")),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "ff")),
        "w_down": ParamDef((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.n_shared_experts > 0:
        # Shared experts fused into one wide SwiGLU.
        out["shared"] = ffn_defs(cfg, d_ff=cfg.n_shared_experts * f)
    return out


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8 for lane alignment


def dispatch(xt, top_w, top_e, E: int, K: int, C: int):
    """Sort-based dispatch of the tokens ``xt`` (T, D) into ``(E, C, D)``
    buffers (the reference's ``_local_dispatch``).  Returns the buffers
    and ``(se, st, sw, keep, dest)``: per assignment in stable expert
    order, its expert, token, weight, whether it is within capacity, and
    its buffer row (``E * C`` for a dropped one)."""
    T, D = xt.shape
    dev = xt.device
    flat_e = top_e.reshape(-1)                                    # (T*K,)
    flat_w = top_w.reshape(-1).to(xt.dtype)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))  # (E,)
    rank = torch.arange(T * K, device=dev) - starts[se]
    keep = rank < C
    dest = torch.where(keep, se * C + rank, E * C)                # drop slot
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=dev)
    buf[dest] = xt[st]
    return buf[:E * C].reshape(E, C, D), (se, st, sw, keep, dest)


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig,
            expert_perm: torch.Tensor | None = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss, expert_load (E,)).

    ``expert_perm`` (optional, (E,) int) applies a logical->physical expert
    relabeling before dispatch — the adaptive placement governor's output.
    Routing decisions are unaffected (weights follow the permutation); only
    *where* each expert's tokens land changes.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity(cfg, T)
    xt = x.reshape(T, D)
    dev = x.device

    logits = xt @ p["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)                 # (T, E)
    top_w, top_e = torch.topk(probs, K, dim=-1)                   # (T, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    if expert_perm is not None:
        top_e = expert_perm.to(dev, torch.long)[top_e]

    # Load-balance auxiliary loss (Switch): E * sum_e f_e * P_e.
    mean_probs = probs.mean(dim=0)                                # (E,)
    frac = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, top_e.reshape(-1),
        torch.full((T * K,), 1.0 / (T * K), dtype=torch.float32, device=dev))
    aux = E * torch.sum(frac * mean_probs)
    expert_load = frac * T * K                                    # tokens/e

    buf, (_, st, sw, keep, dest) = dispatch(xt, top_w, top_e, E, K, C)

    # ---- per-expert SwiGLU ---------------------------------------------
    g = torch.bmm(buf, p["w_gate"].to(x.dtype))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    out_buf = torch.bmm(F.silu(g) * u, p["w_down"].to(x.dtype))

    # ---- weighted combine ----------------------------------------------
    flat_out = out_buf.reshape(E * C, D)
    vals = flat_out[torch.clamp(dest, max=E * C - 1)]
    vals = torch.where(keep[:, None], vals, 0.0) * sw[:, None]
    out = torch.zeros((T, D), dtype=x.dtype, device=dev).index_add_(
        0, st, vals)

    if cfg.n_shared_experts > 0:
        out = out + swiglu(x, p["shared"]).reshape(T, D)

    return out.reshape(B, S, D), aux.float(), expert_load
