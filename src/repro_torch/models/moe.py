"""Fine-grained mixture-of-experts FFN (DeepSeekMoE / DBRX style).

The port of ``repro.models.moe``'s dense path.  Shared experts (always
active) + top-k routed experts with sort-based capacity dispatch:

1. router logits -> fp32 softmax -> top-k (weight renormalized);
2. flatten the (token, slot) assignments, sort them stably by expert id,
   rank within each expert group and drop overflow beyond capacity ``C``;
3. gather tokens into an ``(E, C, D)`` buffer (dropped assignments land
   in one extra row that is sliced off, the reference's ``mode="drop"``);
4. batched per-expert SwiGLU via ``(E, C, D) x (E, D, F)`` products;
5. weighted combine back to token order.

The sort must be stable: the rank within an expert decides which
assignments the capacity drops, and the reference's ``jnp.argsort`` is
stable.  The layer returns the per-expert token load and the
Switch-style load-balance auxiliary loss, in the reference's arithmetic.

Repeatable on every device: nothing on the path adds atomically.  The
combine sums each token's K expert outputs left to right from zeros in
ascending expert order, the order in which the reference's ``.at[st]
.add`` applies them; the dispatch gathers each token's K copies through a
permutation (no index twice), so its backward sums a token's K rows in a
reduction of fixed order; the load counts are integers and ``frac`` is
the reference's chain of f32 additions, read from a table.

Two execution paths, as in the reference:

* **dense** (no rules, or no expert-parallel ``model`` axis): the steps
  above on one device.
* **expert parallel** (``_moe_ffn_ep``): under ``use_rules(mesh)`` with
  ``model > 1``, ``E % model == 0`` and the batch dividing over the data
  axes, each rank dispatches its data shard's tokens into per-expert
  buffers and one ``all_to_all_single`` over its ``model`` group routes
  them to their expert's owner (the GShard pattern); a second brings the
  outputs back.  ``moe_ffn`` takes the global batch (the same ``x`` on
  every rank, the reference's call outside ``shard_map``) and returns
  it whole, gathered over the data axes: a replicated function, whose
  outputs and gradients are the same on every rank (the backward sums
  the ranks' shares of the routed path's gradients over the mesh, as the
  reference's ``shard_map`` transpose sums over the axes an input is
  replicated on).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..distributed.sharding import current_rules
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


@functools.lru_cache(maxsize=16)
def _chain_table(n: int, device) -> torch.Tensor:
    """``table[i]``: ``i`` sequential f32 additions of ``1 / n`` to zero,
    for i in 0..n (the reference's ``.at[e].add(1 / n)``, one update at a
    time); uploaded once per (n, device)."""
    steps = np.full(n, 1.0 / n, dtype=np.float32)
    table = np.concatenate([[np.float32(0)], np.add.accumulate(steps)])
    return torch.from_numpy(table.astype(np.float32)).to(device)


def routing_stats(probs, top_e, E: int, K: int):
    """(aux, frac): the Switch load-balance loss ``E * sum_e f_e * P_e``
    and the fraction of the T*K assignments per expert, ``frac[e]`` the
    reference's chain sum of ``1 / (T*K)`` over its assignments."""
    T = probs.shape[0]
    # A fixed-length integer count (``bincount``'s length depends on the
    # data, so it has no ``meta`` kernel); integer sums are exact in any
    # order, CUDA's atomics included.
    flat = top_e.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    frac = _chain_table(T * K, probs.device)[counts]
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return aux, frac


def route(xt, router, K: int, expert_perm=None):
    """Router logits -> f32 softmax -> renormalized top-k: (probs (T, E),
    top_w (T, K), top_e (T, K) physical expert ids)."""
    logits = xt @ router.to(xt.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    if expert_perm is not None:
        top_e = expert_perm.to(xt.device, torch.long)[top_e]
    return probs, top_w, top_e


def _local_dispatch(xt, top_w, top_e, E: int, K: int, C: int):
    """Sort-based dispatch of the tokens ``xt`` (T, D) into ``(E, C, D)``
    buffers.  Returns the buffers and ``(se, st, sw, keep, dest)``: per
    assignment in stable expert order, its expert, token, weight, whether
    it is within capacity, and its buffer row (``E * C`` for a dropped
    one)."""
    T, D = xt.shape
    dev = xt.device
    flat_e = top_e.reshape(-1)                                    # (T*K,)
    flat_w = top_w.reshape(-1).to(xt.dtype)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], order // K, flat_w[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))  # (E,)
    rank = torch.arange(T * K, device=dev) - starts[se]
    keep = rank < C
    dest = torch.where(keep, se * C + rank, E * C)                # drop slot
    # Each token's K copies through a permutation: no index twice, so the
    # backward writes every row once and expand's sum adds a token's K
    # rows in a fixed order (indexing xt by token would add them
    # atomically on CUDA).
    copies = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=dev)
    buf[dest] = copies[order]
    return buf[:E * C].reshape(E, C, D), (se, st, sw, keep, dest)


dispatch = _local_dispatch


def combine(flat_out, st, sw, dest, T: int, K: int):
    """The weighted combine: token ``t``'s output is its K within-capacity
    expert rows of ``flat_out`` (E*C, D), each times its weight, added
    left to right from zeros in ascending expert order -- the order in
    which the reference's ``.at[st].add`` applies them (its updates run
    in sorted order).  No index repeats but the dropped assignments' zero
    row, so the backward adds nothing atomically."""
    D = flat_out.shape[1]
    dev = flat_out.device
    # Each token's K sorted positions, ascending: a stable sort by token.
    pos = torch.argsort(st, stable=True).reshape(T, K)
    padded = torch.cat([flat_out, flat_out.new_zeros((1, D))])
    vals = padded[dest[pos]] * sw[pos][..., None]     # (T, K, D)
    out = torch.zeros((T, D), dtype=flat_out.dtype, device=dev)
    for k in range(K):
        out = out + vals[:, k]
    return out


def _experts(buf, wg, wu, wd, dtype):
    """Per-expert SwiGLU over ``(E, C, D)`` buffers."""
    g = torch.bmm(buf, wg.to(dtype))
    u = torch.bmm(buf, wu.to(dtype))
    return torch.bmm(F.silu(g) * u, wd.to(dtype))


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig,
            expert_perm: torch.Tensor | None = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss, expert_load (E,)).

    ``expert_perm`` (optional, (E,) int) applies a logical->physical expert
    relabeling before dispatch — the adaptive placement governor's output.
    Routing decisions are unaffected (weights follow the permutation); only
    *where* each expert's tokens land changes.  Under ``use_rules(mesh)``
    the expert-parallel path runs where the reference's would.
    """
    rules = current_rules()
    if (rules is not None and rules.mesh is not None
            and rules.mesh.shape.get("model", 1) > 1
            and cfg.n_experts % rules.mesh.shape["model"] == 0):
        mesh = rules.mesh
        batch_axes = _batch_axes(mesh)
        n_dp = math.prod(mesh.shape[a] for a in batch_axes)
        if x.shape[0] % n_dp == 0:
            return _moe_ffn_ep_global(x, p, cfg, mesh, expert_perm)
    return _moe_ffn_dense(x, p, cfg, expert_perm)


def _moe_ffn_dense(x, p, cfg: ModelConfig, expert_perm=None):
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity(cfg, T)
    xt = x.reshape(T, D)

    probs, top_w, top_e = route(xt, p["router"], K, expert_perm)
    aux, frac = routing_stats(probs, top_e, E, K)
    expert_load = frac * T * K                                    # tokens/e

    buf, (_, st, sw, _, dest) = _local_dispatch(xt, top_w, top_e, E, K, C)
    out_buf = _experts(buf, p["w_gate"], p["w_up"], p["w_down"], x.dtype)
    out = combine(out_buf.reshape(E * C, D), st, sw, dest, T, K)

    if cfg.n_shared_experts > 0:
        out = out + swiglu(x, p["shared"]).reshape(T, D)

    return out.reshape(B, S, D), aux.float(), expert_load


# ---------------------------------------------------------------------------
# Explicit expert parallelism -- see the module docstring.
# ---------------------------------------------------------------------------


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


class _Share(torch.autograd.Function):
    """Identity forward; the backward passes ``1 / n`` of the cotangent:
    the share of an output that ``n`` ranks hold alike."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over ``group``:
    the ranks' shares of a replicated input's gradient, made whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with equal splits along dim 0 over ``group``;
    its backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along dim 0 over ``group`` (rank order); the
    backward sums the cotangents over the group and keeps this rank's
    rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        ctx.rows = x.shape[0]
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((ctx.rows,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM,
                                   group=ctx.group)
        return out, None


ROUTED = ("router", "w_gate", "w_up", "w_down")


def _moe_ffn_ep_global(x, p, cfg: ModelConfig, mesh, expert_perm=None):
    """``moe_ffn``'s expert-parallel path on the global batch ``x`` (the
    same on every rank): this rank's data shard through ``_moe_ffn_ep``,
    the outputs gathered over the data axes, the shared experts on the
    whole batch.  The routed path's inputs (``x`` and the routed weights)
    enter through ``_SumGrad`` and its output leaves through ``_Share``,
    so every rank's gradients are the global ones."""
    batch_axes = _batch_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in batch_axes)
    n = math.prod(mesh.shape.values())
    everyone = mesh.group(tuple(mesh.shape))
    coord = mesh.coordinate
    d = 0
    for a in batch_axes:                       # row-major over the axes
        d = d * mesh.shape[a] + coord[a]
    B_loc = x.shape[0] // n_dp
    x_loc = _SumGrad.apply(x, everyone)[d * B_loc:(d + 1) * B_loc]
    routed = {k: _SumGrad.apply(p[k], everyone) for k in ROUTED}
    out, aux, load = _moe_ffn_ep(x_loc, routed, cfg, mesh, expert_perm)
    if n_dp > 1:
        out = _AllGather.apply(out, mesh.group(batch_axes))
    out = _Share.apply(out, n)                 # every rank holds it alike
    if cfg.n_shared_experts > 0:
        out = out + swiglu(x, p["shared"])
    return out, aux, load


def _moe_ffn_ep(x_loc, p, cfg: ModelConfig, mesh, expert_perm=None):
    """Expert-parallel MoE on this rank's data shard ``x_loc`` (B_loc, S,
    D), with explicit all-to-alls over the ``model`` group.

    Per rank: local top-k routing -> local (E, C, D) buffers -> an
    all_to_all sends each expert group to its owner -> SwiGLU of this
    rank's E_loc experts (sliced from ``p`` by its index in the ``model``
    group) over (E_loc, n_ep*C, D) -> the reverse all_to_all -> the
    ordered combine.  Returns (this shard's routed-expert output -- no
    shared experts, as the reference's ``shard_map`` body --, aux
    averaged and load summed over the statistic axes).  With
    ``cfg.moe_seq_shard`` (and T_loc % n_ep == 0) each model rank
    dispatches its 1/n_ep of the shard's tokens and the outputs are
    all-gathered over ``model``.  ``aux`` carries on each rank its share
    of the cotangent (1 / the ranks that hold it).
    """
    B_loc, S, D = x_loc.shape
    E, K = cfg.n_experts, cfg.top_k
    n_ep = mesh.shape["model"]
    E_loc = E // n_ep
    batch_axes = _batch_axes(mesh)
    T_loc = B_loc * S
    adt = x_loc.dtype
    me = mesh.coordinate["model"]
    model_group = mesh.get_group("model")

    seq_shard = cfg.moe_seq_shard and (T_loc % n_ep == 0)
    T_disp = T_loc // n_ep if seq_shard else T_loc
    C = capacity(cfg, T_disp)

    xt = x_loc.reshape(T_loc, D)
    if seq_shard:
        xt = xt[me * T_disp:(me + 1) * T_disp]
    probs, top_w, top_e = route(xt, p["router"], K, expert_perm)

    # Statistics (over data; and over model when seq-sharded).
    aux_loc, frac = routing_stats(probs, top_e, E, K)
    load = frac * T_disp * K
    stat_axes = batch_axes + (("model",) if seq_shard else ())
    n_stat = math.prod(mesh.shape[a] for a in stat_axes)
    total = aux_loc.detach()
    if stat_axes:
        with torch.no_grad():
            stats = torch.cat([total.reshape(1).float(), load])
            dist.all_reduce(stats, group=mesh.group(stat_axes))
        total, load = stats[0], stats[1:]
    # pmean with a gradient: the value is the group's mean, the
    # derivative by this rank's own term is 1 (each rank holds a copy).
    aux = aux_loc - aux_loc.detach() + total / n_stat
    aux = _Share.apply(aux, math.prod(mesh.shape.values()))

    buf, (_, st, sw, _, dest) = _local_dispatch(xt, top_w, top_e, E, K, C)

    # (E, C, D) -> (n_ep, E_loc*C, D) -> all_to_all -> the peers' tokens
    # for this rank's experts.
    send = buf.reshape(n_ep, E_loc * C, D)
    recv = _AllToAll.apply(send, model_group)
    work = recv.reshape(n_ep, E_loc, C, D).transpose(0, 1) \
        .reshape(E_loc, n_ep * C, D)
    sl = slice(me * E_loc, (me + 1) * E_loc)
    out_w = _experts(work, p["w_gate"][sl], p["w_up"][sl], p["w_down"][sl],
                     adt)

    # Reverse route.
    back = out_w.reshape(E_loc, n_ep, C, D).transpose(0, 1) \
        .reshape(n_ep, E_loc * C, D)
    ret = _AllToAll.apply(back, model_group)
    out = combine(ret.reshape(E * C, D), st, sw, dest, T_disp, K)
    if seq_shard:
        out = _AllGather.apply(out, model_group)      # (T_loc, D)
    return out.reshape(B_loc, S, D), aux.float(), load
