"""Core transformer layers: norms, RoPE, GQA attention (train / prefill /
decode with KV cache, prefix-LM and sliding-window masks), SwiGLU FFN.

The port of ``repro.models.layers``.  Functions are pure (a decode step
returns a new cache and leaves its input as it was); parameters come from
a ``params.ParamTree`` (or any mapping of tensors).  Attention is plain
torch ops — einsums and a masked softmax with the reference's ``-1e30``
fill — so its masks and its f32 softmax are the reference's.  The
reference's logical sharding annotations are no-ops on one device and
are left out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamDef

INT32_MAX = torch.iinfo(torch.int32).max

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


def np_layer_norm(x, eps: float = 1e-5):
    """Non-parametric LayerNorm (OLMo): no scale, no bias."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def apply_norm(x, w, kind: str):
    if kind == "rms":
        return rms_norm(x, w)
    if kind == "np_ln":
        return np_layer_norm(x)
    raise ValueError(kind)


def norm_def(cfg: ModelConfig) -> ParamDef:
    # np_ln keeps a (unused, zero-size-free) ones vector for tree uniformity.
    return ParamDef((cfg.d_model,), ("embed",), "ones")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, T, K, hd)
    v: torch.Tensor    # (B, T, K, hd)
    pos: torch.Tensor  # (B, T) i32 absolute positions (-1 = empty)


def attn_defs(cfg: ModelConfig) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "qkv_dim")),
        "wk": ParamDef((d, k, hd), ("embed", "kv_heads", "qkv_dim")),
        "wv": ParamDef((d, k, hd), ("embed", "kv_heads", "qkv_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "qkv_dim", "embed")),
    }


def _gqa_scores(q, k, cfg: ModelConfig):
    """q: (B,S,K,G,hd), k: (B,T,K,hd) -> (B,K,G,S,T) fp32."""
    s = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float())
    return s / (cfg.hd ** 0.5)


def _flash_attention(q, k, v, cfg: ModelConfig, pos_q, pos_k,
                     prefix_len: int, window: int):
    """Blockwise streaming-softmax attention (FlashAttention schedule).

    q: (B,S,K,G,hd); k, v: (B,T,K,hd); pos_q: (B,S); pos_k: (B,T).  A loop
    over KV blocks (the reference's ``lax.scan``) keeps live memory at
    O(B·K·G·S·block) instead of the O(S·T) score matrix; numerics follow
    the running (max, denom, acc) recurrence in fp32.  K/V are padded to
    whole blocks with positions at int32-max, which fail the causal and
    prefix masks.
    """
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    blk = min(cfg.attn_kv_block, T)
    pad = (-T) % blk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos_k = torch.cat([pos_k, pos_k.new_full((B, pad), INT32_MAX)], 1)
    nb = (T + pad) // blk

    m = torch.full((B, K, G, S), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, G, hd), dtype=torch.float32, device=q.device)
    for i in range(nb):
        kc = k[:, i * blk:(i + 1) * blk]
        vc = v[:, i * blk:(i + 1) * blk]
        pkc = pos_k[:, i * blk:(i + 1) * blk]
        s = torch.einsum("bskgh,btkh->bkgst", q.float(),
                         kc.float()) / (hd ** 0.5)
        ok = pos_q[:, :, None] >= pkc[:, None, :]           # (B,S,blk)
        if prefix_len > 0:
            ok = ok | (pkc[:, None, :] < prefix_len)
        if window > 0:
            ok = ok & (pos_q[:, :, None] - pkc[:, None, :] < window)
        s = torch.where(ok[:, None, None, :, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))            # (B,K,G,S)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), vc)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv.float()
        m = m_new
    denom = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return (acc / denom).to(q.dtype)


def project_kv(x, p, cfg: ModelConfig, positions):
    """The roped keys and the values of ``x``: (B, S, K, hd) each."""
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    return rope(k, positions, cfg.rope_theta), v


def attention(
    x: torch.Tensor,
    p,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    prefix_len: int = 0,
    cache: Optional[KVCache] = None,
    cache_index: Optional[torch.Tensor] = None,
    window: int = 0,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """GQA attention.

    Without ``cache``: full-sequence causal (optionally prefix-LM over the
    first ``prefix_len`` positions — PaliGemma-style bidirectional prefix).

    With ``cache``: single-step decode; the new token's K/V is written at
    ``cache_index`` (ring-buffer slot when ``window > 0``) and attention
    runs over the whole cache with position-validity masking.  A write
    slot past the cache's end (``cache_index == T`` without a window) is
    dropped, as the reference's scatter drops it: the step attends over
    the cache as it was.
    """
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // K

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q = rope(q, positions, cfg.rope_theta)
    k, v = project_kv(x, p, cfg, positions)
    q = q.reshape(B, S, K, G, hd)

    if cache is None:
        if S > cfg.attn_direct_max:
            # Long sequences: blockwise streaming softmax (flash).
            out = _flash_attention(q, k, v, cfg, positions, positions,
                                   prefix_len, window)
        else:
            scores = _gqa_scores(q, k, cfg)  # (B,K,G,S,T) T=S
            pos_q = positions[:, :, None]
            pos_k = positions[:, None, :]
            causal = pos_q >= pos_k                      # (B,S,T)
            if prefix_len > 0:
                causal = causal | (pos_k < prefix_len)   # bidir prefix
            if window > 0:
                causal = causal & (pos_q - pos_k < window)
            scores = torch.where(causal[:, None, None, :, :], scores, -1e30)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = torch.einsum("bkgst,btkh->bskgh", probs, v)
        new_cache = None
    else:
        # Decode: S == 1; cache_index: (B,) per-request write slots.
        assert S == 1
        T = cache.k.shape[1]
        slot = cache_index if window == 0 else cache_index % T
        bidx = torch.arange(B, device=x.device)
        inb = slot < T
        slot = torch.clamp(slot, max=T - 1).long()
        keep = inb[:, None, None]

        def put(buf, new, keep):
            new = torch.where(keep, new.to(buf.dtype), buf[bidx, slot])
            return buf.index_put((bidx, slot), new)

        ck = put(cache.k, k[:, 0], keep)
        cv = put(cache.v, v[:, 0], keep)
        cpos = put(cache.pos, positions[:, 0], inb)
        scores = _gqa_scores(q, ck.to(x.dtype), cfg)  # (B,K,G,1,T)
        valid = (cpos >= 0) & (cpos <= positions[:, :1])  # (B,T)
        if window > 0:
            valid = valid & (positions[:, :1] - cpos < window)
        scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs, cv.to(x.dtype))
        new_cache = KVCache(ck, cv, cpos)

    out = out.reshape(B, S, H, hd)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, dtype,
                  device) -> KVCache:
    K, hd = cfg.n_kv_heads, cfg.hd
    return KVCache(
        k=torch.zeros((batch, length, K, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, length, K, hd), dtype=dtype, device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32,
                       device=device),
    )


def prefill_kv_cache(cfg: ModelConfig, x_k, x_v, positions) -> KVCache:
    """Build a cache directly from a prefill pass's K/V tensors."""
    B = x_k.shape[0]
    return KVCache(k=x_k, v=x_v,
                   pos=torch.broadcast_to(positions, (B, x_k.shape[1])))


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def ffn_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed", "ff")),
        "w_up": ParamDef((d, f), ("embed", "ff")),
        "w_down": ParamDef((f, d), ("ff", "embed")),
    }


def swiglu(x, p):
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> dict:
    out = {"tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           scale=1.0)}
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return out


def embed(tokens, p, cfg: ModelConfig):
    # F.embedding, not p["tok"][tokens]: the same rows forward, but its
    # backward sums a token's rows in a fixed order, where indexing's
    # accumulating backward adds them atomically (run-to-run bit
    # differences in the gradient on a multi-threaded CPU).
    return F.embedding(tokens.long(), p["tok"]).to(cfg.adtype)


def unembed(x, p, cfg: ModelConfig):
    w = (p["tok"].T if cfg.tie_embeddings else p["head"]).to(x.dtype)
    return x @ w
