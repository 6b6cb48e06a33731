"""Mamba2 (SSD — state-space duality) block, arXiv:2405.21060.

The port of ``repro.models.ssm``.  The SSD layer computes, per head ``h``
with scalar decay ``A_h < 0``:

    h_t = exp(dt_t A) h_{t-1} + dt_t (B_t ⊗ x_t),      y_t = C_t · h_t + D x_t

Training/prefill uses the paper's **chunked matmul form** (Listing 1): the
sequence splits into chunks of length ``Q``; intra-chunk terms are a masked
``C Bᵀ`` product, inter-chunk terms flow through a recurrence over
per-chunk states — here a loop over chunks carrying the state, as the
reference's ``lax.scan`` does.

Decode maintains (conv_state, ssd_state) and costs O(1) per token.

Layout: x/B/C pass through a short causal depthwise conv (width
``ssm_conv``); gating ``z`` and the dt head come straight from the input
projection; output is ``out_proj(rms_norm(y) * silu(z))``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import rms_norm
from .params import ParamDef


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, conv_w - 1, conv_ch) rolling conv inputs
    ssd: torch.Tensor   # (B, H, P, N) recurrent state


def ssm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    conv_ch = di + 2 * n
    return {
        # in_proj -> [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": ParamDef((d, 2 * di + 2 * n + h), ("embed", "ssm_inner")),
        "conv_w": ParamDef((cfg.ssm_conv, conv_ch), ("conv", "ssm_inner"),
                           scale=0.5),
        "A_log": ParamDef((h,), ("ssm_heads",), "zeros"),
        "D": ParamDef((h,), ("ssm_heads",), "ones"),
        "dt_bias": ParamDef((h,), ("ssm_heads",), "zeros"),
        "norm_w": ParamDef((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg: ModelConfig, proj):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    assert dt.shape[-1] == h
    return z, xBC, dt


def _causal_conv(xBC, w):
    """Depthwise causal conv over time.  xBC: (B,S,CH), w: (W,CH)."""
    W = w.shape[0]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(W):  # small static unroll (W = 4)
        out = out + pad[:, i:i + xBC.shape[1], :] * w[i][None, None, :]
    return F.silu(out)


def _segsum(a):
    """Stable 'segment sum': out[..., i, j] = sum_{k=j+1..i} a[..., k].

    Lower-triangular; -inf above the diagonal.  a: (..., L).
    """
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(L, device=a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan, streamed over chunks.

    x: (b, s, h, p); dt: (b, s, h) (post-softplus); A: (h,) negative;
    B, C: (b, s, n) (single group, broadcast over heads).
    Returns y: (b, s, h, p) and final state (b, h, p, n).

    A loop over the ``s/chunk`` chunks carries the recurrent state;
    per-step live memory is the chunk-local decay mask ``(b, h, q, q)``.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = chunk
    assert s % q == 0, (s, q)
    nc = s // q

    xd = x * dt[..., None]                                  # dt-weighted
    a = dt * A[None, None, :]                               # (b, s, h) <= 0
    xc = xd.reshape(b, nc, q, h, p)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)
    ac = a.reshape(b, nc, q, h).transpose(2, 3)             # (b,nc,h,q)

    h_state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for c in range(nc):
        x_c, B_c, C_c, a_c = xc[:, c], Bc[:, c], Cc[:, c], ac[:, c]
        a_cum = torch.cumsum(a_c, dim=-1)                   # (b,h,q)
        Lm = torch.exp(_segsum(a_c))                        # (b,h,q,q)
        scores = torch.einsum("bln,bsn->bls", C_c, B_c)     # (b,q,q)
        y_diag = torch.einsum("bhls,bls,bshp->blhp", Lm, scores, x_c)
        decay_states = torch.exp(a_cum[..., -1:] - a_cum)   # (b,h,q)
        contrib = torch.einsum("bln,bhl,blhp->bhpn",
                               B_c, decay_states, x_c)
        y_off = torch.einsum("bln,bhpn,bhl->blhp",
                             C_c, h_state, torch.exp(a_cum))
        h_state = (h_state * torch.exp(a_cum[..., -1])[..., None, None]
                   + contrib)
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y, h_state


def ssm_block(x, p, cfg: ModelConfig, state: SSMState | None = None
              ) -> Tuple[torch.Tensor, SSMState]:
    """One Mamba2 block.  x: (B, S, D).

    With ``state`` and S == 1: O(1) recurrent decode step.
    Without: chunked scan over the sequence (train / prefill); the returned
    state allows seamless continuation into decode.
    """
    bsz, S, _ = x.shape
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    proj = x @ p["in_proj"].to(x.dtype)
    z, xBC, dt_raw = _split_proj(cfg, proj)
    A = -torch.exp(p["A_log"].float())                      # (h,)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    w = p["conv_w"].to(x.dtype)
    W = cfg.ssm_conv

    if state is not None and S == 1:
        # ---- decode ----
        window = torch.cat([state.conv, xBC], dim=1)        # (B, W, CH)
        conv_out = F.silu(
            torch.einsum("bwc,wc->bc", window, w))[:, None, :]  # (B,1,CH)
        new_conv = window[:, 1:, :]
        xs = conv_out[..., :di].reshape(bsz, 1, h, pdim)
        Bv = conv_out[..., di:di + n][:, 0]                  # (B, n)
        Cv = conv_out[..., di + n:][:, 0]                    # (B, n)
        dt1 = dt[:, 0]                                       # (B, h)
        decay = torch.exp(dt1 * A[None, :])                  # (B, h)
        xd = xs[:, 0] * dt1[..., None]                       # (B, h, p)
        upd = torch.einsum("bhp,bn->bhpn", xd, Bv)
        new_ssd = state.ssd * decay[..., None, None].to(x.dtype) \
            + upd.to(x.dtype)
        y = torch.einsum("bhpn,bn->bhp", new_ssd, Cv)
        y = y + xs[:, 0] * p["D"].to(x.dtype)[None, :, None]
        y = y.reshape(bsz, 1, di)
        new_state = SSMState(new_conv, new_ssd)
    else:
        # ---- train / prefill ----
        conv_out = _causal_conv(xBC, w)                      # (B,S,CH)
        xs = conv_out[..., :di].reshape(bsz, S, h, pdim)
        Bv = conv_out[..., di:di + n]
        Cv = conv_out[..., di + n:]
        y, final = ssd_chunked(xs.float(), dt, A, Bv.float(), Cv.float(),
                               min(cfg.ssm_chunk, S))
        y = y + xs.float() * p["D"].float()[None, None, :, None]
        y = y.reshape(bsz, S, di).to(x.dtype)
        new_conv = F.pad(
            xBC, (0, 0, max(W - 1 - S, 0), 0))[:, -(W - 1):, :]
        new_state = SSMState(new_conv, final.to(x.dtype))

    y = rms_norm(y, p["norm_w"]) * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, new_state


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device) -> SSMState:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                         device=device),
        ssd=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=dtype, device=device),
    )
