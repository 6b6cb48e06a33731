"""Unified architecture configuration (the port's copy of
``repro.models.config``; ``pdtype`` and ``adtype`` are torch dtypes).

One dataclass describes every assigned architecture family:

* ``dense``  — GQA/MQA decoder transformer (RoPE + SwiGLU).
* ``moe``    — dense attention + shared/routed fine-grained expert FFN.
* ``vlm``    — dense backbone consuming precomputed patch embeddings
               prepended to the token sequence (frontend is a stub per the
               assignment).
* ``audio``  — dense backbone consuming precomputed frame embeddings
               (EnCodec-token decoder; frontend stubbed).
* ``ssm``    — attention-free Mamba2 (SSD) stack.
* ``hybrid`` — Mamba2 backbone with a *shared* attention block applied every
               ``attn_every`` layers (Zamba2 style).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int
    d_ff: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: Optional[int] = None
    norm: str = "rms"             # rms | np_ln (non-parametric LayerNorm)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_seq_shard: bool = False   # §Perf: dispatch from seq-sharded tokens
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0            # N
    ssm_head_dim: int = 64        # P
    ssm_expand: int = 2           # d_inner = expand * d_model
    ssm_conv: int = 4             # causal conv width
    ssm_chunk: int = 128          # SSD chunk length
    ssm_scan_unroll: int = 1      # dry-run accounting: unroll SSD scan
    # --- hybrid (Zamba2) ---
    attn_every: int = 0           # shared attn block period; 0 = never
    attn_window: int = 0          # sliding-window KV for long decode; 0=full
    # --- modality frontends (stubs per assignment) ---
    n_frontend_tokens: int = 0    # VLM: # patch embeddings prepended
    frontend_is_embedding: bool = False  # audio: inputs are embeddings
    # --- attention execution ---
    attn_direct_max: int = 4096   # S above this -> blockwise (flash) attn
    attn_kv_block: int = 2048     # KV block length for the flash scan
    # --- numerics ---
    param_dtype: str = "f32"
    dtype: str = "f32"            # activation/compute dtype

    def __post_init__(self):
        if self.family in ("dense", "moe", "vlm", "audio"):
            assert self.n_heads > 0 and self.n_kv_heads > 0
            assert self.n_heads % self.n_kv_heads == 0
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def pdtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def adtype(self):
        return _DTYPES[self.dtype]

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def n_shared_attn_calls(self) -> int:
        """Hybrid: number of shared-attention invocations over the stack."""
        if self.family != "hybrid" or self.attn_every <= 0:
            return 0
        return (self.n_layers + self.attn_every - 1) // self.attn_every

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----------

    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        n = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            hd = self.hd
            attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
                + hd * self.n_heads * d
            if self.family == "moe":
                ffn = self.n_experts * 3 * d * ff \
                    + self.n_shared_experts * 3 * d * ff + d * self.n_experts
            else:
                ffn = 3 * d * ff
            norms = 2 * d  # materialized even for np_ln (tree uniformity)
            n = self.n_layers * (attn + ffn + norms)
        elif self.family in ("ssm", "hybrid"):
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            conv_ch = di + 2 * N
            ssm = (d * (2 * di + 2 * N + H)      # in_proj (z,x,B,C,dt)
                   + conv_ch * self.ssm_conv      # depthwise conv
                   + 2 * H + H                    # A_log, D, dt_bias
                   + di * d                       # out_proj
                   + d + di)                      # layer norm + gate norm
            n = self.n_layers * ssm
            if self.family == "hybrid":
                hd = self.hd
                attn = (d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads
                        + hd * self.n_heads * d + 3 * d * self.d_ff
                        + 2 * d)
                n += attn  # shared block counted once
        n += v * d  # token embedding
        n += d      # final norm
        if not self.tie_embeddings:
            n += v * d  # output head
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k routed only)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * ff * self.n_layers
        return self.param_count() - inactive
