"""zamba2-1.2b [hybrid] — 38L d_model=2048 Mamba2 backbone + one SHARED
attention block (32H kv=32, d_ff=8192) applied every 6 layers, vocab=32000,
ssm_state=64 [arXiv:2411.15242].

``attn_window=4096`` gives the shared block a sliding-window ring KV cache
for the ``long_500k`` decode shape, keeping the hybrid sub-quadratic in
context length (hardware-adaptation note in DESIGN.md)."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, norm="rms",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    ssm_chunk=256, attn_every=6, attn_window=4096,
)

SMOKE = FULL.with_(
    name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    attn_every=2, attn_window=16,
)
