"""olmo-1b [dense] — 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304;
non-parametric LayerNorm (no learnable scale/bias) [arXiv:2402.00838]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304, norm="np_ln",
)

SMOKE = FULL.with_(
    name="olmo-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
)
