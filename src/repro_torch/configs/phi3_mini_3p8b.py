"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064; RoPE + SwiGLU, full MHA (GQA group 1) [arXiv:2404.14219]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, norm="rms",
)

SMOKE = FULL.with_(
    name="phi3-mini-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256,
)
