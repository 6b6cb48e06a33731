"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000;
llama-arch GQA [arXiv:2403.04652]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, norm="rms",
)

SMOKE = FULL.with_(
    name="yi-smoke", n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
    head_dim=8, d_ff=128, vocab=256,
)
