"""paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1, head_dim=256)
d_ff=16384 vocab=257216; SigLIP frontend STUBBED per assignment:
``input_specs()`` provides 256 precomputed patch embeddings, consumed with
a bidirectional prefix mask [arXiv:2407.07726]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216, norm="rms",
    n_frontend_tokens=256,
)

SMOKE = FULL.with_(
    name="paligemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    head_dim=16, d_ff=128, vocab=256, n_frontend_tokens=8,
)
