"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) expert d_ff=10752
vocab=100352; 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, norm="rms",
    n_experts=16, n_shared_experts=0, top_k=4,
)

SMOKE = FULL.with_(
    name="dbrx-smoke", n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
    head_dim=8, d_ff=64, vocab=256, n_experts=4, top_k=2,
)
