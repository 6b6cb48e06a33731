"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048; decoder-only over EnCodec tokens; the EnCodec frontend is
STUBBED per assignment: ``input_specs()`` provides precomputed frame
embeddings [arXiv:2306.05284]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, norm="rms",
    frontend_is_embedding=True,
)

SMOKE = FULL.with_(
    name="musicgen-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=64,
)
