"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128; SSD (state-space duality) chunked-matmul scan
[arXiv:2405.21060]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    ssm_chunk=256, norm="rms",
)

SMOKE = FULL.with_(
    name="mamba2-smoke", n_layers=2, d_model=64, vocab=256,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
)
