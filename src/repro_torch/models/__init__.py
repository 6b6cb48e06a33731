"""Model zoo of the port: dense GQA transformers, fine-grained MoE, Mamba2
SSD, hybrids, and VLM/audio backbones — torch modules whose parameter
names follow the reference's pytree paths (``repro.models``)."""

from .config import ModelConfig  # noqa: F401
from .model import Cache, Model  # noqa: F401
