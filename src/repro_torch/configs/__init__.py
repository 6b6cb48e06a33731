"""Architecture registry of the port: the 10 assigned configs, copied
from ``repro.configs`` (the ``FULL``/``SMOKE`` literals are the
reference's, on the port's ``ModelConfig``).  ``get_config(name)`` returns
the FULL production config; ``get_smoke(name)`` a reduced same-family
config for CPU smoke tests."""

from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig

ARCHS = [
    "phi3_mini_3p8b",
    "olmo_1b",
    "yi_34b",
    "stablelm_12b",
    "deepseek_moe_16b",
    "dbrx_132b",
    "paligemma_3b",
    "musicgen_large",
    "mamba2_1p3b",
    "zamba2_1p2b",
]

# CLI aliases (assignment ids) -> module names
ALIASES = {
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "olmo-1b": "olmo_1b",
    "yi-34b": "yi_34b",
    "stablelm-12b": "stablelm_12b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "dbrx-132b": "dbrx_132b",
    "paligemma-3b": "paligemma_3b",
    "musicgen-large": "musicgen_large",
    "mamba2-1.3b": "mamba2_1p3b",
    "zamba2-1.2b": "zamba2_1p2b",
}


def _module(name: str):
    mod = ALIASES.get(name, name)
    if mod not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; know {sorted(ALIASES)}")
    return importlib.import_module(f".{mod}", __package__)


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).FULL
    return cfg.with_(**overrides) if overrides else cfg


def get_smoke(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).SMOKE
    return cfg.with_(**overrides) if overrides else cfg


def list_archs() -> List[str]:
    return list(ALIASES)
