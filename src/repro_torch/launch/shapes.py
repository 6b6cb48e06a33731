"""Assigned input shapes x architectures: abstract input specs (``meta``
tensors: shapes and dtypes, nothing allocated) and their logical sharding
axes.

The port of ``repro.launch.shapes``.  Shapes (per assignment):
  train_4k      seq 4,096   global_batch 256   -> train_step
  prefill_32k   seq 32,768  global_batch 32    -> prefill_step
  decode_32k    seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                  KV/SSM state of seq_len)
  long_500k     seq 524,288 global_batch 1     -> serve_step; SSM/hybrid
                                                  only (sub-quadratic);
                                                  skipped + documented for
                                                  pure full-attention archs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..models.config import ModelConfig
from ..models.layers import KVCache
from ..models.model import Cache, Model
from ..models.ssm import SSMState


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) — the 8 documented long_500k skips."""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is a pure full-attention architecture "
            "(skip documented in DESIGN.md §5.1 Architecture "
            "applicability)")
    return True, ""


def _tok(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _emb(shape, cfg: ModelConfig):
    return torch.empty(shape, dtype=cfg.adtype, device="meta")


def batch_specs(cfg: ModelConfig, spec: ShapeSpec,
                with_labels: bool) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (tree of meta tensors, logical-axes tree) for a batch dict."""
    B, S = spec.global_batch, spec.seq
    specs: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}
    if cfg.family == "vlm":
        specs["tokens"] = _tok((B, S))
        axes["tokens"] = ("batch", "seq")
        specs["patch_embeds"] = _emb((B, cfg.n_frontend_tokens,
                                      cfg.d_model), cfg)
        axes["patch_embeds"] = ("batch", "frontend", "act_embed")
    elif cfg.frontend_is_embedding:
        specs["embeds"] = _emb((B, S, cfg.d_model), cfg)
        axes["embeds"] = ("batch", "seq", "act_embed")
    else:
        specs["tokens"] = _tok((B, S))
        axes["tokens"] = ("batch", "seq")
    if with_labels:
        specs["labels"] = _tok((B, S))
        axes["labels"] = ("batch", "seq")
    return specs, axes


def cache_specs(cfg: ModelConfig, batch: int, length: int):
    """Abstract decode cache (``Model.init_cache`` on the meta device) +
    logical axes."""
    cache = Model(cfg, device="meta").init_cache(batch, length)
    axes = Cache(
        kv=(KVCache(
            k=("layers", "batch", "cache_seq", "kv_heads", None),
            v=("layers", "batch", "cache_seq", "kv_heads", None),
            pos=("layers", "batch", "cache_seq"),
        ) if cache.kv != () else ()),
        ssm=(SSMState(
            conv=("layers", "batch", None, "ssm_inner"),
            ssd=("layers", "batch", "ssm_heads", None, None),
        ) if cache.ssm != () else ()),
        index=("batch",),
    )
    return cache, axes


def decode_input_specs(cfg: ModelConfig, spec: ShapeSpec):
    """-> ((cache, tokens) meta tensors, (cache_axes, token_axes))."""
    B, S = spec.global_batch, spec.seq
    if cfg.family == "vlm":
        S += cfg.n_frontend_tokens  # cache also holds the image prefix
    cache, cache_axes = cache_specs(cfg, B, S)
    if cfg.frontend_is_embedding:
        tok = _emb((B, 1, cfg.d_model), cfg)
        tok_axes = ("batch", None, "act_embed")
    else:
        tok = _tok((B, 1))
        tok_axes = ("batch", None)
    return (cache, tok), (cache_axes, tok_axes)


def input_specs(cfg: ModelConfig, shape_name: str):
    """Public entry: abstract inputs for (arch x shape).

    train   -> (batch_specs, batch_axes)
    prefill -> (batch_specs, batch_axes)
    decode  -> ((cache, tokens), (cache_axes, token_axes))
    """
    spec = SHAPES[shape_name]
    ok, why = applicable(cfg, shape_name)
    if not ok:
        raise ValueError(why)
    if spec.kind == "train":
        return batch_specs(cfg, spec, with_labels=True)
    if spec.kind == "prefill":
        return batch_specs(cfg, spec, with_labels=False)
    return decode_input_specs(cfg, spec)
