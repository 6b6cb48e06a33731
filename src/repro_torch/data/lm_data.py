"""Synthetic LM data pipeline — deterministic, shardable, frontend-aware.

The port's copy of ``repro.data.lm_data`` (numpy only): a batch is array
for array the reference's for the same config, seed and step.

Tokens follow a Zipf unigram distribution filtered through a first-order
Markov mixing kernel, giving the loss curve actual structure to learn
(bigram statistics) while remaining fully offline and reproducible.  Each
batch is a pure function of ``(seed, step)`` so any worker — or a restarted
job — regenerates exactly the same global batch: data-parallel shards slice
the same global batch by row, which is what makes checkpoint/restart and
elastic rescaling bit-exact.

For the stubbed-frontend families the pipeline fabricates the precomputed
embeddings the assignment specifies (VLM patch embeddings / audio frame
embeddings) from the same ``(seed, step)`` stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq: int = 128
    seed: int = 0
    zipf_a: float = 1.3
    markov_shift: int = 7      # deterministic bigram structure


def _unigram(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return p / p.sum()


def make_batch(cfg: ModelConfig, dcfg: DataConfig, step: int
               ) -> Dict[str, np.ndarray]:
    """Global batch for ``step`` — pure function of (seed, step)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([dcfg.seed, step]))
    B, S, V = dcfg.batch, dcfg.seq, cfg.vocab
    p = _unigram(V, dcfg.zipf_a)
    base = rng.choice(V, size=(B, S + 1), p=p).astype(np.int32)
    # Markov structure: with prob 1/2 the next token is a deterministic
    # function of the previous one — learnable bigram signal.
    follow = rng.random((B, S)) < 0.5
    nxt = (base[:, :-1] * dcfg.markov_shift + 1) % V
    tokens = base.copy()
    tokens[:, 1:] = np.where(follow, nxt, base[:, 1:])

    out: Dict[str, np.ndarray] = {
        "labels": tokens[:, 1:].astype(np.int32),
    }
    if cfg.family == "vlm":
        out["tokens"] = tokens[:, :-1].astype(np.int32)
        out["patch_embeds"] = rng.normal(
            0, 1, (B, cfg.n_frontend_tokens, cfg.d_model)
        ).astype(np.float32)
        # Loss over text positions only; logits already text-aligned.
    elif cfg.frontend_is_embedding:
        # Audio: embeddings stand in for EnCodec frame embeddings; labels
        # are the (synthetic) codec ids of the next frame.
        out["embeds"] = rng.normal(0, 1, (B, S, cfg.d_model)) \
            .astype(np.float32)
        out["labels"] = tokens[:, 1:].astype(np.int32)
    else:
        out["tokens"] = tokens[:, :-1].astype(np.int32)
    return out


def batch_iterator(cfg: ModelConfig, dcfg: DataConfig,
                   start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, dcfg, step)
        step += 1
