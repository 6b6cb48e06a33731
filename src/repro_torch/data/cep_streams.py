"""Synthetic event-stream generators matching the paper's two data regimes.

The paper evaluates on two real-world datasets whose *statistical regimes*
drive all of its findings (§5.1):

* **traffic** (City of Aarhus vehicle sensors): arrival rates and
  selectivities are *highly skewed and stable*, with *rare but extreme*
  on-the-fly changes.
* **stocks** (NASDAQ per-minute price updates): *near-uniform* statistics
  with *frequent but minor* drift.

This container is offline, so we reproduce those regimes with
distribution-matched generators (DESIGN.md §2).  Every generator is fully
deterministic given its seed, emits fixed-capacity padded chunks of numpy
arrays (static shapes for the engine) and exposes its ground-truth rate
trajectory for debugging and tests.  This is a copy of the JAX package's
``repro.data.cep_streams``: the same seed gives the same arrays.

Attributes: each event carries ``n_attrs`` float attributes drawn around a
per-type mean that drifts with the regime; predicate selectivities therefore
drift together with the attribute means, exactly like the real datasets
(speed/vehicle-count correlations; stock price diffs).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from ..core.engine import Chunk


@dataclasses.dataclass
class StreamConfig:
    n_types: int = 3
    n_attrs: int = 1
    chunk_duration: float = 1.0
    chunk_cap: int = 512           # padded chunk capacity (static shape)
    n_chunks: int = 500
    seed: int = 0
    base_rate: float = 30.0        # mean total events per time unit
    # traffic regime
    zipf_s: float = 1.4            # rate skew exponent
    shift_every: float = 120.0     # mean time between regime shifts
    shift_magnitude: float = 8.0   # multiplicative shock size
    # stocks regime
    walk_sigma: float = 0.02       # per-chunk log-rate random-walk step
    attr_walk_sigma: float = 0.03  # per-chunk attribute-mean drift


@dataclasses.dataclass
class ChunkRecord:
    chunk: Chunk          # padded, masked
    t0: float
    t1: float
    counts: np.ndarray    # (n_types,) true per-type event counts
    true_rates: np.ndarray

    @property
    def n_events(self) -> int:
        return int(self.counts.sum())


def emit_chunk(rng, rates, attr_mean, t0, *, chunk_duration: float = 1.0,
               chunk_cap: int = 512, n_attrs: int = 1,
               attr_sigma: float = 1.0) -> ChunkRecord:
    """Emit one padded chunk of Poisson arrivals at the given true rates.

    The shared emission kernel behind every generator in this module and
    the scenario adapters (``data.scenarios``): per-type Poisson counts
    over ``chunk_duration``, uniform timestamps within the slice, types
    interleaved over time, attributes Gaussian around ``attr_mean`` —
    fully deterministic given ``rng``.  ``rates`` has shape ``(n_types,)``
    and ``attr_mean`` ``(n_types, n_attrs)``; the true rates ride along in
    the record as the ground-truth drift trajectory.
    """
    t1 = t0 + chunk_duration
    n_types = len(rates)
    counts = rng.poisson(np.asarray(rates, np.float64) * chunk_duration)
    total = int(counts.sum())
    cap = chunk_cap
    if total > cap:  # clip proportionally, keeping determinism
        scale = cap / total
        counts = np.floor(counts * scale).astype(counts.dtype)
        total = int(counts.sum())
    type_id = np.repeat(np.arange(n_types, dtype=np.int32), counts)
    ts = np.sort(rng.uniform(t0, t1, total)).astype(np.float32)
    order = rng.permutation(total)  # interleave types over time
    type_id = type_id[order]
    attrs = (np.asarray(attr_mean, np.float64)[type_id]
             + rng.normal(0, attr_sigma, (total, n_attrs))).astype(np.float32)
    # pad to capacity
    pad = cap - total
    type_id = np.concatenate([type_id, np.full(pad, -1, np.int32)])
    ts = np.concatenate([ts, np.zeros(pad, np.float32)])
    attrs = np.concatenate([attrs, np.zeros((pad, n_attrs), np.float32)])
    valid = np.concatenate([np.ones(total, bool), np.zeros(pad, bool)])
    return ChunkRecord(
        chunk=Chunk(type_id, ts, attrs, valid),
        t0=float(t0), t1=float(t1),
        counts=counts.astype(np.float64),
        true_rates=np.asarray(rates, np.float64).copy(),
    )


def _emit(rng, cfg: StreamConfig, rates, attr_mean, t0) -> ChunkRecord:
    return emit_chunk(rng, rates, attr_mean, t0,
                      chunk_duration=cfg.chunk_duration,
                      chunk_cap=cfg.chunk_cap, n_attrs=cfg.n_attrs)


def traffic_stream(cfg: StreamConfig) -> Iterator[ChunkRecord]:
    """High skew, stable, rare extreme shifts (Aarhus-like)."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_types
    # Zipf-skewed base rates, normalized to base_rate total.
    raw = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** cfg.zipf_s
    rng.shuffle(raw)
    rates = raw / raw.sum() * cfg.base_rate
    attr_mean = rng.normal(0, 1.0, (n, cfg.n_attrs))
    t = 0.0
    next_shift = rng.exponential(cfg.shift_every)
    for _ in range(cfg.n_chunks):
        if t >= next_shift:
            # Extreme shock: pick two types and swap + rescale their rates;
            # shift one attribute mean far enough to flip selectivities.
            i, j = rng.choice(n, 2, replace=False)
            rates[i], rates[j] = rates[j] * cfg.shift_magnitude, \
                rates[i] / cfg.shift_magnitude
            rates = rates / rates.sum() * cfg.base_rate
            k = rng.integers(n)
            attr_mean[k] += rng.normal(0, 2.0, cfg.n_attrs)
            next_shift = t + rng.exponential(cfg.shift_every)
        yield _emit(rng, cfg, rates, attr_mean, t)
        t += cfg.chunk_duration


def stocks_stream(cfg: StreamConfig) -> Iterator[ChunkRecord]:
    """Near-uniform rates, frequent small random-walk drift (NASDAQ-like)."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_types
    # Nearly identical initial rates (paper: "initial values nearly
    # identical for all event types").
    log_rates = np.log(np.full(n, cfg.base_rate / n)) \
        + rng.normal(0, 0.01, n)
    attr_mean = rng.normal(0, 0.1, (n, cfg.n_attrs))
    t = 0.0
    for _ in range(cfg.n_chunks):
        log_rates += rng.normal(0, cfg.walk_sigma, n)
        # soft renormalization keeps total rate bounded
        log_rates -= (log_rates.mean() - np.log(cfg.base_rate / n)) * 0.05
        attr_mean += rng.normal(0, cfg.attr_walk_sigma, (n, cfg.n_attrs))
        rates = np.exp(log_rates)
        yield _emit(rng, cfg, rates, attr_mean, t)
        t += cfg.chunk_duration


def make_stream(kind: str, cfg: StreamConfig) -> Iterator[ChunkRecord]:
    if kind == "traffic":
        return traffic_stream(cfg)
    if kind == "stocks":
        return stocks_stream(cfg)
    raise ValueError(f"unknown stream kind {kind!r}")
