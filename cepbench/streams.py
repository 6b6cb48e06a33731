"""The two stream regimes of the paper's evaluation, frozen for the benchmark.

A copy of ``repro_torch.data.cep_streams`` (``emit_chunk``,
``traffic_stream``, ``stocks_stream``): the same seed gives the same
arrays, held so by ``cepbench/tests/test_cepbench_streams.py``.  It lives
here so that a change to the program cannot change the benchmark's
traffic.  Only numpy: a chunk is a plain tuple of arrays.

* **traffic** (Aarhus-like vehicle sensors): Zipf-skewed, stable rates
  with rare extreme regime shocks.
* **stocks** (NASDAQ-like price updates): near-uniform rates with a
  per-chunk random walk of rates and attribute means.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

import numpy as np


@dataclasses.dataclass
class StreamConfig:
    n_types: int = 3
    n_attrs: int = 1
    chunk_duration: float = 1.0
    chunk_cap: int = 512
    n_chunks: int = 500
    seed: int = 0
    base_rate: float = 30.0
    # traffic regime
    zipf_s: float = 1.4
    shift_every: float = 120.0
    shift_magnitude: float = 8.0
    # stocks regime
    walk_sigma: float = 0.02
    attr_walk_sigma: float = 0.03


class Chunk(NamedTuple):
    """One padded chunk: ``(N,)`` types, timestamps, validity and
    ``(N, A)`` attributes, with its time slice ``(t0, t1]``."""

    type_id: np.ndarray
    ts: np.ndarray
    attr: np.ndarray
    valid: np.ndarray
    t0: float
    t1: float


def emit_chunk(rng, rates, attr_mean, t0, *, chunk_duration: float = 1.0,
               chunk_cap: int = 512, n_attrs: int = 1,
               attr_sigma: float = 1.0) -> Chunk:
    """Poisson arrivals at ``rates`` over one slice, uniform timestamps,
    types interleaved, Gaussian attributes around ``attr_mean``."""
    t1 = t0 + chunk_duration
    n_types = len(rates)
    counts = rng.poisson(np.asarray(rates, np.float64) * chunk_duration)
    total = int(counts.sum())
    cap = chunk_cap
    if total > cap:
        scale = cap / total
        counts = np.floor(counts * scale).astype(counts.dtype)
        total = int(counts.sum())
    type_id = np.repeat(np.arange(n_types, dtype=np.int32), counts)
    ts = np.sort(rng.uniform(t0, t1, total)).astype(np.float32)
    order = rng.permutation(total)
    type_id = type_id[order]
    attrs = (np.asarray(attr_mean, np.float64)[type_id]
             + rng.normal(0, attr_sigma, (total, n_attrs))).astype(np.float32)
    pad = cap - total
    type_id = np.concatenate([type_id, np.full(pad, -1, np.int32)])
    ts = np.concatenate([ts, np.zeros(pad, np.float32)])
    attrs = np.concatenate([attrs, np.zeros((pad, n_attrs), np.float32)])
    valid = np.concatenate([np.ones(total, bool), np.zeros(pad, bool)])
    return Chunk(type_id, ts, attrs, valid, float(t0), float(t1))


def _emit(rng, cfg: StreamConfig, rates, attr_mean, t0) -> Chunk:
    return emit_chunk(rng, rates, attr_mean, t0,
                      chunk_duration=cfg.chunk_duration,
                      chunk_cap=cfg.chunk_cap, n_attrs=cfg.n_attrs)


def traffic_stream(cfg: StreamConfig) -> Iterator[Chunk]:
    """High skew, stable, rare extreme shifts (Aarhus-like)."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_types
    raw = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** cfg.zipf_s
    rng.shuffle(raw)
    rates = raw / raw.sum() * cfg.base_rate
    attr_mean = rng.normal(0, 1.0, (n, cfg.n_attrs))
    t = 0.0
    next_shift = rng.exponential(cfg.shift_every)
    for _ in range(cfg.n_chunks):
        if t >= next_shift:
            i, j = rng.choice(n, 2, replace=False)
            rates[i], rates[j] = rates[j] * cfg.shift_magnitude, \
                rates[i] / cfg.shift_magnitude
            rates = rates / rates.sum() * cfg.base_rate
            k = rng.integers(n)
            attr_mean[k] += rng.normal(0, 2.0, cfg.n_attrs)
            next_shift = t + rng.exponential(cfg.shift_every)
        yield _emit(rng, cfg, rates, attr_mean, t)
        t += cfg.chunk_duration


def stocks_stream(cfg: StreamConfig) -> Iterator[Chunk]:
    """Near-uniform rates, frequent small random-walk drift (NASDAQ-like)."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_types
    log_rates = np.log(np.full(n, cfg.base_rate / n)) \
        + rng.normal(0, 0.01, n)
    attr_mean = rng.normal(0, 0.1, (n, cfg.n_attrs))
    t = 0.0
    for _ in range(cfg.n_chunks):
        log_rates += rng.normal(0, cfg.walk_sigma, n)
        log_rates -= (log_rates.mean() - np.log(cfg.base_rate / n)) * 0.05
        attr_mean += rng.normal(0, cfg.attr_walk_sigma, (n, cfg.n_attrs))
        rates = np.exp(log_rates)
        yield _emit(rng, cfg, rates, attr_mean, t)
        t += cfg.chunk_duration


STREAMS = {"traffic": traffic_stream, "stocks": stocks_stream}
