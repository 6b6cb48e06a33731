"""The input of a run: a pool of stacked chunks made from the seed, replayed.

Set-up draws ``pool_chunks`` chunks for each of the K partitions from the
configuration's stream regime (``streams.py``), one generator per
partition, with seeds derived from the run's seed.  The window replays the
pool: step ``i`` hands over pool position ``i % P`` with every timestamp
shifted by ``(i // P)`` pool spans, so the input never runs out, whatever
the program's speed.

A stream's state (rates, attribute means) at the end of a drawn pool is
not its state at the start, so a replay that wraps around (``"replay":
"wrap"``) puts a jump of that state at every seam, a regime shock the
stream regime does not have.  With ``"replay": "mirror"`` the pool holds
the drawn chunks and then the same chunks backwards in time (each
chunk's events in reverse order, each offset inside its slice reflected),
``P = 2 * pool_chunks`` positions whose statistics run on without a jump
at either seam.

Timestamps and attributes are put on binary grids (``quantum`` of the
configuration): a timestamp on multiples of ``ts`` inside its chunk's
slice ``(t0, t1]``, an attribute on multiples of ``attr``.  On these grids
every float32 form of a comparison the program may evaluate (``l < r +
theta`` or its mirror ``r > l - theta``, ``max < min + W``) is exact, and
a shift by whole pool spans leaves every difference unchanged, so the
exact reference decides every answer.  That holds while timestamps stay
below ``2**24 * ts`` (``exact_until``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .streams import STREAMS, StreamConfig


def partition_seeds(seed: int, k: int) -> Tuple[int, ...]:
    """K stream seeds from one run seed (any whole number)."""
    ss = np.random.SeedSequence(int(seed) % 2 ** 64)
    return tuple(int(s) for s in ss.generate_state(k, np.uint64))


def stream_config(stream: dict, n_chunks: int, seed: int) -> StreamConfig:
    fields = {f.name for f in dataclasses.fields(StreamConfig)}
    kw = {k: v for k, v in stream.items() if k in fields}
    return StreamConfig(**kw, n_chunks=n_chunks, seed=seed)


@dataclasses.dataclass
class Pool:
    """``P`` stacked chunks of K partitions: ``type_id``/``ts``/``valid``
    of shape ``(P, K, N)`` and ``attr`` of ``(P, K, N, A)``; chunk ``j``
    covers ``(j * dur, (j + 1) * dur]``."""

    type_id: np.ndarray
    ts: np.ndarray
    attr: np.ndarray
    valid: np.ndarray
    duration: float
    ts_quantum: float

    @property
    def chunks(self) -> int:
        return self.ts.shape[0]

    @property
    def partitions(self) -> int:
        return self.ts.shape[1]

    @property
    def span(self) -> float:
        return self.chunks * self.duration

    @property
    def exact_until(self) -> float:
        """Timestamps stay exact in float32 below this time."""
        return 2.0 ** 24 * self.ts_quantum

    def events(self) -> np.ndarray:
        """Valid events of each pool position, ``(P,)``."""
        return self.valid.sum(axis=(1, 2))

    def edges(self, i: int) -> Tuple[float, float]:
        """The slice ``(t0, t1]`` of replay step ``i``."""
        t0 = (i // self.chunks) * self.span + (i % self.chunks) * self.duration
        return float(t0), float(t0 + self.duration)

    def step(self, i: int):
        """Replay step ``i``: ``(type_id, ts, attr, valid)`` of shape
        ``(K, N)`` / ``(K, N, A)`` with shifted timestamps, and its
        slice."""
        j, cycle = i % self.chunks, i // self.chunks
        ts = self.ts[j]
        if cycle:
            ts = ts + np.float32(cycle * self.span)
        return (self.type_id[j], ts, self.attr[j], self.valid[j]), \
            self.edges(i)


def make_pool(config: dict, pool_chunks: int, seed: int) -> Pool:
    """Draw the pool of a configuration for a run seed."""
    stream = config["stream"]
    k = int(config["session"]["partitions"])
    gen = STREAMS[stream["kind"]]
    per_partition = []
    for s in partition_seeds(seed, k):
        per_partition.append(list(gen(stream_config(stream, pool_chunks, s))))
    quantum = config["quantum"]
    dur = float(stream.get("chunk_duration", 1.0))

    def stack(field):
        return np.stack([np.stack([getattr(c, field) for c in chunks])
                         for chunks in per_partition], axis=1)

    type_id, ts, attr, valid = (stack(f) for f in
                                ("type_id", "ts", "attr", "valid"))
    t0 = (np.arange(pool_chunks, dtype=np.float64) * dur)[:, None, None]
    pool = Pool(type_id=type_id,
                ts=quantize_ts(ts, valid, t0, dur, float(quantum["ts"])),
                attr=quantize(attr, float(quantum["attr"])),
                valid=valid, duration=dur, ts_quantum=float(quantum["ts"]))
    replay = config.get("replay", "wrap")
    if replay == "mirror":
        return mirrored(pool)
    if replay != "wrap":
        raise ValueError(f"unknown replay {replay!r}")
    return pool


def mirrored(pool: Pool) -> Pool:
    """The pool followed by itself backwards in time: position ``P + j``
    holds position ``P - 1 - j``'s events in reverse order, an event at
    offset ``o`` grid steps into its slice moved to ``steps + 1 - o``."""
    p, dur, q = pool.chunks, pool.duration, pool.ts_quantum
    valid = pool.valid
    n = valid.sum(axis=-1, keepdims=True)
    idx = np.arange(valid.shape[-1])
    src = np.where(idx < n, n - 1 - idx, idx)[::-1]

    def back(a):
        a = a[::-1]
        return np.take_along_axis(a, src if a.ndim == 3 else src[..., None],
                                  axis=2)

    t0 = (np.arange(p, dtype=np.float64) * dur)[::-1, None, None]
    new_t0 = (np.arange(p, 2 * p, dtype=np.float64) * dur)[:, None, None]
    off = back(pool.ts).astype(np.float64) - t0
    v = back(valid)
    ts = np.where(v, new_t0 + (dur + q) - off, 0.0).astype(np.float32)
    return Pool(type_id=np.concatenate([pool.type_id, back(pool.type_id)]),
                ts=np.concatenate([pool.ts, ts]),
                attr=np.concatenate([pool.attr, back(pool.attr)]),
                valid=np.concatenate([valid, v]), duration=dur,
                ts_quantum=q)


def quantize_ts(ts, valid, t0, duration, q):
    """Each valid timestamp onto the grid of step ``q`` inside its slice
    ``(t0, t0 + duration]``; order within a chunk is kept (ties may
    appear).  Padding stays 0."""
    steps = int(round(duration / q))
    off = np.floor((ts.astype(np.float64) - t0) / q) + 1
    off = np.clip(off, 1, steps)
    return np.where(valid, t0 + off * q, 0.0).astype(np.float32)


def quantize(x, q):
    return (np.round(x.astype(np.float64) / q) * q).astype(np.float32)
