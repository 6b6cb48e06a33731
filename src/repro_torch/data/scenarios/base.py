"""Scenario records: real-workload shapes as deterministic, gated streams.

A ``Scenario`` packages everything the replay harness and the differential
tests need to treat a real-world workload as a regression artifact:

* the pattern(s) in ``P`` DSL form (built lazily, on first use);
* a deterministic per-partition chunk stream (padded ``Chunk``s via
  ``data.cep_streams.emit_chunk``), fully reproducible from
  ``(seed, partition)``;
* the ground-truth drift trajectory — the exact per-chunk true rates and
  attribute means the emitter sampled from, separable from the event noise
  so tests can assert stationarity/drift structurally;
* segment structure (warmup → control → drift) with per-segment gate
  roles, and expected-adaptivity metadata consumed by
  the replay gates (``chip_smoke.py``'s scenarios phase).

The three bundled scenarios (``citibike``, ``flowsense``, ``fraud``) share
one statistical design: the *control* segment keeps the cold-start
(uniform-prior) plan optimal with a wide margin, so a correct invariant
policy must stay silent there (the paper's no-false-positives claim as a
gate), while every *drift* segment inverts the rate order so the pinned
cold plan seeds on the now-dominant type and blows through the match
capacity — the cost adaptivity exists to avoid.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..cep_streams import ChunkRecord, emit_chunk

__all__ = ["Segment", "Scenario", "Trajectory"]

# One trajectory step: (true_rates (n_types,), attr_mean (n_types, n_attrs))
Trajectory = Iterator[Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous run of chunks with one gate role.

    ``gate``:
      * ``"none"``    — warmup: rings fill, compile happens, nothing gated;
      * ``"control"`` — stationary: adaptive sessions must report zero
        replans (false-positive gate);
      * ``"drift"``   — statistics invert: adaptive throughput must be >=
        the pinned-static baseline's (adaptivity-win gate).
    """

    name: str
    n_chunks: int
    gate: str = "none"

    def __post_init__(self):
        if self.gate not in ("none", "control", "drift"):
            raise ValueError(f"unknown segment gate {self.gate!r}")

    @property
    def drifting(self) -> bool:
        return self.gate == "drift"


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One distribution-matched real-workload adapter (see module doc)."""

    name: str
    description: str
    pattern_factory: Callable[[], object]   # () -> P pattern expression
    partitions: int                         # production-shaped K
    n_types: int
    segments: Tuple[Segment, ...]
    trajectory_factory: Callable[[int, int, "Scenario"], Trajectory]
    runtime: Dict[str, object]              # tuned RuntimeConfig kwargs
    expected: Dict[str, object]             # adaptivity metadata (gates)
    chunk_duration: float = 1.0
    chunk_cap: int = 256
    n_attrs: int = 1
    # Nominal event-volume multiplier, tuned per scenario so the drifting
    # segment sits where adaptivity pays: the cold plan's candidates blow
    # through the match capacity while true matches still fit the adapted
    # plan's base shape.  ``stream(rate_scale=...)`` multiplies on top.
    rate_scale: float = 1.0

    # -- structure ----------------------------------------------------------

    @property
    def pattern(self):
        return self.pattern_factory()

    @property
    def n_chunks(self) -> int:
        return sum(s.n_chunks for s in self.segments)

    def segment_slices(self) -> List[Tuple[Segment, int, int]]:
        """``[(segment, start_chunk, stop_chunk), ...]`` in stream order."""
        out, start = [], 0
        for seg in self.segments:
            out.append((seg, start, start + seg.n_chunks))
            start += seg.n_chunks
        return out

    # -- ground truth -------------------------------------------------------

    def trajectory(self, partition: int = 0, *, seed: int = 0,
                   chunks: Optional[int] = None) -> Trajectory:
        """The exact (rates, attr_mean) sequence the emitter will use —
        the scenario's ground-truth drift trajectory, free of event noise.
        """
        it = self.trajectory_factory(partition, seed, self)
        return itertools.islice(it, chunks) if chunks is not None else it

    def drift_trajectory(self, partition: int = 0, *, seed: int = 0,
                         chunks: Optional[int] = None) -> np.ndarray:
        """Stacked true rates, shape ``(n_chunks, n_types)``."""
        return np.stack([r for r, _ in self.trajectory(
            partition, seed=seed, chunks=chunks)])

    # -- event streams ------------------------------------------------------

    def stream(self, partition: int = 0, *, seed: int = 0,
               rate_scale: float = 1.0, chunk_cap: Optional[int] = None,
               chunks: Optional[int] = None) -> Iterator[ChunkRecord]:
        """Deterministic padded chunk stream for one partition.

        The trajectory rng and the event-noise rng are split so the
        ground truth from :meth:`trajectory` matches this stream exactly.
        ``rate_scale`` scales event volume *relative to the scenario's
        nominal* ``self.rate_scale`` without changing the statistics the
        planner sees; ``chunks`` truncates (tests run a short prefix
        through the brute-force oracle).
        """
        cap = self.chunk_cap if chunk_cap is None else int(chunk_cap)
        scale = self.rate_scale * rate_scale
        ev_rng = np.random.default_rng(
            (seed * 1_000_003 + partition * 7919 + 1) % (2 ** 63))
        traj = self.trajectory(partition, seed=seed, chunks=chunks)
        t0 = 0.0
        for rates, attr_mean in traj:
            yield emit_chunk(ev_rng, rates * scale, attr_mean, t0,
                             chunk_duration=self.chunk_duration,
                             chunk_cap=cap, n_attrs=self.n_attrs)
            t0 += self.chunk_duration

    def streams(self, k: Optional[int] = None, **kw
                ) -> List[Iterator[ChunkRecord]]:
        """K per-partition streams (defaults to the scenario's native K),
        in the shape ``Session.run`` accepts directly."""
        k = self.partitions if k is None else int(k)
        return [self.stream(p, **kw) for p in range(k)]

    def segment_streams(self, k: Optional[int] = None, *, seed: int = 0,
                        rate_scale: float = 1.0,
                        chunk_cap: Optional[int] = None,
                        chunks_scale: float = 1.0,
                        ) -> List[Tuple[Segment, List[List[ChunkRecord]]]]:
        """Materialize the stream split by segment: ``[(segment,
        [per-partition chunk lists]), ...]``.

        ``chunks_scale`` stretches every segment's length (the replay
        harness's --quick/full knob); segment boundaries stay aligned with
        the trajectory because scaling happens in the trajectory factory's
        view of the scenario, i.e. here, by re-slicing the same stream.
        """
        k = self.partitions if k is None else int(k)
        lengths = [max(1, int(round(s.n_chunks * chunks_scale)))
                   for s in self.segments]
        scaled = dataclasses.replace(self, segments=tuple(
            dataclasses.replace(s, n_chunks=n)
            for s, n in zip(self.segments, lengths)))
        streams = [scaled.stream(p, seed=seed, rate_scale=rate_scale,
                                 chunk_cap=chunk_cap) for p in range(k)]
        out = []
        for seg, n in zip(scaled.segments, lengths):
            out.append((seg, [list(itertools.islice(s, n))
                              for s in streams]))
        return out
