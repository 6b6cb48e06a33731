"""The CEP runtime facade of the port: one ``Session``, everything else
config.

    session = cep.open(pattern, partitions=K,
                       plan="order" | "tree" | "auto",
                       monitor=True | False,
                       config=RuntimeConfig(device="cuda", ...))
    telemetry = session.run(streams)

* ``partitions``: K = 1 is a fleet of one — the data plane is always the
  K-batched fleet executor.
* ``plan``: the plan family — "order" (greedy planner, order engine),
  "tree" (ZStream planner, tree engine) or "auto", which compares the two
  planners' cold-start costs under the uniform prior, exactly as the JAX
  package does, and runs the cheaper.  Monitored tree sessions need
  explicit ``max_invariants``/``max_terms`` (the ZStream invariant set's
  size depends on the statistics).
* ``monitor``: ``False`` keeps the decision policy on the host (statistics
  sampled per chunk), ``True`` fuses the statistics rings and lowered
  invariant sets into the device step (host work ∝ violations).

Two control planes hang off one session, both driving the same data
plane:

* **Batch** — ``run(stream)`` consumes a chunk stream through the adaptive
  loop (Algorithm 1 per partition) and returns a ``Telemetry``.
* **Incremental** — ``process(...)`` / ``step(...)`` /
  ``step_superchunk(...)`` / ``deploy(...)`` advance the session one keyed
  batch or pre-stacked chunk at a time (serving style: immediate plan
  swaps, cumulative counters).

``superchunk=S`` runs S chunks per window on either plane (``core.scan``:
on CUDA a captured graph replayed per chunk, no host sync inside the
window), with results bit-identical to per-chunk stepping.

OR-composites (``P.or_``) decompose into one sub-session per branch;
counters aggregate as per-branch sums and ``telemetry().branches`` keeps
the breakdown.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.adaptation import make_planner
from ..core.compat import legacy_ok
from ..core.engine import Chunk
from ..core.fleet import (FleetChunk, FleetMetrics, FleetRunner,
                          MonitoredFleetRunner, stack_chunks, stacked_streams)
from ..core.patterns import CompositePattern, Pattern
from ..core.plans import plan_cost
from ..core.stats import uniform_stat
from ..data.cep_streams import ChunkRecord
from ..serving.engine import (CEPFleetServingEngine,
                              MonitoredCEPFleetServingEngine)
from .config import RuntimeConfig
from .dsl import as_pattern

__all__ = ["Session", "Telemetry", "open"]

_COUNTERS = (
    "chunks", "events", "matches", "replans", "deployments", "violations",
    "host_syncs", "overflow", "dropped", "neg_rejected",
    "closure_expansions", "escalations", "migration_partition_chunks",
)


@dataclasses.dataclass
class Telemetry:
    """Uniform counter snapshot across both control planes.

    ``matches`` is the exactly-once full-match total (summed over branches
    for OR-composites); ``per_partition_matches`` keeps the (K,) split.
    ``violations``/``host_syncs`` are nonzero only for monitored sessions;
    ``dropped`` counts keyed-batch routing overflow (back-pressure).
    ``events`` is maintained by ``run`` and ``process`` — ``step`` skips
    it to avoid a per-tick count of the valid mask.
    """

    partitions: int = 1
    chunks: int = 0
    events: int = 0
    matches: int = 0
    per_partition_matches: Optional[np.ndarray] = None
    replans: int = 0
    deployments: int = 0
    violations: int = 0
    host_syncs: int = 0
    overflow: int = 0
    dropped: int = 0
    neg_rejected: int = 0
    closure_expansions: int = 0
    escalations: int = 0
    migration_partition_chunks: int = 0
    engine_time_s: float = 0.0
    control_time_s: float = 0.0
    last_drift: Optional[np.ndarray] = None
    branches: Optional[Tuple["Telemetry", ...]] = None

    def merge(self, other: "Telemetry") -> "Telemetry":
        """Accumulate ``other`` into self (counters add, arrays add)."""
        for f in _COUNTERS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.engine_time_s += other.engine_time_s
        self.control_time_s += other.control_time_s
        if other.per_partition_matches is not None:
            if self.per_partition_matches is None:
                self.per_partition_matches = np.zeros(
                    other.per_partition_matches.shape, np.int64)
            self.per_partition_matches = (
                self.per_partition_matches + other.per_partition_matches)
        if other.last_drift is not None:
            self.last_drift = other.last_drift
        return self


def _from_fleet_metrics(m: FleetMetrics, k: int) -> Telemetry:
    return Telemetry(
        partitions=k,
        chunks=m.chunks,
        events=m.events,
        matches=m.full_matches,
        per_partition_matches=(None if m.per_partition_matches is None
                               else m.per_partition_matches.copy()),
        replans=m.replans,
        deployments=m.deployments,
        violations=m.violations,
        host_syncs=m.host_syncs,
        overflow=m.overflow,
        neg_rejected=m.neg_rejected,
        closure_expansions=m.closure_expansions,
        escalations=m.escalations,
        migration_partition_chunks=m.migration_partition_chunks,
        engine_time_s=m.engine_time_s,
        control_time_s=m.control_time_s,
        last_drift=(None if m.last_drift is None else m.last_drift.copy()),
    )


# ---------------------------------------------------------------------------
# Stream normalization
# ---------------------------------------------------------------------------


Stream = Union[Iterable[ChunkRecord], Iterable[FleetChunk],
               Sequence[Iterable[ChunkRecord]]]


def _wrap_single(records: Iterable[ChunkRecord]) -> Iterable[FleetChunk]:
    for r in records:
        yield FleetChunk(stack_chunks([r.chunk]), r.t0, r.t1)


def _normalize_stream(stream: Stream, k: int) -> Iterable[FleetChunk]:
    """Accept the three natural stream shapes and yield ``FleetChunk``s.

    * an iterable of ``ChunkRecord`` (single-partition session, K = 1);
    * an iterable of ``FleetChunk`` (already stacked);
    * a sequence of K per-partition ``ChunkRecord`` iterables (zipped on a
      shared chunk clock, as ``core.fleet.stacked_streams``).
    """
    if isinstance(stream, (list, tuple)) and stream \
            and not isinstance(stream[0], (ChunkRecord, FleetChunk)):
        if len(stream) != k:
            raise ValueError(
                f"got {len(stream)} partition streams for {k} partitions")
        return stacked_streams(stream)
    it = iter(stream)
    try:
        first = next(it)
    except StopIteration:
        return iter(())
    rest = itertools.chain([first], it)
    if isinstance(first, FleetChunk):
        return rest
    if isinstance(first, ChunkRecord):
        if k != 1:
            raise ValueError(
                "a bare ChunkRecord stream feeds a single partition; pass "
                f"{k} per-partition streams (or FleetChunks) for K={k}")
        return _wrap_single(rest)
    raise TypeError(f"cannot interpret stream element "
                    f"{type(first).__name__} as chunked input")


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------


def _resolve_plan_kind(pattern: Pattern, plan: str) -> str:
    if plan in ("order", "tree"):
        return plan
    if plan != "auto":
        raise ValueError(f"plan must be 'order', 'tree' or 'auto'; "
                         f"got {plan!r}")
    stat0 = uniform_stat(pattern.n)
    order_plan, _ = make_planner("greedy")(pattern, stat0)
    tree_plan, _ = make_planner("zstream")(pattern, stat0)
    c_order = plan_cost(order_plan, stat0, pattern.is_sequence)
    c_tree = plan_cost(tree_plan, stat0, pattern.is_sequence)
    return "order" if c_order <= c_tree else "tree"


class Session:
    """One CEP runtime: pattern + partitions + plan family + monitoring.

    Construct via :func:`repro_torch.cep.open`.  The session is lazy: the
    incremental serving plane (fleet state, plan matrix, monitor rings) is
    built on first ``process``/``step``/``deploy``; ``run`` spins up a
    fresh adaptive loop per call (or continues the last one with
    ``resume=True``) and folds its metrics into the session telemetry.
    """

    def __init__(self, pattern, *, partitions: int = 1, plan: str = "auto",
                 monitor: bool = False,
                 config: Optional[RuntimeConfig] = None):
        self.config = config or RuntimeConfig()
        self.config.validate(monitor=bool(monitor),
                             partitions=int(partitions))
        self.k = int(partitions)
        self.monitor = bool(monitor)
        self.pattern = as_pattern(pattern)
        self._tel = Telemetry(partitions=self.k)
        if isinstance(self.pattern, CompositePattern):
            self.branches: Tuple["Session", ...] = tuple(
                Session(b, partitions=partitions, plan=plan, monitor=monitor,
                        config=self.config) for b in self.pattern.branches)
            self.plan_kind: Union[str, Tuple[str, ...]] = tuple(
                b.plan_kind for b in self.branches)
            self._serving = None
            return
        self.branches = ()
        self.plan_kind = _resolve_plan_kind(self.pattern, plan)
        self.planner_name = ("greedy" if self.plan_kind == "order"
                             else "zstream")
        self._serving: Optional[CEPFleetServingEngine] = None
        self._runner = None  # batch-plane runner, kept for run(resume=True)

    @property
    def is_composite(self) -> bool:
        return bool(self.branches)

    def _make_runner(self):
        cfg = self.config
        common = dict(
            planner=self.planner_name,
            policy_factory=cfg.policy_factory(),
            engine_cfg=cfg.engine(),
            estimator_buckets=cfg.estimator_buckets,
            laplace=cfg.laplace,
            escalate_on_overflow=cfg.escalate_on_overflow,
            max_escalations=cfg.max_escalations,
            seed=cfg.seed,
            mesh=cfg.mesh,
        )
        with legacy_ok():
            if self.monitor:
                return MonitoredFleetRunner(
                    self.pattern, self.k, max_inv=cfg.max_invariants,
                    max_terms=cfg.max_terms, superchunk=cfg.superchunk,
                    **common)
            cfg.require_device_control(self.monitor)
            return FleetRunner(self.pattern, self.k,
                               sel_samples=cfg.sel_samples, **common)

    def run(self, stream: Stream, *, resume: bool = False) -> Telemetry:
        """Consume a chunk stream through the adaptive loop (Algorithm 1
        per partition) and return this run's ``Telemetry``.

        ``resume=True`` continues the previous ``run``'s stream rather
        than starting a fresh one: ring buffers, estimator/monitor
        windows, deployed plans and pending invariant flags carry over,
        so replaying a stream segment by segment is equivalent to one
        continuous ``run``.
        """
        if self.is_composite:
            chunks = list(_normalize_stream(stream, self.k))
            parts = [b.run(chunks, resume=resume) for b in self.branches]
            tel = Telemetry(partitions=self.k)
            for p in parts:
                tel.merge(p)
            # chunks/events are shared input, not per-branch work
            tel.chunks = parts[0].chunks if parts else 0
            tel.events = parts[0].events if parts else 0
            tel.branches = tuple(parts)
            self._tel.merge(dataclasses.replace(tel, branches=None))
            return tel
        if not (resume and self._runner is not None):
            self._runner = self._make_runner()
        metrics = self._runner.run(_normalize_stream(stream, self.k),
                                   resume=resume)
        tel = _from_fleet_metrics(metrics, self.k)
        self._tel.merge(tel)
        return tel

    # -- incremental (serving) control plane --------------------------------

    def _ensure_serving(self) -> CEPFleetServingEngine:
        if self._serving is None:
            cfg = self.config
            with legacy_ok():
                if self.monitor:
                    self._serving = MonitoredCEPFleetServingEngine(
                        self.pattern, self.k, engine_cfg=cfg.engine(),
                        kind=self.plan_kind, chunk_cap=cfg.chunk_capacity,
                        planner=self.planner_name, policy_kw=cfg.policy_kw,
                        monitor_buckets=cfg.estimator_buckets,
                        max_inv=cfg.max_invariants, max_terms=cfg.max_terms,
                        laplace=cfg.laplace, superchunk=cfg.superchunk,
                        mesh=cfg.mesh)
                else:
                    plan0, _ = make_planner(self.planner_name)(
                        self.pattern, uniform_stat(self.pattern.n))
                    self._serving = CEPFleetServingEngine(
                        self.pattern, self.k, plan0, cfg.engine(),
                        self.plan_kind, cfg.chunk_capacity,
                        laplace=cfg.laplace, superchunk=cfg.superchunk,
                        mesh=cfg.mesh)
        return self._serving

    def step(self, chunk: Chunk, t0: float, t1: float) -> np.ndarray:
        """Advance the fleet one tick over an already-stacked chunk.

        ``chunk`` fields carry a leading K axis (a bare single-partition
        ``Chunk`` is accepted when K = 1).  Returns this tick's
        per-partition full-match counts.  Monitored sessions also run the
        violation → sync → replan → row-deploy loop inside the call.
        ``telemetry().events`` is not updated here; use ``process``/``run``
        when event totals matter.
        """
        if self.is_composite:
            self._tel.chunks += 1
            return sum(b.step(chunk, t0, t1) for b in self.branches)
        eng = self._ensure_serving()
        if np.ndim(chunk.type_id) == 1:
            if self.k != 1:
                raise ValueError("unstacked chunk on a multi-partition "
                                 "session; stack K per-partition chunks")
            chunk = stack_chunks([chunk])
        self._tel.chunks += 1
        return eng.process_chunk(chunk, float(t0), float(t1))

    def step_superchunk(self, chunks: Sequence[Chunk],
                        edges: Sequence[Tuple[float, float]]) -> np.ndarray:
        """Advance the fleet over a sequence of stacked chunks with
        ``config.superchunk`` chunks per window.

        Equal to looping :meth:`step` (a monitored session cuts a window
        at a mid-window flag, so replans still deploy on the very next
        chunk); the host reads back once per window instead
        of once per chunk.  Returns the per-chunk ``(len(chunks), K)``
        full-match counts.  Like ``step``, event totals are not kept.
        """
        if self.is_composite:
            self._tel.chunks += len(chunks)
            return sum(b.step_superchunk(chunks, edges)
                       for b in self.branches)
        eng = self._ensure_serving()
        self._tel.chunks += len(chunks)
        return eng.process_superchunk(chunks, edges)

    def process(self, type_id, ts, attr, keys, t0: float,
                t1: float) -> np.ndarray:
        """Route one keyed event batch (``key % K``) covering ``(t0, t1]``
        and tick the fleet once; returns per-partition match counts."""
        if self.is_composite:
            self._tel.chunks += 1
            self._tel.events += int(len(np.asarray(type_id)))
            return sum(b.process(type_id, ts, attr, keys, t0, t1)
                       for b in self.branches)
        eng = self._ensure_serving()
        self._tel.chunks += 1
        self._tel.events += int(len(np.asarray(type_id)))
        return eng.process_batch(type_id, ts, attr, keys,
                                 float(t0), float(t1))

    def deploy(self, partition: int, plan) -> None:
        """Deploy an evaluation plan for one partition: a stacked-matrix
        row write, never a new shape (§2.2 cheap deployment).

        On a monitored session the partition's invariant row keeps
        guarding the last *planner* output; a later violation re-runs the
        planner and overrides the manual plan."""
        if self.is_composite:
            raise ValueError("deploy on a composite session is ambiguous; "
                             "use session.branches[i].deploy(...)")
        self._ensure_serving().deploy_plan(partition, plan)
        self._tel.deployments += 1

    def reset(self) -> None:
        """Clear stream state (ring buffers, monitor rings, counters) while
        keeping deployed plans."""
        if self.is_composite:
            for b in self.branches:
                b.reset()
        else:
            if self._serving is not None:
                self._serving.reset()
            self._runner = None  # next run(resume=True) starts fresh
        self._tel = Telemetry(partitions=self.k)

    # -- telemetry ----------------------------------------------------------

    def _serving_telemetry(self) -> Telemetry:
        eng = self._serving
        tel = Telemetry(partitions=self.k)
        if eng is None:
            return tel
        tel.matches = int(eng.matches.sum())
        tel.per_partition_matches = eng.matches.copy()
        tel.overflow = int(eng.overflow.sum())
        tel.neg_rejected = int(eng.neg_rejected.sum())
        tel.closure_expansions = int(eng.closure_expansions.sum())
        tel.dropped = int(eng.dropped)
        if self.monitor:
            tel.violations = int(eng.violations.sum())
            tel.replans = int(eng.replans.sum())
            tel.host_syncs = int(eng.host_syncs)
            tel.last_drift = eng.last_drift.copy()
        return tel

    def telemetry(self) -> Telemetry:
        """Cumulative session telemetry across both control planes."""
        if self.is_composite:
            parts = tuple(b.telemetry() for b in self.branches)
            tel = Telemetry(partitions=self.k)
            for p in parts:
                tel.merge(p)
            # Shared input is counted once by the composite itself (run,
            # step, and process all maintain self._tel), not per branch.
            tel.chunks = self._tel.chunks
            tel.events = self._tel.events
            tel.branches = parts
            return tel
        tel = Telemetry(partitions=self.k)
        tel.merge(self._tel)
        tel.merge(self._serving_telemetry())
        return tel


def open(pattern, *, partitions: int = 1, plan: str = "auto",
         monitor: bool = False,
         config: Optional[RuntimeConfig] = None,
         superchunk: Optional[int] = None,
         mesh=None) -> Session:
    """Open a CEP session — the single entry point to the port's runtime.

    Parameters
    ----------
    pattern:    a ``P.seq``/``P.and_``/``P.or_`` builder, a ``Pattern``, or
                a ``CompositePattern``.
    partitions: K independent stream partitions sharing one batched data
                plane (K = 1 is a fleet of one).
    plan:       "order" (left-deep permutations, greedy planner), "tree"
                (ZStream-style join trees, dynamic-programming planner),
                or "auto" (the cheaper cold-start cost under the uniform
                prior).
    monitor:    ``True`` fuses statistics rings + lowered invariant
                verification into the device step; ``False`` evaluates the
                decision policy on the host each chunk.
    config:     a :class:`RuntimeConfig`; ``config.device`` (default
                "cuda") places the data plane.
    superchunk: convenience override of ``config.superchunk`` — chunks
                per window; the host syncs/replans only at window
                boundaries (or at an invariant flag), with detection,
                flags and replan points bit-identical to per-chunk
                stepping.
    mesh:       convenience override of ``config.mesh`` — shard the
                K-partition axis over devices (``"auto"``, an int count,
                or a ``distributed.CepMesh`` with a ``"cep"`` axis; one
                device until the multi-GPU split lands, ROADMAP.md).
    """
    config = config or RuntimeConfig()
    overrides = {}
    if superchunk is not None:
        overrides["superchunk"] = int(superchunk)
    if mesh is not None:
        overrides["mesh"] = mesh
    if overrides:
        config = dataclasses.replace(config, **overrides)
    return Session(pattern, partitions=partitions, plan=plan,
                   monitor=monitor, config=config)
