"""Partitioned fleet executor: K independent streams, one batched plane.

The port of ``repro.core.fleet``, for order and tree plans.  The paper's
adaptation loop (§2.2, Algorithm 1) runs per partition, while the data
plane runs all K partitions through the same calls: every tensor of the
engine leads with the partition axis, each partition carries its own
plan row and its own ``born_lo/born_hi`` migration window, and a replan of
partition ``p`` writes one row of the stacked plan matrix (and, when
device-monitored, one row of the stacked invariant tensors) — never a new
shape.

Two control planes drive it:

* ``FleetRunner`` keeps statistics (``FleetEstimator``) and decision
  policies on the host, fed by Monte-Carlo sampling of the host-side
  chunk arrays;
* ``MonitoredFleetRunner`` keeps the statistics rings on the device and
  verifies each partition's lowered invariant set in the same step that
  joins the chunk, so the host sees only a ``(K,)`` violation-flag vector
  (plus drift) per chunk and syncs the statistics of flagged partitions
  alone.

``MonitoredFleetRunner(superchunk=S)`` runs S chunks per window
(``core.scan``): one captured CUDA graph replay per chunk on the card, no
host sync inside the window; a window in which a flag or an overflow
fires is accepted up to that chunk, as in the reference.

Differential guarantee: every counter equals the JAX package's fleet and
the brute-force oracle (``ref_engine``); see ``tests/test_torch_fleet.py``,
``tests/test_torch_session.py`` and ``tests/test_torch_superchunk.py``.
The device mesh comes in a later slice.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .adaptation import make_planner
from .compat import warn_legacy
from .decision import DecisionPolicy, InvariantPolicy
from .engine import (NEG_INF, POS_INF, Buffers, Chunk, EngineConfig,
                     StepResult, _make_engine, make_monitored_process)
from .invariants import LoweredInvariants, StackedLowered
from .patterns import Pattern
from .plans import OrderPlan, TreePlan
from .stats import (MonitorState, Stat, fleet_monitor_init,
                    sample_selectivities, uniform_stat)

_NEG_INF = NEG_INF
_POS_INF = POS_INF


# ---------------------------------------------------------------------------
# Chunk routing / stacking
# ---------------------------------------------------------------------------


class FleetChunk(NamedTuple):
    """A stacked chunk: every field carries a leading partition axis."""

    chunk: Chunk          # (K, cap) / (K, cap, A) numpy fields
    t0: float
    t1: float
    dropped: int = 0      # events dropped by per-partition capacity


def route_events(
    type_id: np.ndarray,
    ts: np.ndarray,
    attr: np.ndarray,
    keys: np.ndarray,
    k: int,
    cap: int,
) -> Tuple[Chunk, int]:
    """Scatter one keyed event stream into K per-partition padded host
    chunks.

    ``keys`` are arbitrary integer routing keys (tenant/symbol ids); events
    land in partition ``key % k``.  Per-partition overflow beyond ``cap``
    is dropped and counted (the serving layer surfaces it as back-pressure).
    Events within a partition keep their stream order.
    """
    n_attrs = attr.shape[1]
    out_tid = np.full((k, cap), -1, np.int32)
    out_ts = np.zeros((k, cap), np.float32)
    out_attr = np.zeros((k, cap, n_attrs), np.float32)
    out_valid = np.zeros((k, cap), bool)
    part = np.asarray(keys) % k
    dropped = 0
    for p in range(k):
        idx = np.nonzero(part == p)[0]
        m = len(idx)
        if m > cap:
            dropped += m - cap
            idx = idx[:cap]
            m = cap
        out_tid[p, :m] = type_id[idx]
        out_ts[p, :m] = ts[idx]
        out_attr[p, :m] = attr[idx]
        out_valid[p, :m] = True
    return Chunk(out_tid, out_ts, out_attr, out_valid), dropped


def stack_chunks(chunks: Sequence[Chunk]) -> Chunk:
    """Stack K equally-shaped host chunks along a new partition axis."""
    return Chunk(*(np.stack([np.asarray(c[i]) for c in chunks])
                   for i in range(len(Chunk._fields))))


def stacked_streams(streams: Sequence[Iterable]) -> Iterable[FleetChunk]:
    """Zip K ``ChunkRecord`` streams (shared chunk clock) into FleetChunks.

    All streams must tick with the same ``(t0, t1]`` edges (true for
    ``data.cep_streams`` generators built from one ``StreamConfig``).
    """
    for recs in zip(*streams):
        t0s = {r.t0 for r in recs}
        t1s = {r.t1 for r in recs}
        if len(t0s) != 1 or len(t1s) != 1:
            raise ValueError("partition streams disagree on chunk edges")
        yield FleetChunk(stack_chunks([r.chunk for r in recs]),
                         recs[0].t0, recs[0].t1)


# ---------------------------------------------------------------------------
# Fleet engine (batched data plane)
# ---------------------------------------------------------------------------


class FleetEngine:
    """K partitions through one K-batched ``OrderEngine.process`` or
    ``TreeEngine.process``.

    ``kind`` selects the plan family ("order" | "tree").  Plans may differ
    per partition (a stacked row matrix); the pattern and the capacities
    are shared.  Host chunk arrays are moved to the engine's device on each
    call; a plan matrix's device operands (an order matrix's strips, a tree
    matrix's slot program) are built once and cached while the matrix is
    deployed, so a deployed plan costs no host-to-device copy per chunk.
    """

    _OPERANDS_CAP = 8

    def __init__(self, kind: str, pattern: Pattern, k: int,
                 cfg: EngineConfig = EngineConfig(),
                 monitor_laplace: float = 1.0):
        self.base = _make_engine(kind, pattern, cfg)
        self.kind = kind
        self.pattern = pattern
        self.cfg = cfg
        self.k = int(k)
        self.device = self.base.device
        self.monitor_laplace = monitor_laplace
        self._mprocess = None
        self._operands: "OrderedDict[bytes, object]" = OrderedDict()
        self._scans = {}  # superchunk windows keyed by `monitored`

    # -- state -------------------------------------------------------------

    def init_state(self) -> Buffers:
        return self.base.init_state(self.k)

    def init_monitor(self, num_buckets: int = 16) -> MonitorState:
        """Stacked per-partition statistics rings, on the device."""
        return fleet_monitor_init(self.k, self.pattern.n, num_buckets,
                                  self.device)

    # -- plan stacking -----------------------------------------------------

    def plan_row(self, plan) -> np.ndarray:
        """A single plan as its row of the stacked plan matrix: an order
        vector (n,) or a tree's slot program (n-1, 2)."""
        return self.base.plan_row(plan)

    def plans_to_array(self, plans) -> np.ndarray:
        """One plan (broadcast) or a length-K sequence -> (K, n) order rows
        or (K, n-1, 2) slot programs."""
        if isinstance(plans, np.ndarray):
            return plans
        if isinstance(plans, (OrderPlan, TreePlan)):
            plans = [plans] * self.k
        if len(plans) != self.k:
            raise ValueError(f"expected {self.k} plans, got {len(plans)}")
        return np.stack([self.plan_row(p) for p in plans])

    def plan_operands(self, plans):
        rows = np.ascontiguousarray(self.plans_to_array(plans), np.int32)
        key = rows.tobytes()
        ops = self._operands.get(key)
        if ops is None:
            ops = self._operands[key] = self.base.plan_operands(rows)
            while len(self._operands) > self._OPERANDS_CAP:
                self._operands.popitem(last=False)
        else:
            self._operands.move_to_end(key)
        return ops

    # -- execution ---------------------------------------------------------

    def _clock(self, t0, t1, born_lo, born_hi):
        """(t0, t1, born_lo, born_hi) as (K,) f32 tensors — scalars (shared
        clock) or per-partition vectors — in one host-to-device copy."""
        arr = np.stack([np.broadcast_to(np.asarray(v, np.float32), (self.k,))
                        for v in (t0, t1, born_lo, born_hi)])
        return tuple(torch.as_tensor(arr, device=self.device))

    def _chunk(self, chunks: Chunk) -> Chunk:
        return Chunk(*(torch.as_tensor(np.asarray(x), device=self.device)
                       for x in chunks))

    def process_chunk(self, state: Buffers, chunks: Chunk, plans,
                      t0, t1, born_lo=_NEG_INF, born_hi=_POS_INF
                      ) -> Tuple[Buffers, StepResult]:
        """One chunk tick for the whole fleet.

        ``chunks`` fields carry a leading K axis; ``t0/t1/born_*`` may be
        scalars (shared clock) or per-partition ``(K,)`` vectors.  Returns
        the stacked state and a ``StepResult`` of ``(K,)`` counters.
        """
        return self.base.process(
            state, self._chunk(chunks), self.plan_operands(plans),
            *self._clock(t0, t1, born_lo, born_hi))

    def process_chunk_monitored(self, state: Buffers, monitor: MonitorState,
                                chunks: Chunk, plans,
                                lowered: LoweredInvariants,
                                t0, t1, born_lo=_NEG_INF, born_hi=_POS_INF):
        """One fused chunk tick: joins + statistics rings + invariants.

        ``lowered`` carries a leading K axis (``StackedLowered.device()``).
        Returns ``(state, monitor, StepResult, violated (K,), drift (K,),
        rates (K, n), sel (K, n, n))``, all on the device — index a single
        partition of ``rates``/``sel`` before moving it to the host, so
        host transfers stay proportional to violations, not to K.
        """
        if self._mprocess is None:
            self._mprocess = make_monitored_process(
                self.base.process, self.base.spec, self.monitor_laplace)
        return self._mprocess(
            state, monitor, self._chunk(chunks), self.plan_operands(plans),
            lowered, *self._clock(t0, t1, born_lo, born_hi))

    def superchunk_scan(self, monitored: bool):
        """The S-chunks-per-window function (``core.scan``), one per
        (engine, monitored).  Plans and invariants enter as data, so
        replans never capture a new graph; an escalated fleet is another
        engine and captures its own."""
        from .scan import SuperchunkWindow

        if monitored not in self._scans:
            self._scans[monitored] = SuperchunkWindow(self, monitored)
        return self._scans[monitored]


# ---------------------------------------------------------------------------
# Per-partition statistics
# ---------------------------------------------------------------------------


class FleetEstimator:
    """Vectorized per-partition sliding-window estimator (host, numpy).

    The single-stream ``SlidingWindowEstimator`` keeps ring arrays of shape
    ``(buckets, n)``; the fleet version prepends the partition axis so one
    numpy update serves all K partitions.  Snapshots are per-partition
    ``Stat`` views, which the planners and invariant monitors consume
    unchanged.
    """

    def __init__(self, k: int, n: int, num_buckets: int = 16,
                 laplace: float = 1.0):
        self.k, self.n = k, n
        self.num_buckets = num_buckets
        self.laplace = float(laplace)
        self._counts = np.zeros((k, num_buckets, n), np.float64)
        self._durations = np.zeros((k, num_buckets), np.float64)
        self._sel_trials = np.zeros((k, num_buckets, n, n), np.float64)
        self._sel_hits = np.zeros((k, num_buckets, n, n), np.float64)
        self._head = 0
        self._filled = 0

    def update(self, counts: np.ndarray, duration: float,
               sel_trials: Optional[np.ndarray] = None,
               sel_hits: Optional[np.ndarray] = None) -> None:
        """Push one chunk of per-partition observations ((K, n) counts)."""
        h = self._head
        self._counts[:, h] = counts
        self._durations[:, h] = max(float(duration), 1e-9)
        self._sel_trials[:, h] = 0.0 if sel_trials is None else sel_trials
        self._sel_hits[:, h] = 0.0 if sel_hits is None else sel_hits
        self._head = (h + 1) % self.num_buckets
        self._filled = min(self._filled + 1, self.num_buckets)

    def snapshot(self, p: int) -> Stat:
        total_t = self._durations[p].sum() if self._filled else 1.0
        rates = self._counts[p].sum(axis=0) / max(total_t, 1e-9)
        trials = self._sel_trials[p].sum(axis=0)
        hits = self._sel_hits[p].sum(axis=0)
        lp = self.laplace
        sel = (hits + lp) / (trials + 2.0 * lp)
        sel = np.where(trials > 0, sel, 1.0)
        return Stat(rates, sel)

    def snapshots(self) -> List[Stat]:
        return [self.snapshot(p) for p in range(self.k)]


# ---------------------------------------------------------------------------
# Fleet adaptation loop (per-partition control plane)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetMetrics:
    """Aggregated fleet counters plus the per-partition breakdown."""

    chunks: int = 0
    events: int = 0
    full_matches: int = 0
    pm_created: int = 0
    overflow: int = 0
    closure_expansions: int = 0
    neg_rejected: int = 0
    replans: int = 0
    deployments: int = 0
    escalations: int = 0
    migration_partition_chunks: int = 0
    engine_time_s: float = 0.0
    control_time_s: float = 0.0
    violations: int = 0            # device invariant flags fired
    host_syncs: int = 0            # per-partition statistic pulls
    per_partition_matches: Optional[np.ndarray] = None
    per_partition_deployments: Optional[np.ndarray] = None
    last_drift: Optional[np.ndarray] = None  # (K,) §3.4-style margins


def _empty(chunk: Chunk) -> Chunk:
    """The chunk with every event masked out (a recount over the buffers)."""
    return chunk._replace(valid=np.zeros_like(np.asarray(chunk.valid)))


class FleetRunner:
    """Algorithm 1 replicated per partition over one batched data plane.

    Each partition owns its statistics window, its decision policy, its
    current/old plan rows and its [36] migration split; every chunk tick
    runs one fleet call (two while any partition is migrating — the
    doubled pass is the fleet-level deployment cost).
    """

    def __init__(
        self,
        pattern: Pattern,
        k: int,
        planner=None,
        policy_factory=None,
        engine_cfg: EngineConfig = EngineConfig(),
        estimator_buckets: int = 16,
        sel_samples: int = 64,
        laplace: float = 1.0,
        escalate_on_overflow: bool = True,
        max_escalations: int = 4,
        seed: int = 0,
    ):
        if type(self) is FleetRunner:
            warn_legacy("FleetRunner")
        self.pattern = pattern
        self.k = int(k)
        planner = planner or "greedy"
        self.planner_kind = planner
        self.planner = make_planner(planner)
        kind = "order" if planner == "greedy" else "tree"
        self.engine_cfg = engine_cfg
        self.laplace = float(laplace)
        self.fleet = FleetEngine(kind, pattern, k, engine_cfg,
                                 monitor_laplace=laplace)
        # Overflow escalation: a truncated join may have dropped matches,
        # so the chunk is re-evaluated with the next pow2 match-set
        # capacity (shared by the whole fleet).  Escalated engines persist.
        self.escalate_on_overflow = escalate_on_overflow
        self.max_escalations = max_escalations
        self._fleets = {engine_cfg.m_cap: self.fleet}
        self._active_fleet = self.fleet
        self.estimator = FleetEstimator(
            k, pattern.n, num_buckets=estimator_buckets, laplace=laplace)
        self.policies: List[Optional[DecisionPolicy]] = [
            policy_factory() if policy_factory else None for _ in range(k)]
        self.sel_samples = sel_samples
        self._rng = np.random.default_rng(seed)
        self._pred_tensors = pattern.pred_tensors()
        self._pos_of_type = {t: p for p, t in enumerate(pattern.type_ids)}
        # Per-partition control state.
        self.cur_plans: List[Optional[object]] = [None] * k
        self.old_plans: List[Optional[object]] = [None] * k
        self._replan_t = np.full(k, _NEG_INF, np.float64)
        self._migration_until = np.full(k, _NEG_INF, np.float64)
        self._cur_rows: Optional[np.ndarray] = None
        self._old_rows: Optional[np.ndarray] = None
        # Stream carry for run(..., resume=True).
        self._state = None

    # -- statistics --------------------------------------------------------

    def _observe(self, fc: FleetChunk) -> None:
        chunk = fc.chunk
        tid_all = np.asarray(chunk.type_id)
        attr_all = np.asarray(chunk.attr)
        valid_all = np.asarray(chunk.valid)
        n = self.pattern.n
        counts = np.zeros((self.k, n))
        trials = np.zeros((self.k, n, n))
        hits = np.zeros((self.k, n, n))
        for p in range(self.k):
            v = valid_all[p]
            tid = tid_all[p][v]
            attrs = attr_all[p][v]
            for pos, t in enumerate(self.pattern.type_ids):
                counts[p, pos] = float((tid == t).sum())
            trials[p], hits[p] = sample_selectivities(
                self._rng, tid, attrs, self._pred_tensors,
                self._pos_of_type, n, self.sel_samples)
        self.estimator.update(counts, fc.t1 - fc.t0, trials, hits)

    # -- plan bookkeeping --------------------------------------------------

    def _plan_row(self, plan) -> np.ndarray:
        return self.fleet.plan_row(plan)

    def _escalated_fleet(self) -> FleetEngine:
        cap = self._active_fleet.cfg.m_cap * 2
        if cap not in self._fleets:
            self._fleets[cap] = FleetEngine(
                self.fleet.kind, self.pattern, self.k,
                dataclasses.replace(self.engine_cfg, m_cap=cap),
                monitor_laplace=self.laplace)
        return self._fleets[cap]

    def _deploy(self, p: int, new_plan, t0: float, m: FleetMetrics) -> None:
        """Deploy with the [36] migration split: the old plan row keeps
        serving matches born before ``t0``, the new row everything after.

        Deployment also retires any capacity escalation: the blown-up
        match sets belonged to the plan era being replaced, so the fleet
        drops back to its base match capacity (the per-chunk recovery loop
        re-escalates if the new plan still overflows)."""
        self.old_plans[p] = self.cur_plans[p]
        self._old_rows[p] = self._cur_rows[p]
        self.cur_plans[p] = new_plan
        self._cur_rows[p] = self._plan_row(new_plan)
        self._replan_t[p] = t0
        self._migration_until[p] = t0 + self.pattern.window
        self._active_fleet = self.fleet
        m.deployments += 1
        m.per_partition_deployments[p] += 1

    def _fold_lapsed(self, t0: float) -> np.ndarray:
        """Fold partitions whose migration window lapsed back to one row;
        returns the still-migrating mask."""
        lapsed = (self._replan_t > _NEG_INF) & (t0 >= self._migration_until)
        for p in np.nonzero(lapsed)[0]:
            self.old_plans[p] = None
            self._old_rows[p] = self._cur_rows[p]
            self._replan_t[p] = _NEG_INF
        return self._replan_t > _NEG_INF

    def _replan_partition(self, p: int, stat: Stat, t0: float,
                          m: FleetMetrics) -> None:
        policy = self.policies[p]
        if self.cur_plans[p] is None:
            plan, dcs = self.planner(self.pattern, stat)
            self.cur_plans[p] = plan
            self._cur_rows[p] = self._plan_row(plan)
            self._old_rows[p] = self._cur_rows[p]
            if policy is not None:
                policy.on_replan(plan, dcs, stat)
            return
        if policy is None or not policy.decide(stat):
            return
        new_plan, dcs = self.planner(self.pattern, stat)
        m.replans += 1
        if new_plan != self.cur_plans[p]:
            self._deploy(p, new_plan, t0, m)
        policy.on_replan(self.cur_plans[p], dcs, stat)

    # -- engine passes -----------------------------------------------------

    def _counters(self, res: StepResult) -> List[np.ndarray]:
        """The five (K,) counters, in one device-to-host transfer."""
        both = torch.stack(list(res)).cpu().numpy().astype(np.int64)
        return list(both)

    def _pass_b(self, state, fc, out, migrating, chunk):
        """Pass B: old plans over an empty chunk (events already ingested)
        pick up matches born before each partition's replan.  Non-migrating
        partitions have an empty born-window (born_hi = -inf) and
        contribute zero matches; their pm/overflow measure join work
        regardless of the born filter, so they are masked out to avoid
        double-charging the fleet counters."""
        if migrating.any():
            state, res_b = self._active_fleet.process_chunk(
                state, _empty(chunk), self._old_rows, fc.t0, fc.t1,
                born_lo=_NEG_INF,
                born_hi=self._replan_t.astype(np.float32))
            for i, x in enumerate(self._counters(res_b)):
                out[i] += np.where(migrating, x, 0)
        return state, out

    def _plain_passes(self, state, fc, chunk, migrating):
        """Pass A (current plans ingest the chunk; completed matches are
        restricted to those born at/after each partition's replan time, no
        restriction at -inf) followed by pass B while migrating."""
        state, res = self._active_fleet.process_chunk(
            state, chunk, self._cur_rows, fc.t0, fc.t1,
            born_lo=self._replan_t.astype(np.float32), born_hi=_POS_INF)
        return self._pass_b(state, fc, self._counters(res), migrating,
                            chunk)

    def _escalate(self, state, fc, migrating, counters, m: FleetMetrics):
        """Overflow recovery: a truncated join may have dropped matches, so
        re-evaluate the window at the next pow2 capacity (events already
        ingested; the recount replaces the truncated one and the duplicate
        join work is charged to pm)."""
        full, pm, ov, cl, ng = counters
        tries = 0
        while (ov.sum() > 0 and self.escalate_on_overflow
               and tries < self.max_escalations):
            self._active_fleet = self._escalated_fleet()
            m.escalations += 1
            tries += 1
            pm_so_far = pm
            state, (full, pm, ov, cl, ng) = self._plain_passes(
                state, fc, _empty(fc.chunk), migrating)
            pm = pm + pm_so_far
        return state, (full, pm, ov, cl, ng)

    @staticmethod
    def _tally(m: FleetMetrics, fc: FleetChunk, counters) -> None:
        full, pm, ov, cl, ng = counters
        m.chunks += 1
        m.events += int(np.asarray(fc.chunk.valid).sum())
        m.full_matches += int(full.sum())
        m.pm_created += int(pm.sum())
        m.overflow += int(ov.sum())
        m.closure_expansions += int(cl.sum())
        m.neg_rejected += int(ng.sum())
        m.per_partition_matches += full

    # -- main loop ---------------------------------------------------------

    def run(self, fleet_stream: Iterable[FleetChunk],
            resume: bool = False) -> FleetMetrics:
        """Consume a fleet stream through the adaptive loop.

        ``resume=True`` continues the previous ``run``'s stream instead of
        starting a fresh one: ring buffers, estimator windows, deployed
        plans and escalated capacities all carry over, so running a stream
        in segments is equivalent to running it in one call (metrics are
        still per-call).
        """
        m = FleetMetrics(
            per_partition_matches=np.zeros(self.k, np.int64),
            per_partition_deployments=np.zeros(self.k, np.int64))
        state = (self._state if resume and self._state is not None
                 else self.fleet.init_state())
        if self._cur_rows is None:
            probe = self._plan_row(
                self.planner(self.pattern,
                             self.estimator.snapshot(0))[0])
            self._cur_rows = np.tile(probe, (self.k,) + (1,) * probe.ndim)
            self._old_rows = self._cur_rows.copy()
            self.cur_plans = [None] * self.k  # real plans set per partition
        # A policy-free runner is a pinned-plan baseline: nothing consumes
        # the statistics, so skip the host sampling once the cold plans
        # are planted.
        adaptive = any(pol is not None for pol in self.policies)

        for fc in fleet_stream:
            t_ctl = time.perf_counter()
            if adaptive or any(pl is None for pl in self.cur_plans):
                if adaptive:
                    self._observe(fc)
                for p in range(self.k):
                    self._replan_partition(
                        p, self.estimator.snapshot(p), fc.t0, m)
            migrating = self._fold_lapsed(fc.t0)
            m.control_time_s += time.perf_counter() - t_ctl

            t_eng = time.perf_counter()
            pre_fleet = self._active_fleet
            state, counters = self._plain_passes(state, fc, fc.chunk,
                                                 migrating)
            state, counters = self._escalate(state, fc, migrating, counters,
                                             m)
            if migrating.any():
                # A mid-migration overflow is the retiring plan's: recount
                # at escalated capacity, but don't let the old era's shape
                # outlive its migration window.
                self._active_fleet = pre_fleet
                m.migration_partition_chunks += int(migrating.sum())
            m.engine_time_s += time.perf_counter() - t_eng
            self._tally(m, fc, counters)
        self._state = state
        return m


# ---------------------------------------------------------------------------
# Device-monitored fleet loop
# ---------------------------------------------------------------------------


def prime_invariant_policies(pattern: Pattern, planner, policies,
                             caps: Tuple[Optional[int], Optional[int]],
                             device="cuda"):
    """Cold start: plans once from the uniform prior, installs that plan's
    invariant set into every partition's policy, and lowers the rows.
    Caps left as ``None`` default to the cold-start set's exact sizes
    (stat-independent for the greedy planner).  Returns
    ``(plan0, StackedLowered, caps)``.
    """
    stat0 = uniform_stat(pattern.n)
    plan0, dcs0 = planner(pattern, stat0)
    lows = []
    for pol in policies:
        pol.on_replan(plan0, dcs0, stat0)
        lows.append(pol.compile(pattern.n, *caps))
    if caps[0] is None or caps[1] is None:
        caps = (lows[0].active.shape[0], lows[0].scale.shape[-1])
    return plan0, StackedLowered(lows, device=device), caps


def replan_flagged_partition(pattern: Pattern, planner, policy,
                             low: StackedLowered, p: int, stat: Stat,
                             caps) -> object:
    """Violation follow-up for one flagged partition: re-run ``A`` on the
    synced statistics, rebase the policy on the fresh DCSs, and redeploy
    the partition's lowered invariant row.  Returns the new plan."""
    new_plan, dcs = planner(pattern, stat)
    policy.on_replan(new_plan, dcs, stat)
    low.write_row(p, policy.compile(pattern.n, *caps))
    return new_plan


class MonitoredFleetRunner(FleetRunner):
    """FleetRunner with §3 invariant verification fused into the data plane.

    The statistics rings stay on the device (exhaustive, RNG-free
    selectivity observation, ``stats.chunk_observations``); each
    partition's invariant set is lowered into stacked tensors
    (``InvariantPolicy.compile``) and verified in the same step that joins
    the chunk.  Per chunk the host pulls only the ``(K,)`` flag vector,
    the drift and the five counters, and a partition's ``(rates, sel)``
    only when its flag fired.

    Violation-flag contract: flags computed over chunk ``c`` trigger a
    replan that deploys at chunk ``c+1``'s ``t0`` (a deferred replan), with
    the [36] migration split at that ``t0``.

    ``superchunk > 1`` runs that many chunks per window (``core.scan``)
    with the same results; ``in_window_events`` counts the windows cut
    short at an in-window flag or overflow.
    """

    def __init__(self, pattern: Pattern, k: int, planner=None,
                 policy_factory=None,
                 engine_cfg: EngineConfig = EngineConfig(),
                 estimator_buckets: int = 16,
                 max_inv: Optional[int] = None,
                 max_terms: Optional[int] = None,
                 laplace: float = 1.0,
                 escalate_on_overflow: bool = True,
                 max_escalations: int = 4, seed: int = 0,
                 superchunk: int = 1):
        warn_legacy("MonitoredFleetRunner")
        policy_factory = policy_factory or (
            lambda: InvariantPolicy(k=1, d=0.0))
        super().__init__(pattern, k, planner=planner,
                         policy_factory=policy_factory,
                         engine_cfg=engine_cfg,
                         estimator_buckets=estimator_buckets,
                         laplace=laplace,
                         escalate_on_overflow=escalate_on_overflow,
                         max_escalations=max_escalations, seed=seed)
        for pol in self.policies:
            if not isinstance(pol, InvariantPolicy):
                raise TypeError(
                    "device monitoring verifies lowered invariant sets; "
                    "policy_factory must produce InvariantPolicy")
        if superchunk < 1:
            raise ValueError("superchunk must be >= 1")
        self.superchunk = int(superchunk)
        self.in_window_events = 0
        self.monitor_buckets = estimator_buckets
        self._caps = (max_inv, max_terms)
        self._low: Optional[StackedLowered] = None
        # resume carry (alongside FleetRunner._state): monitor rings and
        # the deferred flags of the previous run's final chunk.
        self._monitor = None
        self._pending: Optional[np.ndarray] = None
        self._pend_rates = None
        self._pend_sel = None

    def _prime(self) -> None:
        """Cold start: plan every partition from the uniform prior; real
        statistics arrive with the first chunks and fire the invariants."""
        plan0, self._low, self._caps = prime_invariant_policies(
            self.pattern, self.planner, self.policies, self._caps,
            device=self.fleet.device)
        row0 = self._plan_row(plan0)
        self._cur_rows = np.tile(row0, (self.k,) + (1,) * row0.ndim)
        self._old_rows = self._cur_rows.copy()
        self.cur_plans = [plan0] * self.k

    def _apply_pending(self, pending, rates, sel, t0: float,
                       m: FleetMetrics) -> None:
        """Deferred flag-triggered replans: the planner runs only for
        partitions whose device flag fired on the last processed chunk,
        each costing exactly one statistics sync, so ``violations ==
        host_syncs == replans`` holds by construction."""
        for p in np.nonzero(pending)[0]:
            stat = Stat(rates[p].cpu().numpy().astype(np.float64),
                        sel[p].cpu().numpy().astype(np.float64))
            m.violations += 1
            m.host_syncs += 1
            new_plan = replan_flagged_partition(
                self.pattern, self.planner, self.policies[p],
                self._low, p, stat, self._caps)
            m.replans += 1
            if new_plan != self.cur_plans[p]:
                self._deploy(p, new_plan, t0, m)

    def _carry(self, resume: bool):
        if resume and self._state is not None:
            return (self._state, self._monitor, self._pending,
                    self._pend_rates, self._pend_sel)
        return (self.fleet.init_state(),
                self.fleet.init_monitor(self.monitor_buckets),
                np.zeros(self.k, bool), None, None)

    def _save_carry(self, state, monitor, pending, rates, sel) -> None:
        self._state, self._monitor = state, monitor
        self._pending = pending
        self._pend_rates, self._pend_sel = rates, sel

    def run(self, fleet_stream: Iterable[FleetChunk],
            resume: bool = False) -> FleetMetrics:
        if self.superchunk > 1:
            return self._run_scanned(fleet_stream, resume)
        m = FleetMetrics(
            per_partition_matches=np.zeros(self.k, np.int64),
            per_partition_deployments=np.zeros(self.k, np.int64))
        state, monitor, pending, rates_dev, sel_dev = self._carry(resume)
        if self._low is None:
            self._prime()

        for fc in fleet_stream:
            t_ctl = time.perf_counter()
            self._apply_pending(pending, rates_dev, sel_dev, fc.t0, m)
            pending[:] = False
            migrating = self._fold_lapsed(fc.t0)
            m.control_time_s += time.perf_counter() - t_ctl

            t_eng = time.perf_counter()
            # Pass A, fused: joins + ring update + invariant verification.
            state, monitor, res, violated, drift, rates_dev, sel_dev = \
                self._active_fleet.process_chunk_monitored(
                    state, monitor, fc.chunk, self._cur_rows,
                    self._low.device(), fc.t0, fc.t1,
                    born_lo=self._replan_t.astype(np.float32),
                    born_hi=_POS_INF)
            state, counters = self._pass_b(state, fc, self._counters(res),
                                           migrating, fc.chunk)
            # Escalation recounts run the plain passes so the statistics
            # ring is updated exactly once per chunk.
            pre_fleet = self._active_fleet
            state, counters = self._escalate(state, fc, migrating, counters,
                                             m)
            if migrating.any():
                # Mid-migration overflow: transient recount, not a regime.
                self._active_fleet = pre_fleet
                m.migration_partition_chunks += int(migrating.sum())

            # The rest of the per-chunk host round-trip: flags and drift.
            pending = violated.cpu().numpy().copy()
            m.last_drift = drift.cpu().numpy().astype(np.float32)
            m.engine_time_s += time.perf_counter() - t_eng
            self._tally(m, fc, counters)
        self._save_carry(state, monitor, pending, rates_dev, sel_dev)
        return m

    # -- superchunk (windowed) loop ------------------------------------------

    def _run_scanned(self, fleet_stream: Iterable[FleetChunk],
                     resume: bool = False) -> FleetMetrics:
        """The per-chunk loop above with the host taken out of it.

        Up to ``superchunk`` chunks run per window; flags, drift and
        counters accumulate on the device (``core.scan``).  The host
        surfaces only at window boundaries — or, by cutting the window at
        its first event, right after an in-window invariant flag or
        overflow, so deferred-replan and escalation semantics are
        bit-identical to per-chunk stepping.
        """
        from .scan import first_event, stack_window, window_control

        s_cap = self.superchunk
        m = FleetMetrics(
            per_partition_matches=np.zeros(self.k, np.int64),
            per_partition_deployments=np.zeros(self.k, np.int64))
        state, monitor, pending, pend_rates, pend_sel = self._carry(resume)
        if self._low is None:
            self._prime()
        it = iter(fleet_stream)
        buf: List[FleetChunk] = []
        exhausted = False

        while True:
            while len(buf) < s_cap and not exhausted:
                try:
                    buf.append(next(it))
                except StopIteration:
                    exhausted = True
            if not buf:
                break
            t_ctl = time.perf_counter()
            self._apply_pending(pending, pend_rates, pend_sel, buf[0].t0, m)
            pending[:] = False
            n_en = len(buf)
            ctl = window_control(self._replan_t, self._migration_until,
                                 [fc.t0 for fc in buf], s_cap)
            xs = stack_window([fc.chunk for fc in buf],
                              [fc.t0 for fc in buf],
                              [fc.t1 for fc in buf], ctl, s_cap)
            m.control_time_s += time.perf_counter() - t_ctl

            t_eng = time.perf_counter()
            window = self._active_fleet.superchunk_scan(monitored=True)
            low_dev = self._low.device()
            state2, monitor2, ys = window(state, monitor, self._cur_rows,
                                          self._old_rows, low_dev, xs)
            # One readback of counters, flags and drift; the (S, K, n[, n])
            # statistics stay on the device and are pulled per flagged
            # partition, as per chunk.
            full_h, pm_h, ov_h, cl_h, ng_h, violated_h, drift_h = \
                ys.host(n_en)
            f = first_event(violated_h, ov_h, n_en,
                            self.escalate_on_overflow)
            if f is not None and f < n_en - 1:
                # In-window event: accept chunks [0..f] and continue from
                # the carry after chunk f, so the host can replan /
                # escalate before chunk f+1 runs, exactly as per chunk.
                state2, monitor2 = ys.carry_after(f)
                self.in_window_events += 1
            accept = n_en if f is None else f + 1
            last = accept - 1
            state, monitor = state2, monitor2

            # Commit the host mirrors to the fold state at the last accepted
            # chunk (float64, the per-chunk loop's trajectory, including
            # retiring the lapsed partitions' old plans).
            self._replan_t = ctl.replan_seq[last].copy()
            lapsed = ctl.old_sel[last]
            self._old_rows[lapsed] = self._cur_rows[lapsed]
            for p in np.nonzero(lapsed)[0]:
                self.old_plans[p] = None

            counters = [np.asarray(c, np.int64)
                        for c in (full_h, pm_h, ov_h, cl_h, ng_h)]
            row_l = [c[last].copy() for c in counters]
            pre_fleet = self._active_fleet
            if self.escalate_on_overflow and row_l[2].sum() > 0:
                # Overflow recovery for the event chunk, as per chunk: a
                # recount at the next pow2 match capacity from the
                # post-chunk state; the escalated fleet persists for the
                # following windows.
                state, row_l = self._escalate(
                    state, buf[last], ctl.migrating[last], row_l, m)
            if ctl.migrating[last].any():
                # Mid-migration overflow: transient recount, not a regime.
                self._active_fleet = pre_fleet

            for s in range(accept):
                row = row_l if s == last else [c[s] for c in counters]
                self._tally(m, buf[s], row)
            m.migration_partition_chunks += int(ctl.migrating[:accept].sum())
            m.last_drift = np.asarray(drift_h[last], np.float32)
            pending = np.asarray(violated_h[last]).copy()
            # Device slices of the window's outputs (not a graph's output
            # buffers, which the next replay overwrites).
            pend_rates = ys.rates[last]
            pend_sel = ys.sel[last]
            m.engine_time_s += time.perf_counter() - t_eng
            buf = buf[accept:]
        self._save_carry(state, monitor, pending, pend_rates, pend_sel)
        return m
