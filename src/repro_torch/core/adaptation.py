"""The ACEP detection-adaptation loop (paper Algorithm 1, §2.2), in PyTorch.

The port of ``repro.core.adaptation``.  It wires together the four
components of Figure 2:

* the **evaluation mechanism** — the order/tree engine (``engine.py``),
  whose plan is an argument, so redeployment never changes a shape;
* the **statistics estimator** — sliding-window rates/selectivities
  (``stats.py``);
* the **optimizer** — a reoptimizing decision function ``D``
  (``decision.py``);
* the **plan generation algorithm** ``A`` — instrumented greedy or ZStream
  (``greedy.py`` / ``zstream.py``), which returns the plan together with the
  deciding-condition sets the invariant policies consume.

Plan migration follows [36] (§2.2): when a new plan is deployed at time
``t_r``, the old plan remains responsible for matches containing at least
one event accepted before ``t_r`` (``min_ts < t_r``) while the new plan
handles matches born entirely after it (``min_ts >= t_r``); the sets are
disjoint, so nothing is detected twice, and the old plan retires at
``t_r + W``.  During the migration window both plans run — the doubled join
work is the *deployment cost* the paper's decision problem tries to
minimize, and it is charged to whichever policy caused the replan.

D and A run on the host; the engine runs on the engine config's device,
and each chunk's counters come back in one device-to-host transfer.
Composite (OR) patterns evaluate as independent branches, each with its own
engine, statistics, planner state and invariants (§5 pattern set 5).
"""

from __future__ import annotations

import dataclasses
import time
from typing import (TYPE_CHECKING, Callable, Iterable, List, Optional,
                    Tuple)

import numpy as np
import torch

if TYPE_CHECKING:  # annotation-only; a runtime import would be circular
    # (data.cep_streams imports core.engine, whose package imports us)
    from ..data.cep_streams import ChunkRecord

from .decision import DecisionPolicy
from .engine import NEG_INF, POS_INF, EngineConfig, OrderEngine, TreeEngine
from .greedy import greedy_order_plan
from .invariants import DCSList
from .patterns import CompositePattern, Pattern
from .plans import OrderPlan, cardinality, plan_cost
from .stats import SlidingWindowEstimator, Stat, sample_selectivities
from .zstream import zstream_tree_plan


def make_planner(kind: str) -> Callable[[Pattern, Stat], Tuple[object, DCSList]]:
    if kind == "greedy":
        return greedy_order_plan
    if kind == "zstream":
        return zstream_tree_plan
    raise ValueError(f"unknown planner {kind!r}")


@dataclasses.dataclass
class RunMetrics:
    """Aggregated measurements for one detection-adaptation run (§5.2)."""

    chunks: int = 0
    events: int = 0
    full_matches: int = 0
    pm_created: int = 0            # partial matches materialized (work)
    overflow: int = 0
    closure_expansions: int = 0
    replans: int = 0               # A invocations triggered by D
    deployments: int = 0           # plan actually changed
    false_positives: int = 0       # D fired but A returned the same plan
    decision_time_s: float = 0.0   # host time spent in D
    plan_time_s: float = 0.0       # host time spent in A
    engine_time_s: float = 0.0     # engine wall time, counter reads included
    migration_chunks: int = 0      # chunks processed under two plans
    condition_checks: int = 0      # elementary checks performed by D
    regret: float = 0.0            # Σ (cost(curr) − cost(opt)) / cost(opt)
    regret_samples: int = 0

    @property
    def adaptation_overhead(self) -> float:
        """Fraction of total accounted time spent deciding + replanning."""
        total = (self.decision_time_s + self.plan_time_s
                 + self.engine_time_s)
        if total <= 0:
            return 0.0
        return (self.decision_time_s + self.plan_time_s) / total


def _counters(res) -> list:
    """A ``StepResult``'s (1,) full_matches, pm_created, overflow and
    closure_expansions, stacked for one transfer."""
    return [res.full_matches, res.pm_created, res.overflow,
            res.closure_expansions]


class AdaptiveRunner:
    """Algorithm 1 for a single (non-composite) pattern."""

    def __init__(
        self,
        pattern: Pattern,
        planner: str = "greedy",
        policy: Optional[DecisionPolicy] = None,
        engine_cfg: EngineConfig = EngineConfig(),
        estimator_buckets: int = 16,
        sel_samples: int = 64,
        measure_regret: bool = False,
        adaptive_caps: bool = False,
        cap_bounds: Tuple[int, int] = (256, 8192),
        seed: int = 0,
    ):
        self.pattern = pattern
        self.planner_kind = planner
        self.planner = make_planner(planner)
        self.policy = policy
        self.engine_cfg = engine_cfg
        self._engine_cls = (OrderEngine if planner == "greedy"
                            else TreeEngine)
        # adaptive_caps: pick the match-set capacity from the plan's own
        # cost model (pow2 bucket) so join work — and hence wall time —
        # tracks plan quality; each bucket is one engine of fixed shapes.
        # Engine state (ring buffers) is cap-independent, so switching
        # buckets preserves detection state.
        self.adaptive_caps = adaptive_caps
        self.cap_bounds = cap_bounds
        self._cap_floor = cap_bounds[0]
        self._engines = {engine_cfg.m_cap: self._engine_cls(
            pattern, engine_cfg)}
        self.engine = self._engines[engine_cfg.m_cap]
        self.estimator = SlidingWindowEstimator(
            pattern.n, num_buckets=estimator_buckets)
        self.sel_samples = sel_samples
        self.measure_regret = measure_regret
        self._rng = np.random.default_rng(seed)
        self._pred_tensors = pattern.pred_tensors()
        self._pos_of_type = {t: p for p, t in enumerate(pattern.type_ids)}

    # -- adaptive capacity selection ---------------------------------------

    def _expected_peak_pm(self, plan, stat: Stat) -> float:
        """Max expected per-step partial matches over one window."""
        w = self.pattern.window
        scaled = Stat(stat.rates * w, stat.sel)
        seq = self.pattern.is_sequence
        if isinstance(plan, OrderPlan):
            groups = [plan.order[:i] for i in range(1, plan.n + 1)]
        else:
            groups = [nd.leaves()
                      for nd in plan.root.internal_nodes_bottom_up()]
        return max(cardinality(scaled, g, seq) for g in groups)

    def _bucket(self, cap: int):
        """The engine of match capacity ``cap``, built on first use with
        the runner's buffer capacity, backend and device."""
        if cap not in self._engines:
            self._engines[cap] = self._engine_cls(
                self.pattern, dataclasses.replace(self.engine_cfg, m_cap=cap))
        return self._engines[cap]

    def _engine_for(self, plan, stat: Stat):
        if not self.adaptive_caps:
            return self.engine
        lo, hi = self.cap_bounds
        want = self._expected_peak_pm(plan, stat) * 2.0  # safety factor
        want = max(want, self._cap_floor)
        cap = 1 << int(np.ceil(np.log2(np.clip(want, lo, hi))))
        return self._bucket(max(cap, self.engine_cfg.b_cap))

    def _escalate(self, engine):
        """Reactive overflow escalation: jump to the next pow2 bucket so
        the cost-model misestimate cannot silently drop matches."""
        cap = min(engine.cfg.m_cap * 2, self.cap_bounds[1] * 4)
        self._cap_floor = cap
        return self._bucket(cap)

    # -- statistics -------------------------------------------------------

    def _observe(self, rec: ChunkRecord) -> None:
        chunk = rec.chunk
        valid = np.asarray(chunk.valid)
        tid = np.asarray(chunk.type_id)[valid]
        attrs = np.asarray(chunk.attr)[valid]
        counts = np.zeros(self.pattern.n)
        for p, t in enumerate(self.pattern.type_ids):
            counts[p] = float((tid == t).sum())
        trials, hits = sample_selectivities(
            self._rng, tid, attrs, self._pred_tensors, self._pos_of_type,
            self.pattern.n, self.sel_samples)
        self.estimator.update(counts, rec.t1 - rec.t0, trials, hits)

    # -- main loop --------------------------------------------------------

    def run(self, stream: Iterable[ChunkRecord]) -> RunMetrics:
        m = RunMetrics()
        state = self.engine.init_state()
        cur_plan = None
        cur_engine = self.engine
        old_plan = None
        old_engine = self.engine
        migration_until = -np.inf
        replan_t = -np.inf

        for rec in stream:
            self._observe(rec)
            stat = self.estimator.snapshot()

            # ---- optimizer: D then (maybe) A ----------------------------
            if cur_plan is None:
                t0 = time.perf_counter()
                cur_plan, dcs = self.planner(self.pattern, stat)
                m.plan_time_s += time.perf_counter() - t0
                cur_engine = self._engine_for(cur_plan, stat)
                if self.policy is not None:
                    self.policy.on_replan(cur_plan, dcs, stat)
            elif self.policy is not None:
                t0 = time.perf_counter()
                fire = self.policy.decide(stat)
                m.decision_time_s += time.perf_counter() - t0
                if fire:
                    t0 = time.perf_counter()
                    new_plan, dcs = self.planner(self.pattern, stat)
                    m.plan_time_s += time.perf_counter() - t0
                    m.replans += 1
                    if new_plan == cur_plan:
                        # A returned the same plan: a false positive of D
                        # (impossible for the invariant policy at d=0 —
                        # Theorem 1; property-tested).
                        m.false_positives += 1
                    else:
                        # A's output *is* the system's best plan for the
                        # current statistics (Alg. 1's "better" check is
                        # subsumed by A-optimality, §2.1) — deploy, with
                        # the [36] migration split.
                        old_plan = cur_plan
                        old_engine = cur_engine
                        cur_plan = new_plan
                        cur_engine = self._engine_for(new_plan, stat)
                        replan_t = rec.t0
                        migration_until = rec.t0 + self.pattern.window
                        m.deployments += 1
                    # Rebase the policy on the fresh DCSs either way.
                    self.policy.on_replan(cur_plan, dcs, stat)

            if self.measure_regret:
                opt_plan, _ = self.planner(self.pattern, stat)
                c_cur = plan_cost(cur_plan, stat, self.pattern.is_sequence)
                c_opt = plan_cost(opt_plan, stat, self.pattern.is_sequence)
                if c_opt > 0:
                    m.regret += max(0.0, (c_cur - c_opt) / c_opt)
                    m.regret_samples += 1

            # ---- evaluation mechanism -----------------------------------
            t_eng = time.perf_counter()
            in_migration = (old_plan is not None
                            and rec.t0 < migration_until)
            if not in_migration:
                old_plan = None

            def process(chunk, pm_extra=0):
                nonlocal state
                if in_migration:
                    # Old plan: matches with >=1 pre-replan event; new
                    # plan: matches born entirely after the replan.
                    state, r_old = old_engine.process_chunk(
                        state, chunk, old_plan, rec.t0, rec.t1,
                        born_lo=NEG_INF, born_hi=replan_t)
                    empty = chunk._replace(
                        valid=np.zeros_like(np.asarray(chunk.valid)))
                    state, r_new = cur_engine.process_chunk(
                        state, empty, cur_plan, rec.t0, rec.t1,
                        born_lo=replan_t, born_hi=POS_INF)
                    both = torch.cat(_counters(r_old)
                                     + _counters(r_new)).tolist()
                    c = [a + b for a, b in zip(both[:4], both[4:])]
                else:
                    state, res = cur_engine.process_chunk(
                        state, chunk, cur_plan, rec.t0, rec.t1)
                    c = torch.cat(_counters(res)).tolist()
                full, pm, ov, cl = c
                return full, pm_extra + pm, ov, cl

            full, pm, ov, cl = process(rec.chunk)
            # Reactive capacity escalation: a capacity overflow may have
            # dropped candidates mid-join, so re-evaluate the window with
            # the next pow2 bucket (events are already ingested; the
            # duplicate join work is charged to pm).  Exactly-once
            # counting is preserved because the recount replaces the
            # truncated one.
            tries = 0
            while ov > 0 and self.adaptive_caps and tries < 4:
                cur_engine = self._escalate(cur_engine)
                if old_plan is not None:
                    old_engine = self._escalate(old_engine)
                empty = rec.chunk._replace(
                    valid=np.zeros_like(np.asarray(rec.chunk.valid)))
                full, pm, ov, cl = process(empty, pm_extra=pm)
                tries += 1
            if in_migration:
                m.migration_chunks += 1
            m.engine_time_s += time.perf_counter() - t_eng

            m.chunks += 1
            m.events += rec.n_events
            m.full_matches += full
            m.pm_created += pm
            m.overflow += ov
            m.closure_expansions += cl

        if self.policy is not None:
            m.condition_checks = self.policy.cost_counter()
        return m


class CompositeAdaptiveRunner:
    """OR-composite pattern: independent branch runners (§5 set 5)."""

    def __init__(self, pattern: CompositePattern, **kw):
        self.runners = [AdaptiveRunner(b, **kw) for b in pattern.branches]

    def run(self, streams: List[Iterable[ChunkRecord]]) -> List[RunMetrics]:
        if len(streams) != len(self.runners):
            raise ValueError("one stream per branch required")
        return [r.run(s) for r, s in zip(self.runners, streams)]


def merge_metrics(ms: List[RunMetrics]) -> RunMetrics:
    out = RunMetrics()
    for f in dataclasses.fields(RunMetrics):
        setattr(out, f.name, sum(getattr(x, f.name) for x in ms))
    return out
