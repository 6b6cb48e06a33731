"""Continuous-batching LM scheduler and the time-sliced keyed-event
router feeding the port's CEP fleet (the port of
``repro.serving.scheduler``).

LM requests queue per length-class (pow2 prompt buckets).  Each scheduling
tick the scheduler fills free batch slots following the current
``BatchPlan``'s class priority (``adaptive.batching``), prefills the
admitted prompts, then advances the whole batch one decode step.  The
batch plan is re-generated only when a class-rate invariant is violated —
a rate flip between short and long prompt classes re-orders admission.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..adaptive.batching import AdaptiveBatchPlanner
from .engine import CEPFleetServingEngine, ServingEngine


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class Scheduler:
    def __init__(self, engine: ServingEngine, class_tokens: List[int],
                 *, d: float = 0.15):
        self.engine = engine
        self.class_tokens = class_tokens
        self.planner = AdaptiveBatchPlanner(
            class_tokens, token_budget=engine.batch_slots * 64, d=d)
        self.queues: Dict[int, List[Request]] = {
            i: [] for i in range(len(class_tokens))}
        self.slots: List[Optional[Request]] = \
            [None] * engine.batch_slots
        self.completed: List[Request] = []
        self._tick_counts = np.zeros(len(class_tokens))

    def _class_of(self, plen: int) -> int:
        for i, t in enumerate(self.class_tokens):
            if plen <= t:
                return i
        return len(self.class_tokens) - 1

    def submit(self, req: Request) -> None:
        c = self._class_of(len(req.prompt))
        self.queues[c].append(req)
        self._tick_counts[c] += 1

    def tick(self) -> int:
        """One scheduling round: replan-if-needed, admit, decode."""
        self.planner.observe(self._tick_counts)
        self._tick_counts[:] = 0
        plan = self.planner.plan

        # Admit requests into free slots in plan order.
        free = [i for i, r in enumerate(self.slots) if r is None]
        order = plan.order if plan else range(len(self.class_tokens))
        for c in order:
            while free and self.queues[c]:
                req = self.queues[c].pop(0)
                slot = free.pop(0)
                first = self.engine.prefill_one(req.prompt, slot)
                req.out.append(first)
                req.slot = slot
                self.slots[slot] = req

        # One decode step for every occupied slot.
        tokens = np.zeros(self.engine.batch_slots, np.int32)
        active = False
        for i, r in enumerate(self.slots):
            if r is not None:
                tokens[i] = r.out[-1]
                active = True
        if active:
            nxt = self.engine.decode(tokens)
            for i, r in enumerate(self.slots):
                if r is None:
                    continue
                r.out.append(int(nxt[i]))
                if r.done:
                    self.completed.append(r)
                    self.engine.reset_slot(i)
                    self.slots[i] = None
        return sum(r is not None for r in self.slots)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())


class CEPStreamRouter:
    """Time-sliced router feeding keyed events into the CEP fleet.

    Producers ``submit`` events tagged with an integer routing key (tenant
    / symbol id); each ``tick`` closes the current time slice ``(t0, t1]``,
    routes the buffered events to their partitions (``key % K``) and
    advances the whole fleet with one fleet step.  Events with
    timestamps past the current slice stay queued for later ticks, so an
    out-of-order producer is tolerated as long as the event arrives before
    its own slice closes.  Events submitted *after* their slice closed
    (``ts <= t0``) can never be counted exactly-once by the engine's
    latest-event rule, so they are dropped and surfaced in
    ``late_dropped`` rather than silently routed into a slice that will
    ignore the matches they complete.

    The router is engine-agnostic: hand it a plain
    ``CEPFleetServingEngine`` (static plans, ``deploy_plan`` driven by an
    external control loop) or a ``MonitoredCEPFleetServingEngine``, in
    which case every ``tick`` also verifies the per-partition invariant
    sets on device and self-replans flagged partitions; adaptation
    telemetry is then available via ``monitor_telemetry``.
    """

    def __init__(self, engine: CEPFleetServingEngine,
                 slice_duration: float = 1.0, t_start: float = 0.0):
        self.engine = engine
        self.slice_duration = float(slice_duration)
        self.t0 = float(t_start)
        self._tid: List[int] = []
        self._ts: List[float] = []
        self._attr: List[np.ndarray] = []
        self._keys: List[int] = []
        self.slices = 0
        self.late_dropped = 0
        self.routed = 0

    def submit(self, key: int, type_id: int, ts: float,
               attr: np.ndarray) -> None:
        self._keys.append(int(key))
        self._tid.append(int(type_id))
        self._ts.append(float(ts))
        self._attr.append(np.asarray(attr, np.float32))

    @property
    def pending(self) -> int:
        return len(self._ts)

    def monitor_telemetry(self) -> Optional[dict]:
        """Adaptation counters when the engine is device-monitored:
        ``{violations, replans, host_syncs, last_drift}``; None otherwise.
        """
        if not hasattr(self.engine, "violations"):
            return None
        return {
            "violations": self.engine.violations.copy(),
            "replans": self.engine.replans.copy(),
            "host_syncs": self.engine.host_syncs,
            "last_drift": self.engine.last_drift.copy(),
        }

    def _slice_batch(self, ts, idx):
        """Materialize one slice's ``(tid, ts, attr, keys)`` arrays."""
        tid = np.asarray(self._tid, np.int32)[idx]
        n_attrs = self.engine.fleet.pattern.n_attrs
        attr = (np.stack([self._attr[i] for i in idx])
                if len(idx) else np.zeros((0, n_attrs), np.float32))
        keys = np.asarray(self._keys, np.int64)[idx] if len(idx) \
            else np.zeros(0, np.int64)
        self.routed += len(idx)
        return tid, ts[idx], attr, keys

    def _retain(self, keep) -> None:
        self._tid = [self._tid[i] for i in keep]
        self._ts = [self._ts[i] for i in keep]
        self._attr = [self._attr[i] for i in keep]
        self._keys = [self._keys[i] for i in keep]

    def tick(self) -> np.ndarray:
        """Close one slice; returns per-partition match counts for it."""
        t1 = self.t0 + self.slice_duration
        ts = np.asarray(self._ts, np.float32)
        late = ts <= self.t0
        self.late_dropped += int(late.sum())
        take = (ts > self.t0) & (ts <= t1)
        idx = np.nonzero(take)[0]
        keep = np.nonzero(~take & ~late)[0]
        tid, tss, attr, keys = self._slice_batch(ts, idx)
        full = self.engine.process_batch(tid, tss, attr, keys, self.t0, t1)
        self._retain(keep)
        self.t0 = t1
        self.slices += 1
        return full

    def tick_superchunk(self, n: int) -> np.ndarray:
        """Close ``n`` consecutive slices through the superchunk window.

        Returns the ``(n, K)`` per-slice match counts.  Drop accounting is
        *identical* to ``n`` sequential :meth:`tick` calls: an event older
        than the first slice is late exactly once, an event inside slice
        ``j`` routes to slice ``j`` (capacity drops land in
        ``engine.dropped`` per slice, same as per-tick routing), and an
        event past the last slice stays queued.  Slice edges are produced
        by the same repeated addition as sequential ticks so boundary
        comparisons are bit-identical — an event on a slice edge lands in
        the same slice either way.
        """
        if n < 1:
            raise ValueError("tick_superchunk needs n >= 1")
        edges = []
        t0 = self.t0
        for _ in range(n):
            t1 = t0 + self.slice_duration
            edges.append((t0, t1))
            t0 = t1
        ts = np.asarray(self._ts, np.float32)
        late = ts <= self.t0
        self.late_dropped += int(late.sum())
        future = ts > edges[-1][1]
        keep = np.nonzero(future & ~late)[0]
        chunks = []
        for e0, e1 in edges:
            idx = np.nonzero((ts > e0) & (ts <= e1))[0]
            chunks.append(self.engine.route(*self._slice_batch(ts, idx)))
        full = self.engine.process_superchunk(chunks, edges)
        self._retain(keep)
        self.t0 = edges[-1][1]
        self.slices += n
        return full
