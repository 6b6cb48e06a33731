"""Batched serving engines of the port: LM prefill/decode and the CEP
fleet fronts.

``ServingEngine`` (the port of ``repro.serving.engine.ServingEngine``)
wraps ``Model.prefill`` / ``Model.decode_step`` with a fixed batch
capacity.  Requests occupy batch *slots*; finished slots are refilled by
the scheduler (slot state is data).  Per-request cache write indices
support heterogeneous positions in one batch, so one decode step serves
any request mix.  It runs eagerly on the device: a prompt is bucketed to
a power of two as in the reference, whose buckets key its compiled
programs.

The CEP serving fronts: K stream partitions, one batched fleet, keyed
batches in, per-partition match counts out.  ``CEPFleetServingEngine``
owns the stacked ring-buffer state and the per-partition plan rows; a
keyed event batch is routed by ``key % K`` into a stacked per-partition
chunk and the whole fleet advances with one fleet step.  Deploying a plan
for a partition writes one row of the plan matrix — never a new shape.

``MonitoredCEPFleetServingEngine`` adds the device-resident control loop:
statistics rings and lowered invariant sets ride in the same step, the
host reads back a ``(K,)`` flag vector and the drift, and a flagged
partition is re-planned from its synced device statistics before the next
batch — host work is O(violations), not O(K·stats).

``process_superchunk`` runs S chunks per window (``core.scan``): on the
card one captured CUDA graph replay per chunk and one readback per window;
the monitored front cuts a window at a mid-window flag, so it equals
looping ``process_chunk``.  Both fronts take ``mesh=`` (the fleet's
``cep`` device mesh).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.adaptation import make_planner
from ..core.compat import warn_legacy
from ..core.decision import InvariantPolicy
from ..core.engine import EngineConfig, canonical_device, resolve_device
from ..core.fleet import (FleetEngine, prime_invariant_policies,
                          replan_flagged_partition, route_events)
from ..core.patterns import Pattern
from ..core.stats import Stat
from ..models.config import ModelConfig
from ..models.model import Cache, Model
from ..models.params import load_params


class ServingEngine:
    """LM prefill and decode over ``batch_slots`` request slots.

    ``params`` is the port's ``Model`` (on ``device``) or a reference
    parameter pytree, which is loaded into a new ``Model`` on ``device``.
    The engine owns its cache and updates a slot in place when a prompt
    is prefilled into it.  ``last_logits`` holds the logits of the last
    ``prefill_one`` ((V,)) or ``decode`` ((slots, V)), on the device.
    """

    def __init__(self, cfg: ModelConfig, params, batch_slots: int,
                 cache_len: int, device="cuda"):
        dev = resolve_device(device)
        if isinstance(params, Model):
            if canonical_device(params.device) != canonical_device(dev):
                raise ValueError(f"model on {params.device}, engine asked "
                                 f"for {dev}")
            self.model = params
        else:
            self.model = Model(cfg, dev)
            load_params(self.model, params)
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.cache_len = cache_len
        self.cache: Cache = self.model.init_cache(batch_slots, cache_len)
        self.last_logits: Optional[torch.Tensor] = None

    def prefill_one(self, tokens: np.ndarray, slot: int) -> int:
        """Prefill a single request's prompt into ``slot``.

        Prompt lengths are bucketed to powers of two (at least 16) and
        padded, with the true length passed to ``prefill``; SSM and hybrid
        prompts must be exactly a bucket long.  Returns the first
        generated token.
        """
        plen = len(tokens)
        bucket = 1 << max(4, (plen - 1).bit_length())
        exact = self.cfg.family in ("ssm", "hybrid")
        if exact and bucket != plen:
            raise ValueError(
                "SSM-state prefill needs exact-length prompts; generate "
                f"prompts at bucket sizes (got {plen}, bucket {bucket})")
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :plen] = tokens
        tl = None if exact else np.asarray([plen], np.int32)
        logits, one = self.model.prefill({"tokens": padded}, self.cache_len,
                                         true_lens=tl)
        # Merge the single-request cache into the batch cache at `slot`:
        # kv leaves (L, B, T, K, hd); ssm conv (L, B, W, CH); ssd
        # (L, B, H, P, N).
        for big, small in ((self.cache.kv, one.kv), (self.cache.ssm, one.ssm)):
            for b, s in zip(big, small):
                b[:, slot] = s[:, 0]
        self.cache.index[slot] = plen
        self.last_logits = logits[0, 0]
        return int(torch.argmax(self.last_logits))

    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step for the whole batch; tokens: (slots,) i32."""
        logits, self.cache = self.model.decode_step(
            self.cache, np.asarray(tokens)[:, None])
        self.last_logits = logits[:, 0]
        return torch.argmax(self.last_logits, dim=-1).cpu().numpy()

    def reset_slot(self, slot: int) -> None:
        self.cache.index[slot] = 0


class CEPFleetServingEngine:
    """Serving front for the partitioned CEP fleet.

    ``process_batch`` takes one keyed event batch covering the time slice
    ``(t0, t1]``, routes it to partitions and advances all K partitions in
    one fleet step.  Per-partition cumulative match counts and
    capacity-drop back-pressure are exposed for the router.
    """

    def __init__(self, pattern: Pattern, k: int, plans,
                 engine_cfg: EngineConfig = EngineConfig(),
                 kind: str = "order", chunk_cap: int = 512,
                 laplace: float = 1.0, superchunk: int = 1, mesh=None):
        if type(self) is CEPFleetServingEngine:
            warn_legacy("CEPFleetServingEngine")
        self.fleet = FleetEngine(kind, pattern, k, engine_cfg,
                                 monitor_laplace=laplace, mesh=mesh)
        self.k = k
        self.chunk_cap = chunk_cap
        if superchunk < 1:
            raise ValueError("superchunk must be >= 1")
        self.superchunk = int(superchunk)
        self.state = self.fleet.init_state()
        self._rows = np.array(self.fleet.plans_to_array(plans))
        self.matches = np.zeros(k, np.int64)
        self.neg_rejected = np.zeros(k, np.int64)
        self.closure_expansions = np.zeros(k, np.int64)
        self.overflow = np.zeros(k, np.int64)
        self.dropped = 0

    def reset(self) -> None:
        """Clear stream state and counters; deployed plan rows (and
        captured windows) survive (a reset is a fresh stream, not a fresh
        fleet)."""
        self.state = self.fleet.init_state()
        for arr in (self.matches, self.neg_rejected,
                    self.closure_expansions, self.overflow):
            arr[:] = 0
        self.dropped = 0

    def deploy_plan(self, partition: int, plan) -> None:
        """Cheap deployment (§2.2): rewrite one stacked plan row."""
        self._rows[partition] = self.fleet.plan_row(plan)

    def route(self, type_id, ts, attr, keys):
        """Route one keyed event batch to a stacked per-partition chunk.

        Capacity-clipped events accumulate in ``dropped`` — the only
        engine-side drop channel; the router's ``late_dropped`` is the
        only other one, so ``submitted == reached-engine + late_dropped +
        dropped + pending`` is checkable end to end."""
        chunk, dropped = route_events(
            np.asarray(type_id), np.asarray(ts), np.asarray(attr),
            np.asarray(keys), self.k, self.chunk_cap)
        self.dropped += dropped
        return chunk

    def _accumulate(self, res) -> np.ndarray:
        # One device-to-host transfer for the four counters.
        full, neg, clo, ov = torch.stack(
            [res.full_matches, res.neg_rejected, res.closure_expansions,
             res.overflow]).cpu().numpy().astype(np.int64)
        self.matches += full
        self.neg_rejected += neg
        self.closure_expansions += clo
        # Match-set truncation undercounts matches; surface it per
        # partition so undercounting is never silent.
        self.overflow += ov
        return full

    def process_chunk(self, chunk, t0: float, t1: float) -> np.ndarray:
        """Tick the fleet once over an already-routed stacked chunk."""
        self.state, res = self.fleet.process_chunk(
            self.state, chunk, self._rows, t0, t1)
        return self._accumulate(res)

    def process_batch(self, type_id, ts, attr, keys,
                      t0: float, t1: float) -> np.ndarray:
        """Route one keyed event batch and tick the fleet once; returns the
        per-partition full-match counts for this slice."""
        return self.process_chunk(self.route(type_id, ts, attr, keys),
                                  t0, t1)

    # -- superchunk control plane ------------------------------------------

    def _accumulate_rows(self, counters, n_rows: int) -> np.ndarray:
        """Fold accepted rows of host (full, neg, closure, overflow)
        counter stacks into the cumulative per-partition totals."""
        full_h, neg_h, cl_h, ov_h = counters
        full = np.asarray(full_h[:n_rows], np.int64)
        self.matches += full.sum(axis=0)
        self.neg_rejected += np.asarray(neg_h[:n_rows],
                                        np.int64).sum(axis=0)
        self.closure_expansions += np.asarray(cl_h[:n_rows],
                                              np.int64).sum(axis=0)
        self.overflow += np.asarray(ov_h[:n_rows], np.int64).sum(axis=0)
        return full

    def process_superchunk(self, chunks, edges) -> np.ndarray:
        """Roll a sequence of already-routed stacked chunks through the
        fleet, ``superchunk`` chunks per window (``core.scan``).

        ``chunks``: stacked ``Chunk``s (leading K axis); ``edges``: their
        ``(t0, t1]`` slices.  Plans are static between ``deploy_plan``
        calls, so the host never surfaces mid-window.  Returns the
        per-chunk ``(S, K)`` full-match counts; the cumulative counters
        update as in ``process_chunk``.
        """
        from ..core.scan import stack_window, static_control

        s_cap = self.superchunk
        n = len(chunks)
        if n != len(edges):
            raise ValueError(f"{n} chunks vs {len(edges)} edges")
        out = np.zeros((n, self.k), np.int64)
        window = self.fleet.superchunk_scan(monitored=False)
        ctl = static_control(self.k, s_cap)
        i = 0
        while i < n:
            win = chunks[i:i + s_cap]
            t0s = [e[0] for e in edges[i:i + len(win)]]
            t1s = [e[1] for e in edges[i:i + len(win)]]
            xs = stack_window(win, t0s, t1s, ctl, s_cap)
            self.state, _, ys = window(self.state, None, self._rows,
                                       self._rows, None, xs)
            h = ys.host(len(win))
            out[i:i + len(win)] = self._accumulate_rows(
                (h.full, h.neg, h.closure, h.overflow), len(win))
            i += len(win)
        return out


class MonitoredCEPFleetServingEngine(CEPFleetServingEngine):
    """Serving fleet with on-device invariant monitoring (§3.3-§3.5).

    Partitions start on a plan from the uniform prior; per-partition
    statistics accumulate in device-resident rings inside the fleet step.
    When a partition's lowered invariant set flags a violation, the host
    syncs that partition's ``(rates, sel)``, re-runs the planner, and
    deploys the new plan row and the freshly lowered invariant row.

    The serving front deploys immediately (no [36] migration split):
    partial matches are rebuilt from the ring buffers every slice, so a
    row swap between batches changes only join work, never which matches
    are counted.

    Telemetry: ``violations`` / ``replans`` (per partition),
    ``host_syncs`` (statistic pulls, ∝ violations), ``last_drift`` (the
    §3.4-style margin of each partition's tightest invariant after the
    latest batch), and ``in_window_events`` (windows of
    ``process_superchunk`` cut short at an in-window flag).
    """

    def __init__(self, pattern: Pattern, k: int,
                 engine_cfg: EngineConfig = EngineConfig(),
                 kind: Optional[str] = None, chunk_cap: int = 512,
                 planner: str = "greedy", policy_kw: Optional[dict] = None,
                 monitor_buckets: int = 16,
                 max_inv: Optional[int] = None,
                 max_terms: Optional[int] = None,
                 laplace: float = 1.0, superchunk: int = 1, mesh=None):
        warn_legacy("MonitoredCEPFleetServingEngine")
        self.pattern = pattern
        self.planner = make_planner(planner)
        # The plan family must match the planner's output (an order vector
        # vs a slot-join program); derive it unless explicitly overridden.
        kind = kind or ("order" if planner == "greedy" else "tree")
        self.policies = [InvariantPolicy(**(policy_kw or {}))
                         for _ in range(k)]
        plan0, self._low, self._caps = prime_invariant_policies(
            pattern, self.planner, self.policies, (max_inv, max_terms),
            device=engine_cfg.device)
        super().__init__(pattern, k, plan0, engine_cfg, kind, chunk_cap,
                         laplace=laplace, superchunk=superchunk, mesh=mesh)
        self.plans = [plan0] * k
        self.monitor = self.fleet.init_monitor(monitor_buckets)
        self.violations = np.zeros(k, np.int64)
        self.replans = np.zeros(k, np.int64)
        self.host_syncs = 0
        self.last_drift = np.full(k, -np.inf, np.float32)
        self.in_window_events = 0

    def reset(self) -> None:
        """Clear stream state, monitor rings and counters; deployed plan
        rows and the lowered invariant rows survive."""
        super().reset()
        self.monitor = self.fleet.init_monitor(self.monitor.counts.shape[1])
        self.violations[:] = 0
        self.replans[:] = 0
        self.host_syncs = 0
        self.last_drift = np.full(self.k, -np.inf, np.float32)

    def deploy_plan(self, partition: int, plan) -> None:
        """Manually deploy a plan row for one partition.

        The partition's invariant row stays the last planner output's:
        deciding-condition sets exist only for planner-generated plans, so
        a violation re-establishes planner control (overwriting the manual
        plan through the flag-triggered replan)."""
        super().deploy_plan(partition, plan)
        self.plans[partition] = plan

    def _apply_flags(self, fired_mask, rates, sel) -> None:
        """The O(violations) control plane: sync + replan flagged rows only.
        A partition's ``rates``/``sel`` row is moved to the host only when
        its flag fired."""
        for p in np.nonzero(np.asarray(fired_mask))[0]:
            self.violations[p] += 1
            self.host_syncs += 1
            stat = Stat(rates[p].cpu().numpy().astype(np.float64),
                        sel[p].cpu().numpy().astype(np.float64))
            new_plan = replan_flagged_partition(
                self.pattern, self.planner, self.policies[p],
                self._low, p, stat, self._caps)
            if new_plan != self.plans[p]:
                self.deploy_plan(p, new_plan)  # also records self.plans[p]
                self.replans[p] += 1

    def process_chunk(self, chunk, t0: float, t1: float) -> np.ndarray:
        """Tick the fused monitored fleet over an already-routed chunk and
        replan any partition whose invariant flag fired."""
        self.state, self.monitor, res, violated, drift, rates, sel = \
            self.fleet.process_chunk_monitored(
                self.state, self.monitor, chunk, self._rows,
                self._low.device(), t0, t1)
        full = self._accumulate(res)
        # The flags and the drift in one transfer.
        vd = torch.stack([violated.to(torch.float32),
                          drift.to(torch.float32)]).cpu().numpy()
        self.last_drift = vd[1].astype(np.float32)
        self._apply_flags(vd[0] > 0.5, rates, sel)
        return full

    def process_superchunk(self, chunks, edges) -> np.ndarray:
        """Monitored superchunk ticks: S chunks per window, flags and
        telemetry accumulated on the device, host control only at window
        boundaries.

        Equal to looping ``process_chunk``: the window runs
        optimistically, and when a flag fires at in-window chunk ``f``
        only chunks ``[0..f]`` are accepted and the state continues from
        the carry after chunk ``f``, so the replanned rows deploy before
        chunk ``f+1``.
        """
        from ..core.scan import first_event, stack_window, static_control

        s_cap = self.superchunk
        n = len(chunks)
        if n != len(edges):
            raise ValueError(f"{n} chunks vs {len(edges)} edges")
        out = np.zeros((n, self.k), np.int64)
        window = self.fleet.superchunk_scan(monitored=True)
        ctl = static_control(self.k, s_cap)
        i = 0
        while i < n:
            win = chunks[i:i + s_cap]
            n_en = len(win)
            t0s = [e[0] for e in edges[i:i + n_en]]
            t1s = [e[1] for e in edges[i:i + n_en]]
            xs = stack_window(win, t0s, t1s, ctl, s_cap)
            low_dev = self._low.device()
            state2, mon2, ys = window(self.state, self.monitor, self._rows,
                                      self._rows, low_dev, xs)
            h = ys.host(n_en)
            f = first_event(h.violated, h.overflow, n_en, escalate=False)
            if f is not None and f < n_en - 1:
                state2, mon2 = ys.carry_after(f)
                self.in_window_events += 1
            accept = n_en if f is None else f + 1
            self.state, self.monitor = state2, mon2
            out[i:i + accept] = self._accumulate_rows(
                (h.full, h.neg, h.closure, h.overflow), accept)
            last = accept - 1
            self.last_drift = np.asarray(h.drift[last], np.float32)
            self._apply_flags(h.violated[last], ys.rates[last],
                              ys.sel[last])
            i += accept
        return out
