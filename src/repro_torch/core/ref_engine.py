"""Brute-force reference CEP matcher — the ground-truth oracle.

A deliberately slow, pure-Python/numpy re-implementation of the detection
semantics the vectorized engine (``engine.py``) promises:

* SEQ / AND over ``n`` primitive event types with pairwise structural
  predicates and a sliding time window (span ≤ W);
* chunked **exactly-once** counting — a match is counted in the chunk
  ``(t0, t1]`` containing its latest event;
* negation as a veto: a completed match is discarded when any event of the
  negated type falls between the required positions, inside the combined
  window, and satisfies the negated predicates;
* **count-only bounded Kleene closure**: a completed match contributes
  ``min(#compatible closure events − 1, bound)`` closure expansions (the
  match's own event at the Kleene position is excluded; ``bound=None``
  means unbounded).

It enumerates every candidate combination (``∏ per-type counts`` work), so
it is only usable at test scale — which is exactly the point: differential
tests drive ``OrderEngine`` / ``TreeEngine`` / ``FleetEngine`` against this
oracle over randomized streams to prove the compiled data plane preserves
the paper's semantics.

History retention matches the engine's eviction rule: events strictly newer
than ``t0 − W`` are kept, since a match completed in ``(t0, t1]`` may reach
back at most one window before the chunk start.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Optional, Tuple

import numpy as np

from .patterns import PRED_ABS_LE, PRED_GT, PRED_LT, PRED_NONE, Pattern


@dataclasses.dataclass
class RefResult:
    """Mirror of the engine's ``StepResult`` counters the oracle can model."""

    full_matches: int = 0
    neg_rejected: int = 0
    closure_expansions: int = 0

    def __iadd__(self, other: "RefResult") -> "RefResult":
        self.full_matches += other.full_matches
        self.neg_rejected += other.neg_rejected
        self.closure_expansions += other.closure_expansions
        return self


def _pred_ok(op: int, a: float, b: float, theta: float) -> bool:
    if op == PRED_NONE:
        return True
    if op == PRED_LT:
        return a < b + theta
    if op == PRED_GT:
        return a > b - theta
    if op == PRED_ABS_LE:
        return abs(a - b) <= theta
    raise ValueError(f"unknown predicate op {op}")


def _neg_vetoed(pattern: Pattern, combo_idx, tss, tid, ts, attr) -> bool:
    npos = pattern.negated_pos
    n = pattern.n
    lo = tss[npos - 1] if npos is not None and npos > 0 else -np.inf
    hi = tss[npos] if npos is not None and npos < n else np.inf
    pos_of = {t: p for p, t in enumerate(pattern.type_ids)}
    for j in np.nonzero(tid == pattern.negated_type)[0]:
        tj = ts[j]
        if not (lo < tj < hi):
            continue
        if max(tss.max(), tj) - min(tss.min(), tj) > pattern.window:
            continue
        ok = True
        for pr in pattern.negated_predicates:
            if pr.a_type == pattern.negated_type:
                a = attr[j, pr.a_attr]
                b = attr[combo_idx[pos_of[pr.b_type]], pr.b_attr]
            else:
                a = attr[combo_idx[pos_of[pr.a_type]], pr.a_attr]
                b = attr[j, pr.b_attr]
            if not _pred_ok(pr.op, a, b, pr.theta):
                ok = False
                break
        if ok:
            return True
    return False


def _closure_count(pattern: Pattern, pt, combo_idx, tss, tid, ts,
                   attr) -> int:
    """Compatible closure events minus the match's own (engine semantics)."""
    kp = pattern.kleene_pos
    n = pattern.n
    lo = tss[kp - 1] if pattern.is_sequence and kp > 0 else -np.inf
    hi = tss[kp + 1] if pattern.is_sequence and kp < n - 1 else np.inf
    count = 0
    for j in np.nonzero(tid == pattern.type_ids[kp])[0]:
        tj = ts[j]
        if not (lo < tj < hi):
            continue
        if max(tss.max(), tj) - min(tss.min(), tj) > pattern.window:
            continue
        ok = True
        for p in range(n):
            if p == kp or pt["op"][p, kp] == PRED_NONE:
                continue
            a = attr[combo_idx[p], pt["a_attr"][p, kp]]
            b = attr[j, pt["b_attr"][p, kp]]
            if not _pred_ok(pt["op"][p, kp], a, b, pt["theta"][p, kp]):
                ok = False
                break
        if ok:
            count += 1
    comp = max(count - 1, 0)
    if pattern.kleene_bound is not None:
        comp = min(comp, pattern.kleene_bound)
    return comp


def brute_force_matches(
    pattern: Pattern,
    tid: np.ndarray,
    ts: np.ndarray,
    attr: np.ndarray,
    t0: float = -np.inf,
    t1: float = np.inf,
) -> RefResult:
    """Enumerate all matches of ``pattern`` completed in ``(t0, t1]``."""
    n = pattern.n
    pt = pattern.pred_tensors()
    idx_by_pos = [np.nonzero(tid == t)[0] for t in pattern.type_ids]
    res = RefResult()
    for combo in itertools.product(*idx_by_pos):
        combo = list(combo)
        tss = ts[combo]
        if tss.max() - tss.min() > pattern.window:
            continue
        if not (t0 < tss.max() <= t1):
            continue
        if pattern.is_sequence and not all(
                tss[i] < tss[i + 1] for i in range(n - 1)):
            continue
        ok = True
        for p in range(n):
            for q in range(n):
                if p == q or pt["op"][p, q] == PRED_NONE:
                    continue
                a = attr[combo[p], pt["a_attr"][p, q]]
                b = attr[combo[q], pt["b_attr"][p, q]]
                if not _pred_ok(pt["op"][p, q], a, b, pt["theta"][p, q]):
                    ok = False
                    break
            if not ok:
                break
        if not ok:
            continue
        if pattern.negated_type is not None and _neg_vetoed(
                pattern, combo, tss, tid, ts, attr):
            res.neg_rejected += 1
            continue
        res.full_matches += 1
        if pattern.kleene_pos is not None:
            res.closure_expansions += _closure_count(
                pattern, pt, combo, tss, tid, ts, attr)
    return res


class RefEngine:
    """Stateful chunked oracle: feed chunks in time order, get per-chunk
    exactly-once counts with the same history-eviction rule as the engine."""

    def __init__(self, pattern: Pattern):
        self.pattern = pattern
        n_attrs = pattern.n_attrs
        self._tid = np.zeros(0, np.int64)
        self._ts = np.zeros(0, np.float64)
        self._attr = np.zeros((0, n_attrs), np.float64)

    def process_chunk(self, tid, ts, attr, t0: float, t1: float,
                      valid=None) -> RefResult:
        tid = np.asarray(tid)
        ts = np.asarray(ts, np.float64)
        attr = np.asarray(attr, np.float64)
        if valid is not None:
            valid = np.asarray(valid, bool)
            tid, ts, attr = tid[valid], ts[valid], attr[valid]
        self._tid = np.concatenate([self._tid, tid])
        self._ts = np.concatenate([self._ts, ts])
        self._attr = np.concatenate([self._attr, attr])
        # Evict events the engine's leaf-validity rule can no longer see.
        keep = self._ts > t0 - self.pattern.window
        self._tid, self._ts = self._tid[keep], self._ts[keep]
        self._attr = self._attr[keep]
        return brute_force_matches(
            self.pattern, self._tid, self._ts, self._attr, t0, t1)

    def run(self, records: Iterable) -> RefResult:
        """Consume ``ChunkRecord``s (data.cep_streams) end-to-end."""
        total = RefResult()
        for rec in records:
            c = rec.chunk
            total += self.process_chunk(
                np.asarray(c.type_id), np.asarray(c.ts), np.asarray(c.attr),
                rec.t0, rec.t1, valid=np.asarray(c.valid))
        return total
