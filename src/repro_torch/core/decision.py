"""Reoptimizing decision functions ``D`` (paper §2.3, §5).

Four policies, matching the experimental study:

* ``StaticPolicy``        — never re-optimize (the "static plan" baseline).
* ``UnconditionalPolicy`` — re-optimize every iteration (tree-NFA [36]).
* ``ThresholdPolicy``     — re-optimize when any monitored value deviates
                            from its value at the last re-optimization by at
                            least ``t`` (ZStream [42]); relative deviation.
* ``InvariantPolicy``     — the paper's contribution: verify the invariant
                            list (K-invariant §3.3, distance-d §3.4,
                            selection strategy §3.1/§3.5).

Each policy observes the replans through ``on_replan`` so it can rebase its
internal state (thresholds rebase the reference vector; invariants rebuild
the list from the fresh DCSs).

Control-plane flow at fleet scale: ``InvariantPolicy`` owns the *selection*
of invariants (host-side, once per replan) while the per-chunk
*verification* can run either on the host (``should_reoptimize`` /
``decide``) or on device — ``InvariantPolicy.compile()`` lowers the current
invariant set into ``LoweredInvariants`` tensors that the fused monitored
step (``engine.make_monitored_process``, K-batched by ``fleet.FleetEngine``)
evaluates on the device.  The host then consults only the
returned violation flags and replans flagged partitions, so per-chunk host
work scales with violations, not with fleet size.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .invariants import (
    DCSList,
    DecidingCondition,
    InvariantSet,
    d_avg_estimate,
    select_invariants,
)
from .stats import Stat


class DecisionPolicy:
    """Interface: ``decide(stat) -> bool`` plus replan notifications."""

    name = "base"

    def decide(self, stat: Stat) -> bool:
        raise NotImplementedError

    def should_reoptimize(self, stat: Stat) -> bool:
        """Alias of ``decide`` mirroring the paper's reoptimizing-decision
        naming; the device-monitoring differential tests compare the fleet's
        violation flags against this."""
        return self.decide(stat)

    def on_replan(self, plan, dcs_list: DCSList, stat: Stat) -> None:
        """Called after every run of ``A`` (including the initial one)."""

    def cost_counter(self) -> int:
        """Number of elementary condition checks performed so far (for the
        overhead accounting in §5's Figures 6d-9d)."""
        return getattr(self, "_checks", 0)


class StaticPolicy(DecisionPolicy):
    name = "static"

    def decide(self, stat: Stat) -> bool:
        return False


class UnconditionalPolicy(DecisionPolicy):
    """Re-generate the plan for every observed statistics snapshot [36]."""

    name = "unconditional"

    def decide(self, stat: Stat) -> bool:
        return True


class ThresholdPolicy(DecisionPolicy):
    """Constant threshold ``t`` on relative deviation of any statistic [42]."""

    name = "threshold"

    def __init__(self, t: float):
        self.t = float(t)
        self._ref: Optional[np.ndarray] = None
        self._checks = 0

    def on_replan(self, plan, dcs_list: DCSList, stat: Stat) -> None:
        self._ref = stat.values().copy()

    def decide(self, stat: Stat) -> bool:
        if self._ref is None:
            self._ref = stat.values().copy()
            return False
        cur = stat.values()
        self._checks += cur.size
        denom = np.maximum(np.abs(self._ref), 1e-12)
        return bool(np.any(np.abs(cur - self._ref) / denom >= self.t))


class InvariantPolicy(DecisionPolicy):
    """The invariant-based method (§3) with K, d and selection knobs."""

    name = "invariant"

    def __init__(
        self,
        k: int = 1,
        d: float = 0.0,
        strategy: str = "tightest",
        d_mode: str = "fixed",  # "fixed" | "avg"  (§3.4 approach 2)
        violation_prob: Optional[
            Callable[[DecidingCondition, Stat], float]
        ] = None,
    ):
        self.k = int(k)
        self.d = float(d)
        self.strategy = strategy
        self.d_mode = d_mode
        self.violation_prob = violation_prob
        self._set: Optional[InvariantSet] = None
        self._checks = 0

    def on_replan(self, plan, dcs_list: DCSList, stat: Stat) -> None:
        d = self.d
        if self.d_mode == "avg":
            d = d_avg_estimate(dcs_list, stat)
            self.d_estimated = d
        invs = select_invariants(
            dcs_list, stat, k=self.k, strategy=self.strategy,
            violation_prob=self.violation_prob,
        )
        self._set = InvariantSet(invs, d=d)

    def decide(self, stat: Stat) -> bool:
        if self._set is None:
            return True  # never planned yet
        self._checks += len(self._set)
        return self._set.check(stat)

    def compile(self, n: int, max_inv: Optional[int] = None,
                max_terms: Optional[int] = None):
        """Lower the current invariant set to device tensors.

        Returns ``invariants.LoweredInvariants`` with static shape
        ``(max_inv, 2, max_terms, ...)`` suitable for stacking across a
        fleet (pass the fleet-wide caps so every partition's row matches).
        Must be called after ``on_replan`` has installed an invariant set.
        """
        if self._set is None:
            raise ValueError("compile() before the first on_replan(); the "
                             "policy has no invariant set yet")
        return self._set.lower(n, max_inv=max_inv, max_terms=max_terms)

    @property
    def invariant_set(self) -> Optional[InvariantSet]:
        return self._set


def make_policy(name: str, **kw) -> DecisionPolicy:
    """Factory used by benchmarks and the adaptive framework layer."""
    if name == "static":
        return StaticPolicy()
    if name == "unconditional":
        return UnconditionalPolicy()
    if name == "threshold":
        return ThresholdPolicy(t=kw.get("t", 0.5))
    if name == "invariant":
        return InvariantPolicy(
            k=kw.get("k", 1),
            d=kw.get("d", 0.0),
            strategy=kw.get("strategy", "tightest"),
            d_mode=kw.get("d_mode", "fixed"),
            violation_prob=kw.get("violation_prob"),
        )
    raise ValueError(f"unknown policy {name!r}")
