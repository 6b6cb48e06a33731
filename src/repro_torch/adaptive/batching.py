"""Invariant-governed adaptive serving batch plans.

The port's copy of ``repro.adaptive.batching`` (numpy only), built on the
port's copies of the decision, invariant, plan and statistics modules.

Serving-side instance of the paper's problem:

* **statistics** — arrival rates of request *classes* (sequence-length
  buckets); the serving analogue of event-type arrival rates.
* **plan** — the order in which classes claim slots of the fixed token
  budget of a decode batch (a greedy packing order).  The plan determines
  which bucketed batch shapes stay compiled/warm; changing it means
  compiling new shapes and draining in-flight batches — the deployment
  cost.
* **generator ``A``** — greedy: classes in decreasing ``rate × tokens``
  (work-demand) order.  Each comparison the winner survives is a BBC;
  conditions are single-product ``rate[i]·tokens_i`` terms, directly the
  paper's §4.1 shape (tokens_i acts as the per-type constant factor).

The planner re-plans only on invariant violation — e.g. a burst of long
prompts flips a ``demand(long) < demand(short)`` invariant and promotes
the long-class bucket in the packing order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.decision import InvariantPolicy
from ..core.invariants import DCSList, DecidingCondition
from ..core.plans import Expr
from ..core.stats import Stat


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Packing priority over request classes + per-class slot quotas."""

    order: Tuple[int, ...]
    quotas: Tuple[int, ...]      # slots per class in one assembly round


def _stat(rates: np.ndarray) -> Stat:
    n = rates.shape[0]
    return Stat(rates=np.asarray(rates, np.float64),
                sel=np.ones((n, n), np.float64))


def greedy_batch_plan(rates: np.ndarray, class_tokens: Sequence[int],
                      token_budget: int) -> Tuple[BatchPlan, DCSList]:
    """Deterministic greedy packing-order generator with BBC capture."""
    n = rates.shape[0]
    demand = [float(rates[i]) * class_tokens[i] for i in range(n)]
    remaining = list(range(n))
    order: List[int] = []
    dcs_list: DCSList = []
    for step in range(n):
        win = max(remaining, key=lambda i: (demand[i], -i))
        block = f"rank{step}:class{win}"
        w_expr = (Expr(rate_idx=(win,), scale=class_tokens[win]),)
        conds = [
            DecidingCondition.make(
                (Expr(rate_idx=(i,), scale=class_tokens[i]),),
                w_expr, block)
            for i in remaining if i != win
        ]
        dcs_list.append((block, conds))
        order.append(win)
        remaining.remove(win)

    # Quotas: proportional to demand in plan order, greedy water-filling.
    quotas = [0] * n
    budget = token_budget
    total = sum(demand) or 1.0
    for i in order:
        q = int(round(token_budget * demand[i] / total
                      / max(class_tokens[i], 1)))
        q = max(q, 1)
        q = min(q, budget // max(class_tokens[i], 1))
        quotas[i] = q
        budget -= q * class_tokens[i]
    return BatchPlan(tuple(order), tuple(quotas)), dcs_list


class AdaptiveBatchPlanner:
    """Detection-adaptation loop for serving batch assembly."""

    def __init__(self, class_tokens: Sequence[int], token_budget: int,
                 *, k: int = 1, d: float = 0.15, ema: float = 0.8):
        self.class_tokens = tuple(class_tokens)
        self.token_budget = token_budget
        self.ema = ema
        self.policy = InvariantPolicy(k=k, d=d)
        self._rates: Optional[np.ndarray] = None
        self.plan: Optional[BatchPlan] = None
        self.replans = 0
        self.deployments = 0

    def _replan(self) -> Optional[BatchPlan]:
        new_plan, dcs = greedy_batch_plan(
            self._rates, self.class_tokens, self.token_budget)
        self.policy.on_replan(new_plan, dcs, _stat(self._rates))
        if self.plan is None or new_plan.order != self.plan.order:
            self.plan = new_plan
            self.deployments += 1
            return new_plan
        return None

    def observe(self, class_counts: np.ndarray) -> Optional[BatchPlan]:
        """Feed one scheduling tick's per-class arrival counts."""
        class_counts = np.asarray(class_counts, np.float64)
        if self._rates is None:
            self._rates = class_counts + 1e-6
            self.replans += 1
            return self._replan()
        self._rates = self.ema * self._rates + (1 - self.ema) * class_counts
        if self.policy.decide(_stat(self._rates)):
            self.replans += 1
            return self._replan()
        return None
