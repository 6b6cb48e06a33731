"""Instrumented greedy order-based plan generation (paper §4.1, Algorithm 2).

The greedy heuristic of Swami [47], as adapted to CEP in [36, 35]: iteratively
append the event type minimizing

    r_j · sel_jj · ∏_{k already selected} sel_{pk, j},

i.e. the marginal growth of the expected partial-match count.  With no
predicates this degenerates to sorting by arrival rate (Example 1).

Instrumentation (§3.1): each greedy step ``i`` fixes one building block
("process position ``p_i`` at step ``i``").  Every argmin comparison the
winner survives is a block-building comparison; its deciding condition
``score_i(winner) < score_i(candidate)`` joins the block's DCS.  Step ``i``
therefore contributes exactly ``n − i`` conditions, mirroring the paper's
min-sort example (DCS sizes n−1, n−2, …, 0).

Determinism: ties are broken toward the lower pattern position, making ``A``
a deterministic function of ``Stat`` as Theorems 1–2 require.
"""

from __future__ import annotations

from typing import Tuple

from .invariants import DCSList, DecidingCondition
from .patterns import Pattern
from .plans import OrderPlan, order_step_score_expr
from .stats import Stat


def greedy_order_plan(
    pattern: Pattern, stat: Stat, pin: Tuple[int, ...] = ()
) -> Tuple[OrderPlan, DCSList]:
    """Run Algorithm 2 and capture per-block deciding condition sets.

    ``pin`` forces the first ``len(pin)`` plan steps to the given
    positions regardless of statistics.  The rulebook's sharing lattice
    uses pins of arbitrary depth: a rule whose deepest shared sub-join
    sits at lattice depth ``d`` is planned with ``pin`` equal to the
    class representative's first ``d + 2`` order positions, so every
    member of a shared class walks the identical interior sub-join
    chain and only the *unshared* suffix is chosen by statistics.
    Pinned steps are decided by fiat, not by argmin comparisons, so
    they contribute empty deciding-condition sets — the invariant
    machinery simply has nothing to verify for them.
    """
    if len(pin) > pattern.n:
        raise ValueError(f"pin of length {len(pin)} exceeds pattern "
                         f"arity {pattern.n}")
    n = pattern.n
    sel_pairs = frozenset(
        {(p, q) for p, q in pattern.selectivity_pairs()}
        | {(p, p) for p in range(n) if pattern.pred_tensors()["op"][p, p] != 0}
    )
    remaining = list(range(n))
    prefix: Tuple[int, ...] = ()
    order = []
    dcs_list: DCSList = []

    for step in range(n):
        if step < len(pin):
            winner = pin[step]
            if winner not in remaining:
                raise ValueError(f"pinned position {winner} not available "
                                 f"at step {step}")
            dcs_list.append((f"pin{step}:pos{winner}", []))
            order.append(winner)
            prefix = prefix + (winner,)
            remaining.remove(winner)
            continue
        # Score every remaining candidate under the current prefix.
        exprs = {
            j: order_step_score_expr(j, prefix, sel_pairs) for j in remaining
        }
        scores = {j: exprs[j].eval(stat) for j in remaining}
        # Deterministic argmin (ties -> lower position index).
        winner = min(remaining, key=lambda j: (scores[j], j))
        block = f"step{step}:pos{winner}"
        conds = [
            DecidingCondition.make(exprs[winner], exprs[j], block)
            for j in remaining
            if j != winner
        ]
        dcs_list.append((block, conds))
        order.append(winner)
        prefix = prefix + (winner,)
        remaining.remove(winner)

    return OrderPlan(tuple(order)), dcs_list
