"""Instrumented ZStream dynamic-programming tree planner (paper §4.2, Alg. 3).

Interval DP in the style of matrix-chain ordering: ``best[i][j]`` holds the
cheapest tree over the ``i`` consecutive pattern positions starting at ``j``,
with

    Cost(T) = Cost(L) + Cost(R) + Card(L ∪ R),
    Card(T) = Card(L) · Card(R) · SEL(L, R) · order_factor,

where ``SEL(L, R)`` is the product of cross predicate selectivities and
``order_factor = |L|!·|R|!/|T|!`` accounts for the single valid temporal
interleaving of sequence patterns (1 for conjunctions).

Instrumentation (§3.1/§4.2): a building block is an internal node of the
final plan; the DCS of the node over interval ``I`` holds one deciding
condition per *alternative split* of ``I`` — ``cost(winning split) <
cost(alternative split)``.  Intervals of length 2 have a single split and
hence an empty DCS, mirroring the paper's "last block" case.

Deciding-condition representation — two modes:

* ``freeze="none"`` (default, beyond-paper accuracy): the ZStream cost has
  the closed form ``Cost(T) = Σ_nodes Card(node) + Σ leaves r·sel`` where
  every ``Card`` is a *product* of live statistics — so each condition
  side is an exact ``ExprSum`` of O(n) product terms and Theorem 1 holds
  for tree plans with the same rigor as for the greedy planner
  (empirically 0 false positives vs >25% under frozen constants at large
  drifts; see tests/test_invariants.py).  Verification is O(n) per
  invariant instead of O(1) — for n <= 8 this is nanoseconds either way.

* ``freeze="paper"`` — the paper's §4.2 subtree-cost-as-constant trick:
  subtrees with >= 3 leaves (which carry their own, earlier-verified
  invariants) enter conditions as constants frozen at plan-creation time;
  leaves and 2-leaf subtrees (whose DCS is empty) stay live.  O(1)
  verification, approximate under large drifts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from .invariants import DCSList, DecidingCondition, ExprSum
from .patterns import Pattern
from .plans import Expr, TreeNode, TreePlan, cardinality_expr
from .stats import Stat


@dataclasses.dataclass
class _Cell:
    """One DP cell: best tree over an interval + its symbolic description."""

    tree: TreeNode
    cost: float
    card: float
    cost_sum: ExprSum      # symbolic cost (frozen/live mix, see module doc)
    card_expr: Expr        # symbolic cardinality (live for leaves)
    conds: List[DecidingCondition]


def _leaf_cell(pos: int, stat: Stat, has_self_pred: bool) -> _Cell:
    card = float(stat.rates[pos]) * float(stat.sel[pos, pos])
    sel_pairs = ((pos, pos),) if has_self_pred else ()
    e = Expr(rate_idx=(pos,), sel_pairs=sel_pairs)
    return _Cell(
        tree=TreeNode(leaf=pos), cost=card, card=card,
        cost_sum=(e,), card_expr=e, conds=[],
    )


def _freeze(cell: _Cell, mode: str) -> Tuple[ExprSum, Expr]:
    """Symbolic (cost, card) forms for a subtree, per the module docstring.

    In "paper" mode, leaves and 2-leaf subtrees stay LIVE even though the
    paper freezes all subtree costs: a 2-leaf node has an *empty* DCS
    (single possible split), so no earlier invariant would notice drift in
    its cost — freezing it would blind the parent.  Subtrees with >= 3
    leaves carry their own invariants (verified earlier in the bottom-up
    order), which is exactly the paper's justification for constants
    (§4.2).
    """
    if mode == "none":
        return cell.cost_sum, cell.card_expr
    if cell.tree.is_leaf or len(cell.tree.leaves()) == 2:
        return cell.cost_sum, cell.card_expr
    return (Expr(scale=cell.cost),), Expr(scale=cell.card)


def _cross_pairs(
    left: Tuple[int, ...], right: Tuple[int, ...], with_pred: frozenset
) -> Tuple[Tuple[int, int], ...]:
    out = []
    for a in left:
        for b in right:
            key = (min(a, b), max(a, b))
            if key in with_pred:
                out.append(key)
    return tuple(out)


def zstream_tree_plan(
    pattern: Pattern, stat: Stat, freeze: str = "none"
) -> Tuple[TreePlan, DCSList]:
    """Run Algorithm 3 and capture per-node deciding condition sets."""
    assert freeze in ("none", "paper"), freeze
    n = pattern.n
    is_seq = pattern.is_sequence
    op = pattern.pred_tensors()["op"]
    with_pred = frozenset(
        {(p, q) for p, q in pattern.selectivity_pairs()}
        | {(p, p) for p in range(n) if op[p, p] != 0}
    )

    # best[(start, length)] -> _Cell
    best: Dict[Tuple[int, int], _Cell] = {}
    for p in range(n):
        best[(p, 1)] = _leaf_cell(p, stat, (p, p) in with_pred)

    for length in range(2, n + 1):
        for start in range(0, n - length + 1):
            cand: List[Tuple[float, int, _Cell]] = []
            exprs: Dict[int, ExprSum] = {}
            for split in range(1, length):  # left length
                L = best[(start, split)]
                R = best[(start + split, length - split)]
                lleaves = L.tree.leaves()
                rleaves = R.tree.leaves()
                factor = (
                    math.factorial(split) * math.factorial(length - split)
                    / math.factorial(length)
                ) if is_seq else 1.0
                cross = _cross_pairs(lleaves, rleaves, with_pred)
                sel_cross = 1.0
                for i, j in cross:
                    sel_cross *= float(stat.sel[i, j])
                card = L.card * R.card * sel_cross * factor
                cost = L.cost + R.cost + card

                # Symbolic forms with the freezing convention.
                l_cost_sym, l_card_sym = _freeze(L, freeze)
                r_cost_sym, r_card_sym = _freeze(R, freeze)
                if freeze == "none":
                    # Exact node cardinality over the interval's leaves.
                    card_expr = cardinality_expr(
                        sorted(lleaves + rleaves), with_pred, is_seq)
                else:
                    card_expr = Expr(
                        rate_idx=l_card_sym.rate_idx + r_card_sym.rate_idx,
                        sel_pairs=l_card_sym.sel_pairs
                        + r_card_sym.sel_pairs + cross,
                        scale=l_card_sym.scale * r_card_sym.scale * factor,
                    )
                cost_sum: ExprSum = l_cost_sym + r_cost_sym + (card_expr,)
                exprs[split] = cost_sum
                cell = _Cell(
                    tree=TreeNode(left=L.tree, right=R.tree),
                    cost=cost, card=card, cost_sum=cost_sum,
                    card_expr=card_expr, conds=[],
                )
                cand.append((cost, split, cell))

            # Deterministic argmin (ties -> smaller split index).
            cand.sort(key=lambda c: (c[0], c[1]))
            w_cost, w_split, w_cell = cand[0]
            block = f"node:{start}..{start + length - 1}"
            w_cell.conds = [
                DecidingCondition.make(exprs[w_split], exprs[s], block)
                for _, s, _ in cand[1:]
            ]
            best[(start, length)] = w_cell

    root = best[(0, n)]
    plan = TreePlan(root.tree)

    # Collect DCSs for final-plan internal nodes, bottom-up (§3.2 order).
    dcs_list: DCSList = []

    def walk(node: TreeNode, start: int) -> int:
        """Post-order walk; returns interval length under ``node``."""
        if node.is_leaf:
            return 1
        llen = walk(node.left, start)
        rlen = walk(node.right, start + llen)
        length = llen + rlen
        cell = best[(start, length)]
        block = f"node:{start}..{start + length - 1}"
        dcs_list.append((block, cell.conds))
        return length

    walk(root.tree, 0)
    return plan, dcs_list
