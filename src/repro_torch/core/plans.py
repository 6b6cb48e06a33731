"""Evaluation plans and their cost model (paper §2.1, §4).

Two plan families from the paper:

* **Order-based plans** (lazy-NFA [36]): a permutation of the pattern
  positions; the engine accumulates partial matches by joining one event type
  at a time in that order.  A *building block* is "process position ``p`` at
  step ``i``" (§4.1).

* **Tree-based plans** (ZStream [42]): a binary tree whose leaves are the
  pattern positions; internal nodes join their children's match sets.  A
  *building block* is an internal node (§4.2).

The cost model follows the paper: the expected number of partial matches a
plan materializes.  ``Expr`` is the shared symbolic form for both plan
families' *deciding conditions*: every score/cost compared during plan
generation is (additive constant) + (scale × ∏ rates × ∏ selectivities),
which makes invariant verification a constant-time product evaluation
(§4.2's subtree-cost-as-constant trick sets ``const_add``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from .stats import Stat


@dataclasses.dataclass(frozen=True)
class Expr:
    """``const_add + scale * ∏ rates[rate_idx] * ∏ sel[sel_pairs]``."""

    rate_idx: Tuple[int, ...] = ()
    sel_pairs: Tuple[Tuple[int, int], ...] = ()
    scale: float = 1.0
    const_add: float = 0.0

    def eval(self, stat: Stat) -> float:
        v = self.scale
        for i in self.rate_idx:
            v *= float(stat.rates[i])
        for i, j in self.sel_pairs:
            v *= float(stat.sel[i, j])
        return self.const_add + v

    def __str__(self) -> str:
        parts = []
        if self.const_add:
            parts.append(f"{self.const_add:.4g}")
        factors = [f"{self.scale:g}"] if self.scale != 1.0 else []
        factors += [f"r{i}" for i in self.rate_idx]
        factors += [f"s{i}{j}" for i, j in self.sel_pairs]
        term = "*".join(factors) or "1"
        parts.append(term)
        return " + ".join(parts)


def order_step_score_expr(
    candidate: int, prefix: Tuple[int, ...], sel_pairs_with_pred: frozenset
) -> Expr:
    """Greedy step score r_j · sel_jj · ∏_{k∈prefix} sel_kj (paper §4.1).

    Pairs without a defined predicate have selectivity 1 and are omitted so
    that verification touches only real statistics ("near-constant time",
    §4.1).
    """
    pairs = []
    if (candidate, candidate) in sel_pairs_with_pred:
        pairs.append((candidate, candidate))
    for k in prefix:
        key = (min(k, candidate), max(k, candidate))
        if key in sel_pairs_with_pred:
            pairs.append((k, candidate))
    return Expr(rate_idx=(candidate,), sel_pairs=tuple(pairs))


@dataclasses.dataclass(frozen=True)
class OrderPlan:
    """Order-based plan: ``order[i]`` = pattern position joined at step i."""

    order: Tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.order)

    def blocks(self) -> Tuple[str, ...]:
        return tuple(
            f"step{i}:pos{p}" for i, p in enumerate(self.order)
        )

    def __str__(self) -> str:
        return "Order(" + "->".join(map(str, self.order)) + ")"


# ---------------------------------------------------------------------------
# Tree plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TreeNode:
    """Binary plan-tree node.  Leaves carry a pattern position."""

    leaf: Optional[int] = None
    left: Optional["TreeNode"] = None
    right: Optional["TreeNode"] = None

    @property
    def is_leaf(self) -> bool:
        return self.leaf is not None

    def leaves(self) -> Tuple[int, ...]:
        if self.is_leaf:
            return (self.leaf,)
        return self.left.leaves() + self.right.leaves()

    def internal_nodes_bottom_up(self) -> Tuple["TreeNode", ...]:
        if self.is_leaf:
            return ()
        return (
            self.left.internal_nodes_bottom_up()
            + self.right.internal_nodes_bottom_up()
            + (self,)
        )

    def __str__(self) -> str:
        if self.is_leaf:
            return str(self.leaf)
        return f"({self.left},{self.right})"


@dataclasses.dataclass(frozen=True)
class TreePlan:
    root: TreeNode

    @property
    def n(self) -> int:
        return len(self.root.leaves())

    def blocks(self) -> Tuple[str, ...]:
        return tuple(
            "node:" + ",".join(map(str, nd.leaves()))
            for nd in self.root.internal_nodes_bottom_up()
        )

    def __str__(self) -> str:
        return f"Tree{self.root}"


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------


def _pair_sel(stat: Stat, group: Sequence[int]) -> float:
    v = 1.0
    g = list(group)
    for a in range(len(g)):
        for b in range(a + 1, len(g)):
            v *= float(stat.sel[g[a], g[b]])
    return v


def cardinality(stat: Stat, leaves: Sequence[int], is_sequence: bool) -> float:
    """Expected number of (partial) matches over a leaf group (§4.2).

    ``∏ rates × ∏ pairwise selectivities``, with the standard ``1/k!``
    temporal-ordering factor for sequence patterns (each unordered event
    combination admits exactly one valid temporal order).
    """
    v = 1.0
    for i in leaves:
        v *= float(stat.rates[i]) * float(stat.sel[i, i])
    v *= _pair_sel(stat, leaves)
    if is_sequence and len(leaves) > 1:
        v /= math.factorial(len(leaves))
    return v


def order_plan_cost(plan: OrderPlan, stat: Stat, is_sequence: bool = True) -> float:
    """Σ over prefixes of the expected partial-match count (paper §4.1)."""
    total = 0.0
    for i in range(1, plan.n + 1):
        total += cardinality(stat, plan.order[:i], is_sequence)
    return total


def tree_cost(node: TreeNode, stat: Stat, is_sequence: bool = True) -> float:
    """ZStream cost: Cost(T) = Cost(L) + Cost(R) + Card(T) (§4.2)."""
    if node.is_leaf:
        return float(stat.rates[node.leaf]) * float(stat.sel[node.leaf, node.leaf])
    return (
        tree_cost(node.left, stat, is_sequence)
        + tree_cost(node.right, stat, is_sequence)
        + cardinality(stat, node.leaves(), is_sequence)
    )


def plan_cost(plan, stat: Stat, is_sequence: bool = True) -> float:
    if isinstance(plan, OrderPlan):
        return order_plan_cost(plan, stat, is_sequence)
    if isinstance(plan, TreePlan):
        return tree_cost(plan.root, stat, is_sequence)
    raise TypeError(f"unknown plan type {type(plan)}")


def cardinality_expr(
    leaves: Sequence[int],
    sel_pairs_with_pred: frozenset,
    is_sequence: bool,
    const_add: float = 0.0,
) -> Expr:
    """Symbolic ``Card(leaves)`` for deciding conditions (§4.2)."""
    pairs = []
    for i in leaves:
        if (i, i) in sel_pairs_with_pred:
            pairs.append((i, i))
    g = sorted(leaves)
    for a in range(len(g)):
        for b in range(a + 1, len(g)):
            if (g[a], g[b]) in sel_pairs_with_pred:
                pairs.append((g[a], g[b]))
    scale = 1.0 / math.factorial(len(leaves)) if (is_sequence and len(leaves) > 1) else 1.0
    return Expr(
        rate_idx=tuple(sorted(leaves)),
        sel_pairs=tuple(pairs),
        scale=scale,
        const_add=const_add,
    )
