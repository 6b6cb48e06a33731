"""Pattern specification for the adaptive CEP engine.

A pattern (paper §2.1) combines primitive event types, operators
(SEQ / AND / OR / negation / Kleene closure), a Boolean formula of pairwise
predicates, and a time window.

To keep the data plane's tensor shapes static, predicates are
*structural tensors* rather than callables: for every ordered pair of event
types ``(i, j)`` we store an op-code, the attribute indices compared on each
side, and a threshold.  One compiled executor therefore serves any pattern of
a given size; changing the pattern (or the evaluation plan) never recompiles
the data plane.

Supported predicate op-codes (evaluated as ``cmp(a_attr, b_attr)``):

====  =============================================
code  semantics
====  =============================================
0     no predicate (always true, selectivity 1.0)
1     ``a < b + theta``
2     ``a > b - theta``
3     ``|a - b| <= theta``   (equality within eps)
====  =============================================
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

import numpy as np

# Predicate op-codes (shared with kernels/window_join).
PRED_NONE = 0
PRED_LT = 1
PRED_GT = 2
PRED_ABS_LE = 3

_PRED_NAMES = {PRED_NONE: "-", PRED_LT: "<", PRED_GT: ">", PRED_ABS_LE: "~"}


class Operator(enum.Enum):
    SEQ = "SEQ"
    AND = "AND"
    OR = "OR"          # disjunction of sub-patterns (composite)
    NEG = "NEG"        # sequence with one negated event
    KLEENE = "KLEENE"  # sequence with one event under Kleene closure


@dataclasses.dataclass(frozen=True)
class Predicate:
    """A single pairwise predicate between two event types."""

    a_type: int
    b_type: int
    op: int
    a_attr: int = 0
    b_attr: int = 0
    theta: float = 0.0

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"e{self.a_type}.a{self.a_attr} {_PRED_NAMES[self.op]} "
            f"e{self.b_type}.a{self.b_attr} (θ={self.theta:g})"
        )


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A single-operator pattern over ``n`` primitive event types.

    ``type_ids`` are global event-type identifiers (indices into the stream's
    type space); positions inside the pattern are 0..n-1 and, for SEQ-like
    operators, double as the required temporal order.

    ``negated`` / ``kleene`` give the *pattern position* of the event under
    negation / Kleene closure, or ``None``.  Per the paper (§5), negated
    events are excluded from the pattern size ``n`` used for plan generation;
    we model them as an extra type attached as a post-processing block.
    """

    operator: Operator
    type_ids: Tuple[int, ...]
    window: float
    predicates: Tuple[Predicate, ...] = ()
    n_attrs: int = 1
    negated_type: Optional[int] = None      # global type id under negation
    negated_predicates: Tuple[Predicate, ...] = ()
    negated_pos: Optional[int] = None       # absence required between
                                            # positions (negated_pos-1,
                                            # negated_pos); 0 = before all,
                                            # n = after all
    kleene_pos: Optional[int] = None        # pattern position under closure
    kleene_bound: Optional[int] = None      # max counted closure expansions
                                            # per match; None = unbounded
    name: str = "pattern"

    @property
    def n(self) -> int:
        return len(self.type_ids)

    @property
    def is_sequence(self) -> bool:
        return self.operator in (Operator.SEQ, Operator.NEG, Operator.KLEENE)

    def pred_tensors(self) -> dict:
        """Structural predicate tensors, indexed by *pattern position*.

        Returns op/a_attr/b_attr/theta arrays of shape (n, n).  Entry (p, q)
        constrains the pair (position p, position q); only p != q entries are
        used.  Predicates are stored symmetrically: a predicate (a, b, op) is
        materialized at (pos_a, pos_b) as given and at (pos_b, pos_a) with the
        mirrored op so the executor can evaluate in either join direction.
        """
        n = self.n
        op = np.zeros((n, n), np.int32)
        aa = np.zeros((n, n), np.int32)
        bb = np.zeros((n, n), np.int32)
        th = np.zeros((n, n), np.float32)
        pos_of = {t: p for p, t in enumerate(self.type_ids)}
        mirror = {PRED_NONE: PRED_NONE, PRED_LT: PRED_GT, PRED_GT: PRED_LT,
                  PRED_ABS_LE: PRED_ABS_LE}
        for pr in self.predicates:
            p, q = pos_of[pr.a_type], pos_of[pr.b_type]
            op[p, q], aa[p, q], bb[p, q], th[p, q] = pr.op, pr.a_attr, pr.b_attr, pr.theta
            op[q, p], aa[q, p], bb[q, p], th[q, p] = mirror[pr.op], pr.b_attr, pr.a_attr, pr.theta
        return {"op": op, "a_attr": aa, "b_attr": bb, "theta": th}

    def selectivity_pairs(self) -> Tuple[Tuple[int, int], ...]:
        """Pattern-position pairs (p < q) that carry a real predicate."""
        n = self.n
        t = self.pred_tensors()["op"]
        return tuple(
            (p, q) for p in range(n) for q in range(p + 1, n) if t[p, q] != PRED_NONE
        )


@dataclasses.dataclass(frozen=True)
class CompositePattern:
    """OR-composite: a disjunction of independent sub-patterns (paper set 5).

    Each sub-pattern is planned and evaluated independently; detection is the
    union of the sub-detections, and adaptation state is kept per branch.
    """

    branches: Tuple[Pattern, ...]
    name: str = "composite"

    @property
    def window(self) -> float:
        return max(b.window for b in self.branches)


def seq_pattern(
    type_ids: Sequence[int],
    window: float,
    predicates: Sequence[Predicate] = (),
    n_attrs: int = 1,
    name: str = "seq",
) -> Pattern:
    return Pattern(Operator.SEQ, tuple(type_ids), float(window),
                   tuple(predicates), n_attrs, name=name)


def and_pattern(
    type_ids: Sequence[int],
    window: float,
    predicates: Sequence[Predicate] = (),
    n_attrs: int = 1,
    name: str = "and",
) -> Pattern:
    return Pattern(Operator.AND, tuple(type_ids), float(window),
                   tuple(predicates), n_attrs, name=name)


def neg_pattern(
    type_ids: Sequence[int],
    window: float,
    negated_type: int,
    negated_pos: int,
    predicates: Sequence[Predicate] = (),
    negated_predicates: Sequence[Predicate] = (),
    n_attrs: int = 1,
    name: str = "neg",
) -> Pattern:
    return Pattern(Operator.NEG, tuple(type_ids), float(window),
                   tuple(predicates), n_attrs, negated_type=negated_type,
                   negated_predicates=tuple(negated_predicates),
                   negated_pos=negated_pos, name=name)


def kleene_pattern(
    type_ids: Sequence[int],
    window: float,
    kleene_pos: int,
    predicates: Sequence[Predicate] = (),
    n_attrs: int = 1,
    kleene_bound: Optional[int] = None,
    name: str = "kleene",
) -> Pattern:
    return Pattern(Operator.KLEENE, tuple(type_ids), float(window),
                   tuple(predicates), n_attrs, kleene_pos=kleene_pos,
                   kleene_bound=kleene_bound, name=name)


def chain_predicates(
    type_ids: Sequence[int], op: int = PRED_LT, attr: int = 0, theta: float = 0.0
) -> Tuple[Predicate, ...]:
    """Adjacent-pair predicate chain (e.g. ``A.diff < B.diff < C.diff``)."""
    return tuple(
        Predicate(a, b, op, attr, attr, theta)
        for a, b in zip(type_ids[:-1], type_ids[1:])
    )
