"""Fluent pattern-builder DSL compiling to structural-tensor ``Pattern``s.

The engine's native pattern form (``core.patterns.Pattern``) is built from
hand-assembled ``Predicate`` op-code tuples — precise, but hostile as a
public surface.  This module provides the algebra the paper writes its
queries in:

    P.seq(0, 1, 2).where(P.attr(0) < P.attr(1) - 0.3,
                         P.attr(1) < P.attr(2) - 0.3).within(4.0)

* ``P.seq(...)`` / ``P.and_(...)`` take event *type ids*; an element may be
  wrapped in ``P.neg(t)`` (required absence) or ``P.kleene(t, bound=...)``
  (counted closure) — at most one of each, sequences only, matching the
  engine's single-operator patterns.
* ``P.attr(i, k)`` references attribute ``k`` of the *i*-th primitive
  element (negated elements do not consume a position index, mirroring the
  paper's convention that negated events are outside the plan size ``n``);
  ``P.neg_attr(k)`` references the negated event.  Comparisons build
  predicates with exactly the engine's op-codes:

      a < b + θ   →  PRED_LT, theta=θ        (shift folds into θ)
      a > b - θ   →  PRED_GT, theta=θ
      abs(a - b) <= θ  →  PRED_ABS_LE, theta=θ

  The engine evaluates strict inequalities only, so ``<=``/``>=`` between
  attributes raise instead of silently weakening the predicate.
* ``P.or_(...)`` builds an OR-composite: a disjunction of independently
  planned and executed branches (``CompositePattern``); the ``Session``
  facade decomposes it into per-branch sub-sessions and aggregates counts.

Builders are immutable: ``where``/``within``/``named``/``attrs`` return new
builders, so partial patterns can be shared and specialized.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from ..core.patterns import (PRED_ABS_LE, PRED_GT, PRED_LT, CompositePattern,
                             Operator, Pattern, Predicate)

__all__ = ["P", "PatternBuilder", "CompositeBuilder"]


# ---------------------------------------------------------------------------
# Attribute references and predicate expressions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttrRef:
    """``P.attr(pos, k)`` (or ``P.neg_attr(k)``), plus a folded scalar shift."""

    pos: Optional[int]        # primitive position; None for the negated event
    attr: int = 0
    shift: float = 0.0

    @property
    def is_neg(self) -> bool:
        return self.pos is None

    # -- scalar shifts (fold into theta) ------------------------------------

    def __add__(self, c: float) -> "AttrRef":
        return dataclasses.replace(self, shift=self.shift + float(c))

    __radd__ = __add__

    def __sub__(self, other: Union["AttrRef", float]):
        if isinstance(other, AttrRef):
            return AttrDiff(self, other)
        return dataclasses.replace(self, shift=self.shift - float(other))

    # -- comparisons --------------------------------------------------------

    def __lt__(self, other: "AttrRef") -> "Cond":
        # a + sa < b + sb  ⇔  a < b + (sb − sa)  →  PRED_LT, θ = sb − sa
        _check_pair(self, other)
        return Cond(self, other, PRED_LT, other.shift - self.shift)

    def __gt__(self, other: "AttrRef") -> "Cond":
        # a + sa > b + sb  ⇔  a > b − (sa − sb)  →  PRED_GT, θ = sa − sb
        _check_pair(self, other)
        return Cond(self, other, PRED_GT, self.shift - other.shift)

    def __le__(self, other):
        raise TypeError("the engine evaluates strict inequalities only; "
                        "use < / > (or abs(a - b) <= theta)")

    __ge__ = __le__


@dataclasses.dataclass(frozen=True)
class AttrDiff:
    """``a - b`` between two attribute refs; only ``abs(...)`` is consumable."""

    a: AttrRef
    b: AttrRef

    def __abs__(self) -> "AbsDiff":
        return AbsDiff(self.a, self.b)


@dataclasses.dataclass(frozen=True)
class AbsDiff:
    a: AttrRef
    b: AttrRef

    def __le__(self, theta: float) -> "Cond":
        _check_pair(self.a, self.b)
        if self.a.shift or self.b.shift:
            raise ValueError("abs-difference predicates do not support "
                             "scalar shifts; compare unshifted attributes")
        return Cond(self.a, self.b, PRED_ABS_LE, float(theta))

    def __lt__(self, theta):
        raise TypeError("the engine evaluates abs-difference as <=; "
                        "write abs(a - b) <= theta")


def _check_pair(a: AttrRef, b: AttrRef) -> None:
    if not isinstance(b, AttrRef):
        raise TypeError("predicates compare two attribute references; "
                        f"got {type(b).__name__} (unary/constant predicates "
                        "are not supported by the data plane)")
    if a.is_neg and b.is_neg:
        raise ValueError("a predicate cannot relate the negated event "
                         "to itself")


@dataclasses.dataclass(frozen=True)
class Cond:
    """One pairwise predicate in DSL form (positions, not type ids)."""

    a: AttrRef
    b: AttrRef
    op: int
    theta: float

    def __bool__(self) -> bool:
        # Python rewrites `a < b < c` as `(a < b) and (b < c)`, which
        # truth-tests the first Cond and would silently discard it —
        # a weaker pattern with no error.  Refuse to be a boolean.
        raise TypeError(
            "predicate expressions cannot be chained (`a < b < c`) or "
            "used as booleans; pass each comparison to where() separately")


# ---------------------------------------------------------------------------
# Pattern elements
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NegElement:
    type_id: int


@dataclasses.dataclass(frozen=True)
class KleeneElement:
    type_id: int
    bound: Optional[int] = None


Element = Union[int, NegElement, KleeneElement]


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PatternBuilder:
    """Immutable, chainable single-operator pattern under construction."""

    base: Operator                      # SEQ or AND (refined at build time)
    elements: Tuple[Element, ...]
    window: Optional[float] = None
    conds: Tuple[Cond, ...] = ()
    n_attrs: Optional[int] = None       # None -> inferred from predicates
    name: Optional[str] = None

    # -- chainable refinements ---------------------------------------------

    def where(self, *conds: Cond) -> "PatternBuilder":
        for c in conds:
            if not isinstance(c, Cond):
                raise TypeError(
                    f"where() takes predicate expressions built from "
                    f"P.attr(...); got {type(c).__name__}")
        return dataclasses.replace(self, conds=self.conds + tuple(conds))

    def within(self, window: float) -> "PatternBuilder":
        if window <= 0:
            raise ValueError("within() needs a positive time window")
        return dataclasses.replace(self, window=float(window))

    def attrs(self, n_attrs: int) -> "PatternBuilder":
        return dataclasses.replace(self, n_attrs=int(n_attrs))

    def named(self, name: str) -> "PatternBuilder":
        return dataclasses.replace(self, name=str(name))

    # -- compilation --------------------------------------------------------

    def build(self) -> Pattern:
        if self.window is None:
            raise ValueError("pattern has no time window; call .within(W)")
        prim_types, neg, kleene_pos, kleene_bound = [], None, None, None
        neg_pos = None
        for el in self.elements:
            if isinstance(el, NegElement):
                if self.base is not Operator.SEQ:
                    raise ValueError("P.neg(...) elements require P.seq")
                if neg is not None:
                    raise ValueError("at most one negated element")
                neg, neg_pos = el.type_id, len(prim_types)
            elif isinstance(el, KleeneElement):
                if self.base is not Operator.SEQ:
                    raise ValueError("P.kleene(...) elements require P.seq")
                if kleene_pos is not None:
                    raise ValueError("at most one Kleene element")
                kleene_pos, kleene_bound = len(prim_types), el.bound
                prim_types.append(int(el.type_id))
            else:
                prim_types.append(int(el))
        if neg is not None and kleene_pos is not None:
            raise ValueError("negation and Kleene closure cannot be "
                             "combined in one pattern")
        if len(prim_types) < 2:
            raise ValueError("a pattern needs at least two primitive "
                             "(non-negated) elements")
        all_types = prim_types + ([neg] if neg is not None else [])
        if len(set(all_types)) != len(all_types):
            raise ValueError("event types must be distinct within a "
                             "pattern (structural predicate tensors are "
                             "keyed by type)")

        preds, neg_preds = [], []
        for c in self.conds:
            pr = self._compile_cond(c, prim_types, neg)
            (neg_preds if (c.a.is_neg or c.b.is_neg) else preds).append(pr)

        operator = self.base
        if neg is not None:
            operator = Operator.NEG
        elif kleene_pos is not None:
            operator = Operator.KLEENE
        return Pattern(
            operator=operator,
            type_ids=tuple(prim_types),
            window=float(self.window),
            predicates=tuple(preds),
            n_attrs=self._n_attrs(),
            negated_type=neg,
            negated_predicates=tuple(neg_preds),
            negated_pos=neg_pos,
            kleene_pos=kleene_pos,
            kleene_bound=kleene_bound,
            name=self.name or operator.value.lower(),
        )

    def _compile_cond(self, c: Cond, prim_types, neg) -> Predicate:
        def tid(ref: AttrRef) -> int:
            if ref.is_neg:
                if neg is None:
                    raise ValueError("P.neg_attr(...) used but the pattern "
                                     "has no negated element")
                return neg
            if not 0 <= ref.pos < len(prim_types):
                raise ValueError(
                    f"P.attr({ref.pos}, ...) out of range for a pattern "
                    f"with {len(prim_types)} primitive elements")
            return prim_types[ref.pos]

        return Predicate(tid(c.a), tid(c.b), c.op,
                         c.a.attr, c.b.attr, c.theta)

    def _n_attrs(self) -> int:
        if self.n_attrs is not None:
            return self.n_attrs
        used = [c.a.attr for c in self.conds] + [c.b.attr for c in self.conds]
        return max(used, default=0) + 1


@dataclasses.dataclass(frozen=True)
class CompositeBuilder:
    """OR-composite of independent branches (paper §5 pattern set 5)."""

    branches: Tuple[Union[PatternBuilder, Pattern], ...]
    name: str = "or"

    def named(self, name: str) -> "CompositeBuilder":
        return dataclasses.replace(self, name=str(name))

    def build(self) -> CompositePattern:
        built = tuple(b.build() if isinstance(b, PatternBuilder) else b
                      for b in self.branches)
        return CompositePattern(built, name=self.name)


def as_pattern(p) -> Union[Pattern, CompositePattern]:
    """Accept builders or already-compiled patterns (facade entry point)."""
    if isinstance(p, (PatternBuilder, CompositeBuilder)):
        return p.build()
    if isinstance(p, (Pattern, CompositePattern)):
        return p
    raise TypeError(
        f"expected a P.seq/P.and_/P.or_ builder, Pattern, or "
        f"CompositePattern; got {type(p).__name__}")


# ---------------------------------------------------------------------------
# The public namespace
# ---------------------------------------------------------------------------


class P:
    """Pattern-builder namespace: combinators and attribute references."""

    @staticmethod
    def seq(*elements: Element) -> PatternBuilder:
        """Temporally ordered pattern (SEQ; NEG/KLEENE via wrapped items)."""
        return PatternBuilder(Operator.SEQ, tuple(elements))

    @staticmethod
    def and_(*elements: int) -> PatternBuilder:
        """Unordered conjunction (AND) of plain event types."""
        return PatternBuilder(Operator.AND, tuple(elements))

    @staticmethod
    def or_(*branches: Union[PatternBuilder, Pattern]) -> CompositeBuilder:
        """Disjunction of sub-patterns, each planned/adapted independently."""
        if len(branches) < 2:
            raise ValueError("P.or_ needs at least two branches")
        return CompositeBuilder(tuple(branches))

    @staticmethod
    def neg(type_id: int) -> NegElement:
        """Required absence of ``type_id`` between its seq neighbours."""
        return NegElement(int(type_id))

    @staticmethod
    def kleene(type_id: int, bound: Optional[int] = None) -> KleeneElement:
        """Counted Kleene closure over ``type_id`` (count-only semantics)."""
        return KleeneElement(int(type_id), bound)

    @staticmethod
    def attr(pos: int, attr: int = 0) -> AttrRef:
        """Attribute ``attr`` of the ``pos``-th primitive element."""
        return AttrRef(int(pos), int(attr))

    @staticmethod
    def neg_attr(attr: int = 0) -> AttrRef:
        """Attribute ``attr`` of the pattern's negated element."""
        return AttrRef(None, int(attr))
