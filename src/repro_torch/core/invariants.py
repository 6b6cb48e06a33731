"""Invariant-based reoptimizing decision machinery (paper §3).

A *deciding condition* is an inequality ``f1(stat1) < f2(stat2)`` whose
verification (a *block-building comparison*, BBC) led the plan generation
algorithm ``A`` to include a specific *building block* in the final plan
(§3.1).  All deciding conditions of a block form its *deciding condition set*
(DCS); DCSs of distinct blocks are disjoint by construction.

Each side of a condition is a **sum of product terms** (``ExprSum``): greedy
step scores are single products ``r_j·∏sel``; ZStream tree costs are
``frozen_subtree_costs + live_cardinality_product`` (§4.2's
subtree-cost-as-constant trick).  Every side therefore evaluates in constant
time, as the paper's complexity analysis requires.

From each DCS we select up to ``K`` conditions as *invariants* (§3.3), by
default the *tightest* ones — smallest ``f2 − f1`` at plan-creation time
(§3.1) — or, when variance estimates are available, the ones most likely to
be violated (§3.5).  The decision function ``D`` is the ordered conjunction
of the invariants: it returns ``true`` iff at least one invariant is violated
under the current statistics, using the *distance* margin ``d`` (§3.4):

    violated  ⇔  f1(stat) >= (1 + d) · f2(stat).

Note on the direction of ``d``: the paper prints the verified invariant as
``(1+d)·f1 < f2``, which taken literally *lowers* the firing bar below the
basic method — contradicting §3.4's stated purpose (damping plan-flapping
when two statistics oscillate around each other) and Figure 5 (throughput
*increases* with d up to ``d_opt`` because *fewer* replans fire).  We
therefore implement the semantics the section describes: a violation
requires the inequality to flip *by a relative margin of at least d*.
``d = 0`` coincides exactly with the basic method either way.

Theorem 1 (d = 0): a violation guarantees the next run of ``A`` yields a
different plan — no false positives.  Theorem 2 (strategy = "all"): keeping
*all* conditions also eliminates false negatives.  Both are exercised as
property tests in ``tests/test_invariants.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .plans import Expr
from .stats import Stat

# A condition side: sum of product-form terms.
ExprSum = Tuple[Expr, ...]


def eval_sum(side: ExprSum, stat: Stat) -> float:
    return float(sum(e.eval(stat) for e in side))


def _as_sum(side) -> ExprSum:
    if isinstance(side, Expr):
        return (side,)
    return tuple(side)


@dataclasses.dataclass(frozen=True)
class DecidingCondition:
    """``sum(lhs) < sum(rhs)`` attributed to building block ``block``."""

    lhs: ExprSum
    rhs: ExprSum
    block: str

    @staticmethod
    def make(lhs, rhs, block: str) -> "DecidingCondition":
        return DecidingCondition(_as_sum(lhs), _as_sum(rhs), block)

    def margin(self, stat: Stat) -> float:
        """``f2 − f1`` under ``stat`` — positive while the condition holds."""
        return eval_sum(self.rhs, stat) - eval_sum(self.lhs, stat)

    def rel_margin(self, stat: Stat) -> float:
        """``|f2 − f1| / min(f1, f2)`` — the §3.4 relative-difference term."""
        a, b = eval_sum(self.lhs, stat), eval_sum(self.rhs, stat)
        lo = min(a, b)
        return abs(b - a) / max(lo, 1e-12)

    def holds(self, stat: Stat, d: float = 0.0) -> bool:
        """Condition (with distance margin) still holds — not violated."""
        return eval_sum(self.lhs, stat) < (1.0 + d) * eval_sum(self.rhs, stat)

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        l = " + ".join(map(str, self.lhs))
        r = " + ".join(map(str, self.rhs))
        return f"[{self.block}] {l} < {r}"


# A DCS list is ordered by the plan's block order (order-based: step order;
# tree-based: bottom-up node order) — §3.2 verification order.
DCSList = List[Tuple[str, List[DecidingCondition]]]


def select_invariants(
    dcs_list: DCSList,
    stat: Stat,
    k: int = 1,
    strategy: str = "tightest",
    violation_prob: Optional[Callable[[DecidingCondition, Stat], float]] = None,
) -> List[DecidingCondition]:
    """Pick up to ``k`` invariants per DCS (§3.1, §3.3, §3.5).

    strategy:
      * ``"tightest"``  — smallest absolute margin ``f2 − f1`` (paper default).
      * ``"rel"``       — smallest relative margin (scale-free variant).
      * ``"prob"``      — largest estimated violation probability; requires
                          ``violation_prob`` (§3.5 optimization).
      * ``"all"``       — keep every condition (Theorem 2 regime).
    """
    out: List[DecidingCondition] = []
    for _, conds in dcs_list:
        if not conds:
            continue
        if strategy == "all":
            chosen = list(conds)
        elif strategy == "tightest":
            chosen = sorted(conds, key=lambda c: c.margin(stat))[:k]
        elif strategy == "rel":
            chosen = sorted(conds, key=lambda c: c.rel_margin(stat))[:k]
        elif strategy == "prob":
            if violation_prob is None:
                raise ValueError("strategy='prob' requires violation_prob")
            chosen = sorted(
                conds, key=lambda c: -violation_prob(c, stat)
            )[:k]
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
        out.extend(chosen)
    return out


def d_avg_estimate(dcs_list: DCSList, stat: Stat, clip: float = 5.0
                   ) -> float:
    """§3.4 data-analysis heuristic: average relative slack of all deciding
    conditions observed during the initial run of ``A``.

    Each term is clipped (default 5.0): with multiplicative score
    expressions a near-zero side makes a single ratio astronomically
    large, and an unclipped mean is dominated by it (a failure mode of
    the paper's formula on low-selectivity patterns; d > 5 would disable
    adaptation entirely anyway).
    """
    rels = [min(c.rel_margin(stat), clip)
            for _, conds in dcs_list for c in conds]
    if not rels:
        return 0.0
    return float(np.mean(rels))


class InvariantSet:
    """The ordered invariant list verified by ``D`` each loop iteration.

    Verification cost is O(#invariants) ≤ O(K·(B−1)) with each check a
    constant-size sum-of-products evaluation (§3.2); the evaluation is
    vectorized over flattened term arrays so the per-iteration overhead stays
    in the microsecond range even for K-invariant configurations.
    """

    def __init__(self, invariants: Sequence[DecidingCondition], d: float = 0.0):
        self.invariants = list(invariants)
        self.d = float(d)
        self._compile()

    def _compile(self) -> None:
        """Flatten both sides into term-level gather/product arrays.

        Row = one product term.  Products accumulate at the term level via
        ``np.multiply.at``; term values then segment-sum into per-invariant
        side values.
        """
        rows = []  # (inv_idx, side_sign, scale, const, rate_ids, sel_pairs)
        for i, c in enumerate(self.invariants):
            for side, which in ((c.lhs, 0), (c.rhs, 1)):
                for e in side:
                    rows.append((i, which, e.scale, e.const_add,
                                 e.rate_idx, e.sel_pairs))
        t = len(rows)
        self._m = len(self.invariants)
        self._t = t
        self._term_inv = np.array([r[0] for r in rows], np.int64)
        self._term_side = np.array([r[1] for r in rows], np.int64)
        self._term_scale = np.array([r[2] for r in rows], np.float64)
        self._term_const = np.array([r[3] for r in rows], np.float64)
        rate_idx, rate_seg, sel_idx, sel_seg = [], [], [], []
        for ti, r in enumerate(rows):
            for ri in r[4]:
                rate_idx.append(ri)
                rate_seg.append(ti)
            for p in r[5]:
                sel_idx.append(p)
                sel_seg.append(ti)
        self._rate_idx = np.asarray(rate_idx, np.int64)
        self._rate_seg = np.asarray(rate_seg, np.int64)
        self._sel_idx = np.asarray(sel_idx, np.int64).reshape(-1, 2)
        self._sel_seg = np.asarray(sel_seg, np.int64)

    def _sides(self, stat: Stat) -> Tuple[np.ndarray, np.ndarray]:
        m, t = self._m, self._t
        if m == 0:
            return np.zeros(0), np.zeros(0)
        prod = np.copy(self._term_scale)
        if len(self._rate_seg):
            np.multiply.at(prod, self._rate_seg, stat.rates[self._rate_idx])
        if len(self._sel_seg):
            np.multiply.at(
                prod, self._sel_seg,
                stat.sel[self._sel_idx[:, 0], self._sel_idx[:, 1]])
        term_val = self._term_const + prod
        lhs = np.zeros(m, np.float64)
        rhs = np.zeros(m, np.float64)
        is_rhs = self._term_side == 1
        np.add.at(lhs, self._term_inv[~is_rhs], term_val[~is_rhs])
        np.add.at(rhs, self._term_inv[is_rhs], term_val[is_rhs])
        return lhs, rhs

    def first_violation(self, stat: Stat) -> Optional[int]:
        """Index of the first violated invariant in plan order, else None."""
        lhs, rhs = self._sides(stat)
        # Strict crossing: on an exact tie a deterministic re-run of A can
        # legitimately re-pick the incumbent (tie-break), so firing on
        # equality would manufacture false positives.
        bad = lhs > (1.0 + self.d) * rhs
        idx = np.nonzero(bad)[0]
        return int(idx[0]) if idx.size else None

    def check(self, stat: Stat) -> bool:
        """``D(stat)``: true iff some invariant is violated (§3.2)."""
        return self.first_violation(stat) is not None

    def lower(self, n: int, max_inv: Optional[int] = None,
              max_terms: Optional[int] = None) -> "LoweredInvariants":
        """Lower this set into device tensors (see ``lower_invariants``)."""
        return lower_invariants(self.invariants, self.d, n,
                                max_inv=max_inv, max_terms=max_terms)

    def __len__(self) -> int:
        return len(self.invariants)


# ---------------------------------------------------------------------------
# Device lowering (§3.3-§3.5 at fleet scale)
# ---------------------------------------------------------------------------
#
# ``InvariantSet`` evaluates on the host in numpy.  For the fleet executor
# that forces a device→host statistics sync per partition per chunk, so the
# invariant set is *lowered* into fixed-shape tensors that evaluate on the
# device, in the same step as the joins:
#
#   term value  = const + scale · ∏_j rates[j]^rate_exp[j]
#                               · ∏_{jk} sel[j,k]^sel_exp[j,k]
#   side value  = Σ over the term axis
#   violated    = any(active ∧ lhs > (1+d)·rhs)
#
# Exponent form covers every ``Expr`` the planners emit (products of
# distinct statistics → exponents in {0, 1}) while keeping one static shape
# per (max_inv, max_terms, n) triple.  Padding rows have scale = const = 0,
# so they evaluate to exactly 0 on both sides and — with the strict ``>``
# and ``active`` mask — can never fire.


class LoweredInvariants(NamedTuple):
    """An invariant set as fixed-shape arrays (numpy on the host, torch
    tensors on the device).

    Shapes (I = max_inv, T = max_terms, n = pattern size); side axis is
    [0] = lhs, [1] = rhs.  Stacking K of these along a new leading axis
    yields the fleet's per-partition invariant matrix; deploying a fresh
    set for one partition writes one row of each field.
    """

    scale: np.ndarray     # (I, 2, T) f32
    const: np.ndarray     # (I, 2, T) f32
    rate_exp: np.ndarray  # (I, 2, T, n) f32
    sel_exp: np.ndarray   # (I, 2, T, n, n) f32
    active: np.ndarray    # (I,) bool
    d: np.ndarray         # ()  f32 — distance margin of this set


def lower_invariants(
    invariants: Sequence[DecidingCondition],
    d: float,
    n: int,
    max_inv: Optional[int] = None,
    max_terms: Optional[int] = None,
) -> LoweredInvariants:
    """Lower deciding conditions into ``LoweredInvariants`` tensors.

    ``max_inv`` / ``max_terms`` fix the static shape (so K lowered sets can
    be stacked and re-deployed row-wise without recompiling); they default
    to the exact sizes needed.  Raises ``ValueError`` when the set exceeds
    the caps — callers stacking across partitions should size the caps for
    the worst case their planner can emit.
    """
    need_i = len(invariants)
    need_t = max(
        [len(side) for c in invariants for side in (c.lhs, c.rhs)],
        default=1)
    i_cap = need_i if max_inv is None else int(max_inv)
    t_cap = need_t if max_terms is None else int(max_terms)
    if need_i > i_cap:
        raise ValueError(
            f"{need_i} invariants exceed max_inv={i_cap}; raise the cap")
    if need_t > t_cap:
        raise ValueError(
            f"{need_t} terms/side exceed max_terms={t_cap}; raise the cap")
    i_cap, t_cap = max(i_cap, 1), max(t_cap, 1)

    scale = np.zeros((i_cap, 2, t_cap), np.float32)
    const = np.zeros((i_cap, 2, t_cap), np.float32)
    rate_exp = np.zeros((i_cap, 2, t_cap, n), np.float32)
    sel_exp = np.zeros((i_cap, 2, t_cap, n, n), np.float32)
    active = np.zeros((i_cap,), bool)
    for i, c in enumerate(invariants):
        active[i] = True
        for s, side in enumerate((c.lhs, c.rhs)):
            for t, e in enumerate(side):
                scale[i, s, t] = e.scale
                const[i, s, t] = e.const_add
                for r in e.rate_idx:
                    rate_exp[i, s, t, r] += 1.0
                for (a, b) in e.sel_pairs:
                    sel_exp[i, s, t, a, b] += 1.0
    return LoweredInvariants(scale, const, rate_exp, sel_exp, active,
                             np.float32(d))


def stack_lowered(rows: Sequence[LoweredInvariants]) -> LoweredInvariants:
    """Stack per-partition lowered sets along a new leading K axis.

    The result's arrays are host numpy so the control plane can rewrite one
    partition's row in place on deployment (mirroring the plan matrix).
    """
    return LoweredInvariants(*(np.stack([np.asarray(getattr(r, f))
                                         for r in rows])
                               for f in LoweredInvariants._fields))


def write_lowered_row(stacked: LoweredInvariants, p: int,
                      row: LoweredInvariants) -> None:
    """Deploy a fresh invariant set for partition ``p``: one row write per
    field, never a recompile (shapes must match the stacked caps)."""
    for f in LoweredInvariants._fields:
        dst, src = getattr(stacked, f), np.asarray(getattr(row, f))
        if dst[p].shape != src.shape:
            raise ValueError(
                f"lowered field {f!r}: row shape {src.shape} != stacked "
                f"{dst[p].shape}; lower with the fleet's max_inv/max_terms")
        dst[p] = src


class StackedLowered:
    """Fleet invariant matrix: host-writable rows, device-cached tensors.

    The control plane rewrites one partition's row on deployment (numpy,
    in place); the data plane consumes ``device()``, torch tensors on the
    fleet's device, uploaded once.  A later ``write_row`` patches that one
    row of the device copy in place instead of re-uploading all K rows.
    With a ``mesh`` (``distributed.sharding``) ``device()`` is ``Blocks``,
    each block's rows on its device, and a row write patches the block
    that owns the partition.
    """

    def __init__(self, rows: Sequence[LoweredInvariants], device="cuda",
                 mesh=None):
        self.host = stack_lowered(rows)
        self.device_name = device
        self._layout = None
        if mesh is not None:
            from ..distributed.sharding import BlockLayout

            self._layout = BlockLayout(mesh, self.host.active.shape[0])
        self._dev = None

    def write_row(self, p: int, row: LoweredInvariants) -> None:
        write_lowered_row(self.host, p, row)
        if self._dev is not None:
            import torch

            dev, i = self._dev, p
            if self._layout is not None:
                b, i = self._layout.owner(p)
                dev = dev[b]
            for f in LoweredInvariants._fields:
                dst = getattr(dev, f)
                dst[i] = torch.as_tensor(np.asarray(getattr(row, f)),
                                         device=dst.device)

    def device(self):
        if self._dev is None:
            import torch

            if self._layout is not None:
                from ..distributed.sharding import Blocks

                self._dev = Blocks(
                    LoweredInvariants(*b) for b in self._layout.upload(
                        [np.array(x) for x in self.host]))
            else:
                self._dev = LoweredInvariants(*(
                    torch.as_tensor(np.array(x), device=self.device_name)
                    for x in self.host))
        return self._dev


def _lowered_sides(low: LoweredInvariants, rates, sel, xp):
    """Shared numpy evaluation: per-invariant (lhs, rhs) side values."""
    rt = xp.prod(rates[None, None, None, :] ** low.rate_exp, axis=-1)
    sl = xp.prod(sel[None, None, None, :, :] ** low.sel_exp, axis=(-2, -1))
    term = low.const + low.scale * rt * sl          # (I, 2, T)
    sides = term.sum(axis=-1)                       # (I, 2)
    return sides[:, 0], sides[:, 1]


def _ipow(x, e):
    """``x ** e`` for the lowered exponents, exact where they are 0 or 1
    (the planners emit products of distinct statistics)."""
    import torch

    return torch.where(e == 0, 1.0, torch.where(e == 1, x, x ** e))


def _prod_last(x):
    """Left-to-right product over the last axis (a fixed order, so the
    rounding does not depend on the device's reduction tree)."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out * x[..., i]
    return out


def _sum_last(x):
    """Left-to-right sum over the last axis: a fixed order, so the
    rounding (and a flag on the ``(1+d)`` boundary) does not depend on
    the device's reduction tree."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def eval_lowered(low: LoweredInvariants, rates, sel):
    """Device-side ``D`` for K partitions: (violated (K,) bool, drift (K,)
    f32).

    ``low`` fields carry a leading K axis (``StackedLowered.device()``),
    ``rates`` is (K, n) and ``sel`` (K, n, n).  ``drift`` is the §3.4-style
    signed relative margin of the tightest invariant —
    ``max_i (lhs − (1+d)·rhs) / max(min(|lhs|,|rhs|), ε)`` — positive iff
    violated; its magnitude is the telemetry distance.
    """
    import torch

    k = rates.shape[0]
    if low.active.shape[-1] == 0:
        return (torch.zeros(k, dtype=torch.bool, device=rates.device),
                torch.full((k,), -3.0e38, dtype=torch.float32,
                           device=rates.device))
    rt = _prod_last(_ipow(rates[:, None, None, None, :], low.rate_exp))
    sl = _prod_last(_ipow(sel[:, None, None, None, :, :],
                          low.sel_exp).flatten(-2))
    term = low.const + low.scale * rt * sl          # (K, I, 2, T)
    sides = _sum_last(term)                         # (K, I, 2)
    lhs, rhs = sides[..., 0], sides[..., 1]
    gap = lhs - (1.0 + low.d)[:, None] * rhs
    bad = low.active & (gap > 0.0)
    rel = gap / torch.clamp(torch.minimum(torch.abs(lhs), torch.abs(rhs)),
                            min=1e-12)
    drift = torch.where(low.active, rel, -3.0e38).amax(dim=-1)
    return bad.any(dim=-1), drift


def check_lowered_np(low: LoweredInvariants, rates: np.ndarray,
                     sel: np.ndarray) -> Tuple[bool, float]:
    """Host float32 mirror of ``eval_lowered`` (bit-level reference for the
    differential tests — same dtype, same operation order)."""
    if low.active.shape[0] == 0:
        return False, -3.0e38
    lhs, rhs = _lowered_sides(
        low, np.asarray(rates, np.float32), np.asarray(sel, np.float32), np)
    gap = lhs - (np.float32(1.0) + low.d) * rhs
    bad = low.active & (gap > 0.0)
    rel = gap / np.maximum(np.minimum(np.abs(lhs), np.abs(rhs)),
                           np.float32(1e-12))
    drift = float(np.max(np.where(low.active, rel, -3.0e38)))
    return bool(np.any(bad)), drift


def make_variance_violation_prob(
    std_rates: np.ndarray, std_sel: np.ndarray
) -> Callable[[DecidingCondition, Stat], float]:
    """§3.5 hook: a Gaussian first-order estimate of violation probability.

    Treats each statistic as independently normal around its current value
    with the supplied standard deviations; linearizes each side of the
    condition and returns P[lhs' >= rhs'] under the induced normal of the
    margin.  This is deliberately simple — the paper leaves the estimator
    open — but it is monotone in the right quantities (small margin, high
    variance ⇒ high probability).
    """
    from math import erf, sqrt

    def prob(c: DecidingCondition, stat: Stat) -> float:
        margin = c.margin(stat)
        var = 0.0
        for side, sign in ((c.lhs, -1.0), (c.rhs, 1.0)):
            for e in side:
                base = e.eval(stat) - e.const_add
                for r in e.rate_idx:
                    v = float(stat.rates[r])
                    if v > 0:
                        # d(term)/d(rate_r) = base / rate_r (product form)
                        var += (base / v * float(std_rates[r])) ** 2
                for i, j in e.sel_pairs:
                    v = float(stat.sel[i, j])
                    if v > 0:
                        var += (base / v * float(std_sel[i, j])) ** 2
        if var <= 0:
            return 0.0 if margin > 0 else 1.0
        z = margin / sqrt(var)
        return 0.5 * (1.0 - erf(z / sqrt(2.0)))

    return prob
