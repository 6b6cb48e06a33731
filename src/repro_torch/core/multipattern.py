"""Multi-pattern data plane: Q heterogeneous rules through one bucket step.

The port of ``repro.core.multipattern``.  ``core.engine`` runs ONE
pattern, whose structure (type ids, predicate op/attr/theta tensors, the
window, the negation and Kleene annotations, sequence-ness) is static.
Here that structure is data: every structural quantity becomes a tensor
with a leading **rule axis** (``Qb``), so one step evaluates a whole
*bucket* of same-arity rules.  Stacked next to the K-partition axis this
is the Q×K rulebook plane:

* ``RuleOps`` — the per-rule structural arrays (host-lowered from a
  ``Pattern`` by :func:`lower_rule`, stacked by :func:`stack_rule_ops`).
  Adding / removing / editing a rule is a **row write**; only growing the
  bucket's rule capacity changes a shape.
* ``BucketSpec`` — the static residue: arity ``n``, whether the bucket
  carries negation / Kleene post-blocks, the attribute width and the
  negation-predicate row capacity.  Buckets are padded with inert rows
  (:func:`pad_rule`) whose joins are empty by construction.
* **Sub-join sharing lattice** (after Kolchinsky & Schuster's
  join-query-sharing work, arXiv 1801.09413): rules whose plans open with
  the identical sub-join *chain* are grouped per depth; ``ShareOps.rep[d]``
  gathers the rule slot whose operands drive each depth-``d`` class,
  ``ShareOps.parent[d]`` chains each class to the depth-``d-1`` class it
  extends, and ``ShareOps.expand`` fans the final-depth partial-match sets
  out to every rule for the per-rule post-blocks.  Each shared sub-join
  runs once per class per step.

Where the reference ``vmap``s a one-rule function over (K, Qb) — or over
(K, U_d) at depth ``d`` of the lattice — the port flattens the two axes
into one leading batch axis (K · Qb, K · U_d) and calls the engine's
batched helpers (``_compact``, ``_row_counts``) and the kernels on it.
The rules' thresholds differ along that axis, so the packed join and the
row count take a ``(batch, C)`` threshold matrix.  The plan-constant half
of the join operands (the int8 op strips and the order anchors) is
derived on the host from the rule rows and the plan matrix, as the order
engine does (``build_rule_strips``), and refreshed per written row.

Bit-identity with the single-pattern engine, and with the reference, is
a design invariant: rule-varying structure enters only through op-code
strips whose inactive rows carry ``PRED_NONE`` — vacuous-true in the join
kernels — so the surviving masks, the compaction order and all counters
equal Q independent engines (``tests/test_torch_rulebook.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .engine import (Buffers, EngineConfig, MatchSet, _compact, _row_counts,
                     _validity_rows, make_spec)
from .patterns import PRED_GT, PRED_LT, PRED_NONE, Pattern

_LT = PRED_LT
_GT = PRED_GT
_NONE = PRED_NONE

# Kleene bound sentinel for "unbounded": large enough that min() is a no-op
# for any physical companion count, small enough to stay exact in int32.
KLEENE_UNBOUNDED = 1 << 30


# ---------------------------------------------------------------------------
# Bucket spec: the static residue of a rule set
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static shape of one arity bucket.

    Everything else a pattern specifies lives in ``RuleOps`` rows.  Two
    rules land in the same bucket iff they agree on this spec (with
    ``neg_rows_cap`` an upper bound, not an exact match).  ``n_attrs`` is
    the rulebook-wide attribute width — chunks are shared across rules, so
    every rule's buffers carry the same A.
    """

    n: int                 # pattern arity (primitive positions)
    has_neg: bool          # bucket carries the negation post-block
    has_kleene: bool       # bucket carries the Kleene post-block
    n_attrs: int           # shared attribute width A
    neg_rows_cap: int = 0  # max negated-predicate rows per rule

    @property
    def rows(self) -> int:
        """Ring-buffer rows per rule (one extra for the negated type)."""
        return self.n + (1 if self.has_neg else 0)


def packed_rule_row_count(n: int) -> int:
    """Packed constraint rows per plan step, bucket-wide: two rows for
    EVERY ordered position pair plus the two window and two
    sequence-anchor rows; rules activate their subset via the int8 op
    strip, the rest are ``PRED_NONE`` (vacuous-true)."""
    return 4 + n * (n - 1)


def _ordered_pairs(n: int) -> Tuple[Tuple[int, int], ...]:
    """Both orientations of every position pair, in strip-row order."""
    out = []
    for p in range(n):
        for q in range(p + 1, n):
            out.append((p, q))
            out.append((q, p))
    return tuple(out)


# ---------------------------------------------------------------------------
# RuleOps: one rule as data
# ---------------------------------------------------------------------------


class RuleOps(NamedTuple):
    """Structural arrays for one rule (numpy; stack along a leading Qb
    axis; the bucket's device copy holds the same fields as tensors).

    ``type_rows[r] == -1`` marks an inactive buffer row (padding slots
    ingest nothing, so their joins are empty).  ``has_neg``/``has_kleene``
    gate the post-blocks *per rule*, so a plain rule riding in a fused
    bucket that carries the blocks stays equal to its solo engine.
    """

    valid: np.ndarray        # ()  bool — False for padding slots
    window: np.ndarray       # ()  f32
    is_seq: np.ndarray       # ()  bool
    has_neg: np.ndarray      # ()  bool — rule uses the negation post-block
    has_kleene: np.ndarray   # ()  bool — rule uses the Kleene post-block
    type_rows: np.ndarray    # (rows,) i32 global type per buffer row
    op_t: np.ndarray         # (n, n) i32 predicate op codes
    a_attr: np.ndarray       # (n, n) i32
    b_attr: np.ndarray       # (n, n) i32
    theta: np.ndarray        # (n, n) f32
    ths: np.ndarray          # (C,) f32 packed per-row thresholds
    neg_pos: np.ndarray      # ()  i32 required-absence position
    neg_row_op: np.ndarray   # (Rn,) i32 negation predicate rows (padded)
    neg_row_pos: np.ndarray  # (Rn,) i32
    neg_row_ma: np.ndarray   # (Rn,) i32
    neg_row_na: np.ndarray   # (Rn,) i32
    neg_row_th: np.ndarray   # (Rn,) f32
    kleene_pos: np.ndarray   # ()  i32
    kleene_bound: np.ndarray  # () i32 (KLEENE_UNBOUNDED = no bound)


class ShareOps(NamedTuple):
    """Sub-join sharing lattice routing for one bucket (int64 index
    tensors on the device).

    One entry per lattice depth ``d in [0, n - 2]``; depth ``d`` holds the
    classes of the ``d + 2``-position sub-joins after plan step ``d + 1``.
    Classes are capacity-padded like rule slots (free classes compute
    values that are never fanned out).
    """

    rep: Tuple[torch.Tensor, ...]     # [d]: (U_d,) rule slot driving each
                                      #      depth-d class's operands
    parent: Tuple[torch.Tensor, ...]  # [d]: (U_d,) depth-(d-1) class each
                                      #      class extends (d=0: zeros)
    expand: torch.Tensor              # (Qb,) final-depth class per rule


class RulePlans(NamedTuple):
    """A (K, Qb) plan matrix with its plan-constant join operands (device
    tensors; ``build_rule_strips`` derives the strips on the host)."""

    order: torch.Tensor  # (K, Qb, n) i64 order rows
    ops8: torch.Tensor   # (K, Qb, n-1, C) i8 per-step op strips
    lo: torch.Tensor     # (K, Qb, n-1) i64 lower sequence anchor
    hi: torch.Tensor     # (K, Qb, n-1) i64 upper sequence anchor


class RuleStepResult(NamedTuple):
    """Per-rule counters for one chunk tick (each (K, Qb) int32)."""

    full: torch.Tensor      # full matches completed this chunk
    pm: torch.Tensor        # partial matches materialized
    overflow: torch.Tensor  # candidates dropped by m_cap
    closure: torch.Tensor   # Kleene companion count
    neg: torch.Tensor       # matches vetoed by negation


def lower_rule(pattern: Pattern, bspec: BucketSpec) -> RuleOps:
    """Lower one pattern into its bucket's row layout (host numpy).

    The bucket spec is a *superset* contract: a rule without negation /
    Kleene may ride in a bucket that carries those post-blocks; the rule's
    ``has_neg``/``has_kleene`` flags mask the blocks it does not use.
    """
    spec = make_spec(pattern)
    if spec.n != bspec.n:
        raise ValueError(f"rule arity {spec.n} != bucket arity {bspec.n}")
    if spec.has_neg and not bspec.has_neg:
        raise ValueError("rule needs negation; bucket has no neg post-block")
    if (spec.kleene_pos is not None) and not bspec.has_kleene:
        raise ValueError("rule needs Kleene; bucket has no Kleene post-block")
    if spec.n_attrs > bspec.n_attrs:
        raise ValueError(
            f"rule has {spec.n_attrs} attributes; rulebook width is "
            f"{bspec.n_attrs}")
    if len(spec.neg_rows) > bspec.neg_rows_cap:
        raise ValueError(
            f"{len(spec.neg_rows)} negation predicate rows exceed the "
            f"bucket capacity {bspec.neg_rows_cap}")
    n = bspec.n
    type_rows = list(spec.type_ids)
    if bspec.has_neg:
        # A rule without negation in a neg-capable bucket gets an inert
        # extra row (-1 ingests nothing, so its veto count is always 0).
        type_rows.append(spec.negated_type if spec.has_neg else -1)
    ths = [spec.window, spec.window, 0.0, 0.0]
    for (a, b_) in _ordered_pairs(n):
        ths.append(float(spec.theta_t[a, b_]))
    rn = bspec.neg_rows_cap
    nr_op = np.zeros((rn,), np.int32)
    nr_pos = np.zeros((rn,), np.int32)
    nr_ma = np.zeros((rn,), np.int32)
    nr_na = np.zeros((rn,), np.int32)
    nr_th = np.zeros((rn,), np.float32)
    for i, (pos, op, ma, na, th) in enumerate(spec.neg_rows):
        nr_op[i], nr_pos[i], nr_ma[i], nr_na[i], nr_th[i] = (
            op, pos, ma, na, th)
    return RuleOps(
        valid=np.asarray(True),
        window=np.float32(spec.window),
        is_seq=np.asarray(bool(spec.is_seq)),
        has_neg=np.asarray(bool(spec.has_neg)),
        has_kleene=np.asarray(spec.kleene_pos is not None),
        type_rows=np.asarray(type_rows, np.int32),
        op_t=np.asarray(spec.op_t, np.int32),
        a_attr=np.asarray(spec.a_attr_t, np.int32),
        b_attr=np.asarray(spec.b_attr_t, np.int32),
        theta=np.asarray(spec.theta_t, np.float32),
        ths=np.asarray(ths, np.float32),
        neg_pos=np.int32(spec.negated_pos if spec.negated_pos is not None
                         else 0),
        neg_row_op=nr_op, neg_row_pos=nr_pos, neg_row_ma=nr_ma,
        neg_row_na=nr_na, neg_row_th=nr_th,
        kleene_pos=np.int32(spec.kleene_pos or 0),
        kleene_bound=np.int32(spec.kleene_bound
                              if spec.kleene_bound is not None
                              else KLEENE_UNBOUNDED),
    )


def pad_rule(bspec: BucketSpec) -> RuleOps:
    """An inert slot: ingests nothing, joins empty, counters masked out."""
    n, rn = bspec.n, bspec.neg_rows_cap
    return RuleOps(
        valid=np.asarray(False),
        window=np.float32(1.0),
        is_seq=np.asarray(False),
        has_neg=np.asarray(False),
        has_kleene=np.asarray(False),
        type_rows=np.full((bspec.rows,), -1, np.int32),
        op_t=np.zeros((n, n), np.int32),
        a_attr=np.zeros((n, n), np.int32),
        b_attr=np.zeros((n, n), np.int32),
        theta=np.zeros((n, n), np.float32),
        ths=np.zeros((packed_rule_row_count(n),), np.float32),
        neg_pos=np.int32(0),
        neg_row_op=np.zeros((rn,), np.int32),
        neg_row_pos=np.zeros((rn,), np.int32),
        neg_row_ma=np.zeros((rn,), np.int32),
        neg_row_na=np.zeros((rn,), np.int32),
        neg_row_th=np.zeros((rn,), np.float32),
        kleene_pos=np.int32(0),
        kleene_bound=np.int32(KLEENE_UNBOUNDED),
    )


def stack_rule_ops(rows: Sequence[RuleOps]) -> RuleOps:
    """Stack per-rule ops along the leading Qb axis (host numpy)."""
    return RuleOps(*(np.stack([np.asarray(getattr(r, f)) for r in rows])
                     for f in RuleOps._fields))


def build_rule_strips(bspec: BucketSpec, ops: RuleOps, order):
    """Per-step int8 op strips and order anchors for one rule's order plan
    (host numpy; ``ops`` is one rule's row).  Rows beyond the rule's own
    predicates carry ``PRED_NONE``, so the strip layout is bucket-wide.
    Returns (ops8 (n-1, C) i8, lo (n-1,) i64, hi (n-1,) i64)."""
    n = bspec.n
    order = [int(x) for x in np.asarray(order).reshape(-1)]
    is_seq = bool(ops.is_seq)
    pos = np.arange(n)
    member = pos == order[0]
    ops_steps, lo_steps, hi_steps = [], [], []
    for i in range(1, n):
        q = order[i]
        p_lo = int(np.where(member & (pos < q), pos, -1).max())
        p_hi = int(np.where(member & (pos > q), pos, n).min())
        # Sequence-anchor rows are always present in the bucket layout and
        # op-gated per rule (AND rules keep them vacuous).
        row_ops = [_LT, _GT,
                   _LT if is_seq and p_lo >= 0 else _NONE,
                   _GT if is_seq and p_hi < n else _NONE]
        for (a, b_) in _ordered_pairs(n):
            row_ops.append(int(ops.op_t[a, b_]) if member[a] and q == b_
                           else _NONE)
        ops_steps.append(row_ops)
        lo_steps.append(min(max(p_lo, 0), n - 1))
        hi_steps.append(min(max(p_hi, 0), n - 1))
        member = member | (pos == q)
    return (np.asarray(ops_steps, np.int8).reshape(n - 1,
                                                   packed_rule_row_count(n)),
            np.asarray(lo_steps, np.int64), np.asarray(hi_steps, np.int64))


# ---------------------------------------------------------------------------
# The engine's per-pattern helpers with the structure as data
# ---------------------------------------------------------------------------
#
# Every function below takes a flattened leading batch axis: (K·U) rows,
# each one (partition, rule or lattice class).  ``ops`` fields lead with
# that axis too (``take_ops``).


def take_rows(x, idx, k: int):
    """Rows ``idx`` of the per-partition axis of a flattened (K·U, ...)
    tensor -> (K·len(idx), ...); the reference's ``x[idx]`` under its
    vmap over K."""
    inner = x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))
    return inner.index_select(1, idx).reshape(
        (k * idx.shape[0],) + tuple(x.shape[1:]))


def take_state(x, idx):
    """Rule slots ``idx`` of a (K, Qb, ...) tensor, flattened to
    (K·len(idx), ...)."""
    return x.index_select(1, idx).reshape(
        (x.shape[0] * idx.shape[0],) + tuple(x.shape[2:]))


def take_ops(ops: RuleOps, idx, k: int) -> RuleOps:
    """Rule rows ``idx`` of the (Qb, ...) device ops, repeated over the K
    partitions: (K·len(idx), ...)."""
    def one(x):
        sel = x.index_select(0, idx)
        return sel.unsqueeze(0).expand((k,) + tuple(sel.shape)).reshape(
            (k * sel.shape[0],) + tuple(sel.shape[1:]))
    return RuleOps(*(one(x) for x in ops))


def _rule_ingest(bspec: BucketSpec, cfg: EngineConfig, buffers: Buffers,
                 chunk, type_rows) -> Buffers:
    """Route chunk events into every rule's ring rows (``engine._ingest``
    with the row→type map as data; ``-1`` rows match nothing).

    ``buffers`` lead with (K, Qb), ``chunk`` fields with K, ``type_rows``
    is (Qb, rows).  As in ``engine._ingest`` the reference's dropped
    scatter (slot ``b_cap``) goes to a scratch column that is sliced off.
    """
    bcap = cfg.b_cap
    k, qb = buffers.ptr.shape[:2]
    n_ev = chunk.type_id.shape[1]

    def widen(x):
        return torch.cat([x, torch.zeros_like(x[:, :, :, :1])], dim=3)

    ts, attr, valid = widen(buffers.ts), widen(buffers.attr), \
        widen(buffers.valid)
    ptr = buffers.ptr.clone()
    n_attrs = attr.shape[-1]
    src_ts = chunk.ts[:, None, :].expand(k, qb, n_ev)
    src_attr = chunk.attr[:, None].expand(k, qb, n_ev, n_attrs)
    for row in range(bspec.rows):  # static loop
        gid = type_rows[:, row].long()
        mask = ((chunk.type_id[:, None, :] == gid[None, :, None])
                & chunk.valid[:, None, :] & (gid >= 0)[None, :, None])
        kk = torch.cumsum(mask, dim=2, dtype=torch.int32) - 1
        slot = torch.where(mask, (ptr[:, :, row, None] + kk) % bcap,
                           bcap).long()
        ts[:, :, row].scatter_(2, slot, src_ts)
        attr[:, :, row].scatter_(
            2, slot[..., None].expand(-1, -1, -1, n_attrs), src_attr)
        valid[:, :, row].scatter_(2, slot, True)
        ptr[:, :, row] += mask.sum(dim=2, dtype=torch.int32)
    return Buffers(ts[:, :, :, :bcap].contiguous(),
                   attr[:, :, :, :bcap].contiguous(),
                   valid[:, :, :, :bcap].contiguous(), ptr)


def _rule_leaf(bspec: BucketSpec, cfg: EngineConfig, buffers: Buffers,
               row, pos, t0, window, out_rows: int) -> MatchSet:
    """One buffer row per batch element as a single-position match set
    (``engine._leaf`` with the row, position and window as data)."""
    n, b = bspec.n, cfg.b_cap
    kidx = torch.arange(row.shape[0], device=row.device)
    ts_b = buffers.ts[kidx, row]
    attr_b = buffers.attr[kidx, row]
    valid = buffers.valid[kidx, row] & (ts_b > (t0 - window)[:, None])
    onehot = torch.arange(n, device=row.device)[None, :] == pos[:, None]
    ts = torch.where(onehot[:, None, :], ts_b[:, :, None], 0.0)
    attr = torch.where(onehot[:, None, :, None], attr_b[:, :, None, :], 0.0)
    ms = MatchSet(ts, attr, ts_b, ts_b, valid, onehot)
    if out_rows != b:
        def pad(x):
            z = torch.zeros((x.shape[0], out_rows - b) + x.shape[2:],
                            dtype=x.dtype, device=x.device)
            return torch.cat([x, z], dim=1)

        ms = MatchSet(pad(ms.ts), pad(ms.attr), pad(ms.min_ts),
                      pad(ms.max_ts), pad(ms.valid), ms.member)
    return ms


def _rule_step(bspec: BucketSpec, cfg: EngineConfig, buffers: Buffers,
               ops: RuleOps, pm: MatchSet, q, sops, lo, hi, t0):
    """One plan step: gather + packed kernel + compaction (the twin of
    ``OrderEngine.packed_step``; the thresholds are the rules' packed
    ``ths`` rows, one per batch element)."""
    R = _rule_leaf(bspec, cfg, buffers, q, q, t0, ops.window, cfg.b_cap)
    kidx = torch.arange(q.shape[0], device=q.device)
    attr_b = buffers.attr[kidx, q]                       # (KU, B, A)
    Lr = [pm.max_ts, pm.min_ts, pm.ts[kidx, :, lo], pm.ts[kidx, :, hi]]
    Rr = [R.min_ts, R.max_ts, R.min_ts, R.min_ts]
    for (a, b_) in _ordered_pairs(bspec.n):
        Lr.append(pm.attr[:, :, a][kidx, :, ops.a_attr[:, a, b_].long()])
        Rr.append(attr_b[kidx, :, ops.b_attr[:, a, b_].long()])
    Ls = torch.stack([x.to(torch.float32) for x in Lr], dim=1)
    Rs = torch.stack([x.to(torch.float32) for x in Rr], dim=1)
    bits, counts = kops.window_join_packed_bits(
        Ls, Rs, sops.contiguous(), ops.ths.contiguous(), pm.valid, R.valid,
        backend=cfg.backend)
    return _compact(pm, R, bits, counts, cfg.m_cap, cfg.backend)


def _rule_finalize(bspec: BucketSpec, cfg: EngineConfig, ops: RuleOps,
                   buffers: Buffers, pm: MatchSet, t0, t1):
    """Completion filter + negation veto + Kleene count per batch element.

    Serving semantics (no born split): the rulebook deploys plan rows
    immediately — partial matches rebuild from the rings every chunk, so a
    row swap changes join *work*, never *which* matches are counted.  The
    negation / Kleene blocks are bucket-static; within a block the
    rule-varying pieces (positions, ops, thresholds, the window) are data.
    Window rows are inlined with the rule's window as a per-batch
    threshold (``engine._window_rows`` takes one float).
    """
    n = bspec.n
    kq, m = pm.valid.shape
    b = cfg.b_cap
    dev = pm.valid.device
    kidx = torch.arange(kq, device=dev)
    W = ops.window
    horizon = (t0 - W)[:, None]
    completed = pm.valid & (pm.max_ts > t0) & (pm.max_ts <= t1)
    neg_rejected = torch.zeros(kq, dtype=torch.int32, device=dev)

    if bspec.has_neg:
        row = n
        nts = buffers.ts[:, row]
        nvalid = buffers.valid[:, row] & (nts > horizon)
        attr_n = buffers.attr[:, row]
        rows = _validity_rows(completed, nvalid)
        rows += [(pm.max_ts, nts, _LT, W), (pm.min_ts, nts, _GT, W)]
        np_ = ops.neg_pos.long()
        rows.append((pm.ts[kidx, :, torch.clamp(np_ - 1, 0, n - 1)], nts,
                     torch.where(np_ > 0, _LT, _NONE), 0.0))
        rows.append((pm.ts[kidx, :, torch.clamp(np_, 0, n - 1)], nts,
                     torch.where(np_ < n, _GT, _NONE), 0.0))
        for i in range(bspec.neg_rows_cap):  # static loop, op-gated rows
            rows.append((pm.attr[kidx, :, ops.neg_row_pos[:, i].long(),
                                 ops.neg_row_ma[:, i].long()],
                         attr_n[kidx, :, ops.neg_row_na[:, i].long()],
                         ops.neg_row_op[:, i], ops.neg_row_th[:, i]))
        cnt = _row_counts(cfg, rows, kq, m, b, dev)
        veto = (cnt > 0) & ops.has_neg[:, None]  # fused buckets: per rule
        neg_rejected = (completed & veto).sum(dim=1, dtype=torch.int32)
        completed = completed & ~veto

    closure = torch.zeros(kq, dtype=torch.int32, device=dev)
    if bspec.has_kleene:
        kp = ops.kleene_pos.long()
        kts = buffers.ts[kidx, kp]
        kvalid = buffers.valid[kidx, kp] & (kts > horizon)
        attr_k = buffers.attr[kidx, kp]
        rows = _validity_rows(completed, kvalid)
        rows += [(pm.max_ts, kts, _LT, W), (pm.min_ts, kts, _GT, W)]
        rows.append((pm.ts[kidx, :, torch.clamp(kp - 1, 0, n - 1)], kts,
                     torch.where(ops.is_seq & (kp > 0), _LT, _NONE), 0.0))
        rows.append((pm.ts[kidx, :, torch.clamp(kp + 1, 0, n - 1)], kts,
                     torch.where(ops.is_seq & (kp < n - 1), _GT, _NONE),
                     0.0))
        for o in range(n):  # static loop over partner positions
            op = torch.where(kp == o, _NONE, ops.op_t[kidx, o, kp])
            rows.append((
                pm.attr[:, :, o][kidx, :, ops.a_attr[kidx, o, kp].long()],
                attr_k[kidx, :, ops.b_attr[kidx, o, kp].long()],
                op, ops.theta[kidx, o, kp]))
        cnt = _row_counts(cfg, rows, kq, m, b, dev)
        comp = torch.minimum(torch.clamp(cnt - 1, min=0),
                             ops.kleene_bound[:, None])
        # Non-Kleene rules in a fused bucket point kleene_pos at a real
        # row; gating (not just masking padding) is what keeps them exact.
        closure = torch.where(ops.has_kleene[:, None] & completed, comp,
                              0).sum(dim=1, dtype=torch.int32)

    return completed.sum(dim=1, dtype=torch.int32), neg_rejected, closure


def _observe(bspec: BucketSpec, ops: RuleOps, chunk):
    """Per-rule monitored observation for K partitions × Qb rules
    (``stats.chunk_observations`` with the pair structure as data).
    Pairs without a predicate contribute exactly 0 trials/hits.  Returns
    counts (K, Qb, n), trials and hits (K, Qb, n, n), f32."""
    n = bspec.n
    k = chunk.type_id.shape[0]
    qb = ops.valid.shape[0]
    dev = chunk.type_id.device
    masks = [chunk.valid[:, None, :]
             & (chunk.type_id[:, None, :] == ops.type_rows[None, :, p, None])
             for p in range(n)]                               # (K, Qb, N)
    counts = torch.stack([mk.sum(dim=2).to(torch.float32) for mk in masks],
                         dim=2)
    trials = torch.zeros((k, qb, n, n), dtype=torch.float32, device=dev)
    hits = torch.zeros_like(trials)
    attr_t = chunk.attr.transpose(1, 2)                       # (K, A, N)
    for p in range(n):
        for q in range(p + 1, n):
            op = ops.op_t[:, p, q][None, :, None, None]
            th = ops.theta[:, p, q][None, :, None, None]
            a = attr_t[:, ops.a_attr[:, p, q].long()][..., :, None]
            b = attr_t[:, ops.b_attr[:, p, q].long()][..., None, :]
            lt = a < b + th
            gt = a > b - th
            ab = torch.abs(a - b) <= th
            ok = torch.where(op == _LT, lt, torch.where(op == _GT, gt, ab))
            pair_mask = masks[p][..., :, None] & masks[q][..., None, :]
            has = ops.op_t[:, p, q] != _NONE
            t_pq = torch.where(has, counts[:, :, p] * counts[:, :, q], 0.0)
            h_pq = torch.where(has, (ok & pair_mask).sum(dim=(2, 3)).to(
                torch.float32), 0.0)
            trials[:, :, p, q] = t_pq
            trials[:, :, q, p] = t_pq
            hits[:, :, p, q] = h_pq
            hits[:, :, q, p] = h_pq
    return counts, trials, hits


# ---------------------------------------------------------------------------
# The bucket step: ingest -> shared sub-join lattice -> per-rule post-blocks
# ---------------------------------------------------------------------------


def _make_bucket_step(bspec: BucketSpec, cfg: EngineConfig,
                      monitored: bool, laplace: float):
    """The bucket step for K partitions::

        step(state, monitor, chunk, ops, share, plans, lowered, t0, t1)
            -> (state, monitor, RuleStepResult, violated, drift, rates,
                sel)

    ``state`` (``Buffers``) and ``monitor`` (``MonitorState``) lead with
    (K, Qb), ``chunk`` fields with K, ``ops`` (device ``RuleOps``) with Qb,
    ``plans`` is a ``RulePlans``, ``lowered`` the (K, Qb) stacked
    ``LoweredInvariants``; ``t0``/``t1`` are 0-d f32 tensors.  Join work
    walks the lattice depth by depth — each depth extends its parent
    classes' partial-match sets by one plan step, once per class — and only
    the finalize post-blocks run per rule, on the final-depth sets fanned
    out through ``share.expand``.  Unmonitored steps take ``monitor`` and
    ``lowered`` as None and return None, zero flags, ``-inf`` drift and
    zero statistics.  Nothing in the step syncs with the host.
    """
    from .invariants import LoweredInvariants, eval_lowered
    from .stats import MonitorState, monitor_snapshot, monitor_update

    n = bspec.n

    def joins(state, chunk, ops, share, plans, t0, t1):
        k, qb = state.ptr.shape[:2]
        buffers = _rule_ingest(bspec, cfg, state, chunk, ops.type_rows)

        def operands(idx):
            return (Buffers(*(take_state(x, idx) for x in buffers)),
                    take_ops(ops, idx, k),
                    *(take_state(x, idx) for x in plans))

        # Depth 0: leaf + opening join once per depth-0 class.
        bufs, ops_d, order, s8, lo, hi = operands(share.rep[0])
        pm = _rule_leaf(bspec, cfg, bufs, order[:, 0], order[:, 0], t0,
                        ops_d.window, cfg.m_cap)
        tot = pm.valid.sum(dim=1, dtype=torch.int32)
        pm, tot_1, ov = _rule_step(bspec, cfg, bufs, ops_d, pm, order[:, 1],
                                   s8[:, 0], lo[:, 0], hi[:, 0], t0)
        tot = tot + tot_1
        # Interior depths: extend the parent class's set by one step, once
        # per class.
        for d in range(1, n - 1):
            bufs, ops_d, order, s8, lo, hi = operands(share.rep[d])
            pd = share.parent[d]
            pm = MatchSet(*(take_rows(x, pd, k) for x in pm))
            tot, ov = take_rows(tot, pd, k), take_rows(ov, pd, k)
            pm, created, ov_d = _rule_step(
                bspec, cfg, bufs, ops_d, pm, order[:, d + 1], s8[:, d],
                lo[:, d], hi[:, d], t0)
            tot, ov = tot + created, ov + ov_d
        # Fan the final-depth sets out to rules for the post-blocks.
        ex = share.expand
        pm = MatchSet(*(take_rows(x, ex, k) for x in pm))
        tot, ov = take_rows(tot, ex, k), take_rows(ov, ex, k)
        flat = Buffers(*(x.reshape((k * qb,) + tuple(x.shape[2:]))
                         for x in buffers))
        full, neg_rej, closure = _rule_finalize(
            bspec, cfg, take_ops(ops, torch.arange(qb, device=ex.device), k),
            flat, pm, t0, t1)
        live = ops.valid[None, :]
        res = RuleStepResult(*(torch.where(live, x.reshape(k, qb), 0)
                               for x in (full, tot, ov, closure, neg_rej)))
        return buffers, res

    def step(state, monitor, chunk, ops, share, plans, lowered, t0, t1):
        buffers, res = joins(state, chunk, ops, share, plans, t0, t1)
        k, qb = res.full.shape
        dev = res.full.device
        if not monitored:
            return (buffers, None, res,
                    torch.zeros((k, qb), dtype=torch.bool, device=dev),
                    torch.full((k, qb), -3.0e38, dtype=torch.float32,
                               device=dev),
                    torch.zeros((k, qb, n), dtype=torch.float32, device=dev),
                    torch.zeros((k, qb, n, n), dtype=torch.float32,
                                device=dev))
        counts, trials, hits = _observe(bspec, ops, chunk)

        def flat(x):
            return x.reshape((k * qb,) + tuple(x.shape[2:]))

        mon = monitor_update(MonitorState(*(flat(x) for x in monitor)),
                             flat(counts), (t1 - t0).expand(k * qb),
                             flat(trials), flat(hits))
        rates, sel = monitor_snapshot(mon, laplace)
        violated, drift = eval_lowered(
            LoweredInvariants(*(flat(x) for x in lowered)), rates, sel)
        monitor = MonitorState(*(x.reshape((k, qb) + tuple(x.shape[1:]))
                                 for x in mon))
        violated = violated.reshape(k, qb) & ops.valid[None, :]
        return (buffers, monitor, res, violated, drift.reshape(k, qb),
                rates.reshape(k, qb, n), sel.reshape(k, qb, n, n))

    return step


class RulebookPlane:
    """One bucket config's per-chunk plane, the value of
    :func:`make_rulebook_plane`'s memo entry: ``step(state, monitor,
    chunk, ops, share, plans, lowered, t0, t1)``, sharded over the mesh
    when one is given.  The rule capacity Qb is whatever the tensors it is
    given hold.  The step runs eagerly; the superchunk window that
    captures it is ``core.scan.make_rulebook_scan``'s.
    """

    def __init__(self, bspec: BucketSpec, cfg: EngineConfig,
                 monitored: bool, laplace: float = 1.0, mesh=None):
        self.step = _shard_plane(
            _make_bucket_step(bspec, cfg, monitored, laplace), mesh)


def make_rulebook_plane(bspec: BucketSpec, cfg: EngineConfig, k: int,
                        monitored: bool, laplace: float = 1.0,
                        mesh=None) -> RulebookPlane:
    """The K x Qb plane of this bucket config, from the process-wide memo.

    The memo key deliberately excludes the rule capacity Qb: a grown
    bucket keeps its plane, and two rulebooks with equal config share
    their planes.  Meshed planes are never shared, mirroring
    ``FleetEngine``.
    """
    from .fleet import _memo_config, _shared_trace

    key = (None if mesh is not None
           else ("rulebook", bspec, _memo_config(cfg), int(k),
                 bool(monitored), float(laplace)))
    return _shared_trace(key, lambda: RulebookPlane(
        bspec, cfg, monitored, laplace, mesh))


def _shard_plane(fn, mesh):
    """Shard the bucket step over a 1-D "cep" mesh: state, monitor, chunk,
    plans and lowered lead with K; the rule rows, the lattice routing and
    the clock are fleet-wide (replicated).  ``sharding.shard_fleet_fn``
    K-leads every argument, which the rulebook signature violates, so the
    specs are spelled per argument here."""
    if mesh is None:
        return fn
    from ..distributed.sharding import fleet_pspec, shard_map

    kl = fleet_pspec()
    return shard_map(fn, mesh, (kl, kl, kl, None, None, kl, kl, None, None),
                     kl)


# ---------------------------------------------------------------------------
# State constructors
# ---------------------------------------------------------------------------


def init_rule_buffers(bspec: BucketSpec, cfg: EngineConfig, k: int,
                      q_cap: int, device) -> Buffers:
    """Stacked ring buffers for one bucket: every leaf leads with (K, Qb)."""
    t, b, a = bspec.rows, cfg.b_cap, bspec.n_attrs
    return Buffers(
        ts=torch.zeros((k, q_cap, t, b), dtype=torch.float32, device=device),
        attr=torch.zeros((k, q_cap, t, b, a), dtype=torch.float32,
                         device=device),
        valid=torch.zeros((k, q_cap, t, b), dtype=torch.bool, device=device),
        ptr=torch.zeros((k, q_cap, t), dtype=torch.int32, device=device),
    )


def init_rule_monitor(bspec: BucketSpec, k: int, q_cap: int,
                      num_buckets: int = 16, device="cuda"):
    """Stacked statistics rings: every leaf leads with (K, Qb)."""
    from .stats import MonitorState, fleet_monitor_init

    one = fleet_monitor_init(k * q_cap, bspec.n, num_buckets, device)
    return MonitorState(*(x.reshape((k, q_cap) + tuple(x.shape[1:]))
                          for x in one))
