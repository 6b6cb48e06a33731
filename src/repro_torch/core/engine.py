"""Vectorized CEP evaluation engine (data plane) in PyTorch.

The port of ``repro.core.engine``: order plans (lazy-NFA style) and tree
plans (ZStream style).  The data structures are the reference's, with the
fleet's K partition axis written out as the leading dimension of every
tensor (where the reference vmaps one partition's function):

* **Per-type ring buffers** hold the recent stream history
  (struct-of-arrays, fixed capacity, masked): ``Buffers`` of ``(K, T, B)``.
* **Match sets are dense masked tensors**: ``(K, M_cap, n)`` timestamps and
  attributes, a validity mask and a per-partition position membership.
* **Every plan step is one masked windowed cross-join** of ``C`` constraint
  rows between ``M`` partial matches and ``B`` candidate events — a CUDA
  kernel on the card (packed for order plans, unpacked for tree plans),
  its plain version on the CPU, giving the mask as bit words and row
  counts — followed by a fixed-size compaction that reads only the rows
  holding a kept survivor.

Plans are data: an order plan enters as a ``(K, n)`` row matrix, a tree
plan as a ``(K, n-1, 2)`` slot-join matrix, so every partition runs its
own plan through the same calls and a replan never changes a shape.
Chunked semantics are the reference's: a match is counted exactly once, in
the chunk where its latest event arrives (``max_ts ∈ (t0, t1]``).
Negation is a post-join anti-filter against the negated type's buffer and
Kleene closure a bounded companion count, both through the rowcount
kernel.

Every ``StepResult`` counter is int32, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .compat import warn_legacy
from .patterns import PRED_GT, PRED_LT, PRED_NONE, Pattern
from .plans import TreeNode, TreePlan

_LT = PRED_LT
_GT = PRED_GT
_NONE = PRED_NONE

# Born-window sentinels (f32-safe ±inf), as in the reference.
NEG_INF = -3.0e38
POS_INF = 3.0e38

# Order-row strip lookups in ``OrderEngine.plan_operands``, for tests and
# probes: rows whose strips were derived, and rows served from the memo.
STRIP_COUNTS: Dict[str, int] = {"built": 0, "reused": 0}


def reset_strip_counts() -> None:
    for key in STRIP_COUNTS:
        STRIP_COUNTS[key] = 0


class Chunk(NamedTuple):
    """One stream chunk (struct-of-arrays), numpy or tensors; the fleet
    stacks K of them along a leading axis."""

    type_id: object  # (N,) i32 global event-type ids
    ts: object       # (N,) f32 timestamps (non-decreasing)
    attr: object     # (N, A) f32 attributes
    valid: object    # (N,) bool


class Buffers(NamedTuple):
    """Per-position ring buffers (+ one extra row for a negated type)."""

    ts: torch.Tensor     # (K, T, B) f32
    attr: torch.Tensor   # (K, T, B, A) f32
    valid: torch.Tensor  # (K, T, B) bool
    ptr: torch.Tensor    # (K, T) i32 cumulative writes


class MatchSet(NamedTuple):
    """A dense masked set of (partial) matches, per partition."""

    ts: torch.Tensor      # (K, M, n) f32 per-position timestamps
    attr: torch.Tensor    # (K, M, n, A) f32 per-position attributes
    min_ts: torch.Tensor  # (K, M) f32
    max_ts: torch.Tensor  # (K, M) f32
    valid: torch.Tensor   # (K, M) bool
    member: torch.Tensor  # (K, n) bool — positions filled in this set


class StepResult(NamedTuple):
    full_matches: torch.Tensor        # (K,) i32 — completed this chunk
    pm_created: torch.Tensor          # (K,) i32 — partial matches made
    overflow: torch.Tensor            # (K,) i32 — dropped by capacity
    closure_expansions: torch.Tensor  # (K,) i32 — Kleene companion count
    neg_rejected: torch.Tensor        # (K,) i32 — vetoed by negation


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    b_cap: int = 128   # ring-buffer capacity per event type
    m_cap: int = 256   # match-set row capacity (>= b_cap)
    backend: Optional[str] = None  # kernel backend override: ref | cuda
    device: str = "cuda"

    def __post_init__(self):
        if self.m_cap < self.b_cap:
            raise ValueError("m_cap must be >= b_cap")


def resolve_device(name) -> torch.device:
    """The torch device for ``name``; asking for CUDA without a GPU raises
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(name)!r} was asked for but torch sees no CUDA "
            "device; pass device='cpu' to run on the CPU")
    return dev


def canonical_device(name) -> torch.device:
    """``name`` as a torch device with its index: a bare "cuda" is the
    current CUDA device (device 0 where torch sees none), so "cuda" and
    "cuda:0" name one device."""
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    return dev


# ---------------------------------------------------------------------------
# Shared join machinery
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _const(values: tuple, dtype, device) -> torch.Tensor:
    """A small constant tensor, uploaded once per device: a blocking
    host-to-device copy in every chunk would also wait for the stream."""
    return torch.tensor(values, dtype=dtype, device=device)


def _row_values(x, shape, device):
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x, shape).to(torch.float32)
    return torch.full(shape, float(x), dtype=torch.float32, device=device)


def _row_ops(op, k, device):
    if isinstance(op, torch.Tensor):
        return op.to(torch.int32)
    return torch.full((k,), int(op), dtype=torch.int32, device=device)


def _rows_to_stacks(rows, k, m, b, device):
    """rows: list of (lvals (K, M) | scalar, rvals (K, B) | scalar, op,
    theta), op a static int or a per-batch (K,) tensor, theta a static
    float or a per-batch (K,) tensor -> (K, C, M), (K, C, B), (K, C) i32,
    and (C,) thresholds when every theta is static, else (K, C)."""
    L = torch.stack([_row_values(r[0], (k, m), device) for r in rows], dim=1)
    R = torch.stack([_row_values(r[1], (k, b), device) for r in rows], dim=1)
    if any(isinstance(r[2], torch.Tensor) for r in rows):
        ops_ = torch.stack([_row_ops(r[2], k, device) for r in rows], dim=1)
    else:
        ops_ = _const(tuple(int(r[2]) for r in rows), torch.int32,
                      device).expand(k, -1).contiguous()
    if any(isinstance(r[3], torch.Tensor) for r in rows):
        ths = torch.stack([_row_values(r[3], (k,), device) for r in rows],
                          dim=1)
    else:
        ths = _const(tuple(float(r[3]) for r in rows), torch.float32,
                     device)
    return L, R, ops_, ths


def _validity_rows(l_valid, r_valid):
    return [
        (l_valid.to(torch.float32), 1.0, _GT, 0.5),
        (1.0, r_valid.to(torch.float32), _LT, 0.5),
    ]


def _window_rows(l_min, l_max, r_min, r_max, window):
    # span(L ∪ R) <= W  ⇔  maxL < minR + W  ∧  minL > maxR − W.
    return [
        (l_max, r_min, _LT, float(window)),
        (l_min, r_max, _GT, float(window)),
    ]


def _pred_rows(spec, L: MatchSet, R: MatchSet):
    """Two orientation rows per static predicate pair; each row's op is
    per partition, live only where ``a`` is in L's membership and ``b`` in
    R's (the reference's ``jnp.where(active, op_t, NONE)``)."""
    rows = []
    for (p, q) in spec.pred_pairs:
        for (a, b_) in ((p, q), (q, p)):
            active = L.member[:, a] & R.member[:, b_]
            op = torch.where(active, int(spec.op_t[a, b_]), _NONE)
            lv = L.attr[:, :, a, int(spec.a_attr_t[a, b_])]
            rv = R.attr[:, :, b_, int(spec.b_attr_t[a, b_])]
            rows.append((lv, rv, op, spec.theta_t[a, b_]))
    return rows


def _gather_rows(x, idx):
    """x: (K, R, ...) gathered at per-partition row indices idx (K, S)."""
    kidx = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[kidx, idx]


def _compact(L: MatchSet, R: MatchSet, bits, row_counts, out_cap: int,
             backend):
    """Fixed-size compaction of the surviving (m, b) pairs into a MatchSet.

    The join gives its mask as bit words (K, M, ceil(B/32)) and per-row
    survivor counts (K, M).  The reference takes ``jnp.nonzero(size=
    out_cap, fill_value=m*b)``; ``kops.select_survivors`` gives the same
    row-major indices from the words, reading only the rows that hold a
    survivor below ``out_cap`` (a scan over the (K, M) row counts ranks
    them), so the output keeps row-major order (which decides the
    survivors once ``overflow > 0``), has a fixed size, and needs no host
    sync.  Slots past the last survivor point at ``m*b``, like the
    reference's fill value, and are invalid.
    """
    m = row_counts.shape[1]
    b = R.valid.shape[1]
    idx = kops.select_survivors(bits, row_counts, b, out_cap,
                                backend=backend)           # (K, out_cap)
    pm_created = row_counts.sum(dim=1, dtype=torch.int32)
    new_valid = idx < m * b
    mi = torch.clamp(idx // b, 0, m - 1)
    bi = torch.clamp(idx % b, 0, b - 1)

    memL = L.member[:, None, :]
    out = MatchSet(
        ts=torch.where(memL, _gather_rows(L.ts, mi), _gather_rows(R.ts, bi)),
        attr=torch.where(memL[..., None], _gather_rows(L.attr, mi),
                         _gather_rows(R.attr, bi)),
        min_ts=torch.minimum(_gather_rows(L.min_ts, mi),
                             _gather_rows(R.min_ts, bi)),
        max_ts=torch.maximum(_gather_rows(L.max_ts, mi),
                             _gather_rows(R.max_ts, bi)),
        valid=new_valid,
        member=L.member | R.member,
    )
    overflow = torch.clamp(pm_created - out_cap, min=0).to(torch.int32)
    return out, pm_created, overflow


def _join(spec, cfg, L: MatchSet, R: MatchSet, order_rows,
          out_cap: int):
    """One tree step: the unpacked constraint cross-join + compaction.
    ``pm_created`` is the sum of the join's row counts."""
    k, m = L.valid.shape
    b = R.valid.shape[1]
    rows = (
        _validity_rows(L.valid, R.valid)
        + _window_rows(L.min_ts, L.max_ts, R.min_ts, R.max_ts, spec.window)
        + order_rows
        + _pred_rows(spec, L, R)
    )
    Ls, Rs, ops_, ths = _rows_to_stacks(rows, k, m, b, L.valid.device)
    bits, counts = kops.window_join_bits(Ls, Rs, ops_, ths,
                                         backend=cfg.backend)
    return _compact(L, R, bits, counts, out_cap, cfg.backend)


def _row_counts(cfg, rows, k, m, b, device):
    """Per-m 'compatible event' counts (negation veto / Kleene count),
    through the rowcount kernel: the (M, B) mask is never stored."""
    Ls, Rs, ops_, ths = _rows_to_stacks(rows, k, m, b, device)
    return kops.window_join_rowcount(Ls, Rs, ops_, ths, backend=cfg.backend)


# ---------------------------------------------------------------------------
# Spec: static pattern-derived data
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Spec:
    n: int
    n_attrs: int
    window: float
    is_seq: bool
    pred_pairs: Tuple[Tuple[int, int], ...]
    op_t: np.ndarray
    a_attr_t: np.ndarray
    b_attr_t: np.ndarray
    theta_t: np.ndarray
    kleene_pos: Optional[int]
    kleene_bound: Optional[int]
    has_neg: bool
    negated_pos: Optional[int]
    # negated-predicate rows: (match_pos, op, match_attr, neg_attr, theta)
    neg_rows: Tuple[Tuple[int, int, int, int, float], ...]
    type_ids: Tuple[int, ...]
    negated_type: Optional[int]


def make_spec(pattern: Pattern) -> _Spec:
    t = pattern.pred_tensors()
    mirror = {PRED_NONE: PRED_NONE, PRED_LT: PRED_GT, PRED_GT: PRED_LT, 3: 3}
    neg_rows = []
    if pattern.negated_type is not None:
        pos_of = {tid: p for p, tid in enumerate(pattern.type_ids)}
        for pr in pattern.negated_predicates:
            if pr.a_type == pattern.negated_type:
                # cmp(neg, match) -> mirror so the match side is L.
                neg_rows.append((pos_of[pr.b_type], mirror[pr.op],
                                 pr.b_attr, pr.a_attr, pr.theta))
            else:
                neg_rows.append((pos_of[pr.a_type], pr.op,
                                 pr.a_attr, pr.b_attr, pr.theta))
    return _Spec(
        n=pattern.n,
        n_attrs=pattern.n_attrs,
        window=pattern.window,
        is_seq=pattern.is_sequence,
        pred_pairs=pattern.selectivity_pairs(),
        op_t=t["op"],
        a_attr_t=t["a_attr"],
        b_attr_t=t["b_attr"],
        theta_t=t["theta"],
        kleene_pos=pattern.kleene_pos,
        kleene_bound=pattern.kleene_bound,
        has_neg=pattern.negated_type is not None,
        negated_pos=pattern.negated_pos,
        neg_rows=tuple(neg_rows),
        type_ids=pattern.type_ids,
        negated_type=pattern.negated_type,
    )


# ---------------------------------------------------------------------------
# Buffers
# ---------------------------------------------------------------------------


def init_buffers(spec: _Spec, cfg: EngineConfig, k: int,
                 device) -> Buffers:
    t = spec.n + (1 if spec.has_neg else 0)
    b, a = cfg.b_cap, spec.n_attrs
    return Buffers(
        ts=torch.zeros((k, t, b), dtype=torch.float32, device=device),
        attr=torch.zeros((k, t, b, a), dtype=torch.float32, device=device),
        valid=torch.zeros((k, t, b), dtype=torch.bool, device=device),
        ptr=torch.zeros((k, t), dtype=torch.int32, device=device),
    )


def _ingest(spec: _Spec, cfg: EngineConfig, buffers: Buffers,
            chunk: Chunk) -> Buffers:
    """Route chunk events into their per-type ring buffers.

    The reference scatters with ``mode="drop"`` and slot ``b_cap`` as the
    drop sentinel; torch indexing raises out of range, so the scatter goes
    to a scratch column at index ``b_cap`` that is sliced off.  Limit:
    when one chunk carries more than ``b_cap`` events of one type, two of
    them land in the same slot and which one stays is unspecified (as it
    is for XLA's scatter); keep ``chunk_cap <= b_cap`` or sparser streams.
    """
    bcap = cfg.b_cap
    gids = list(spec.type_ids)
    if spec.has_neg:
        gids.append(spec.negated_type)

    def widen(x):
        return torch.cat([x, torch.zeros_like(x[:, :, :1])], dim=2)

    ts, attr, valid = widen(buffers.ts), widen(buffers.attr), \
        widen(buffers.valid)
    ptr = buffers.ptr.clone()
    n_attrs = attr.shape[-1]
    for row, gid in enumerate(gids):  # static loop, n+1 rows max
        mask = (chunk.type_id == gid) & chunk.valid              # (K, N)
        k = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
        slot = torch.where(mask, (ptr[:, row, None] + k) % bcap,
                           bcap).long()
        ts[:, row].scatter_(1, slot, chunk.ts)
        attr[:, row].scatter_(1, slot[..., None].expand(-1, -1, n_attrs),
                              chunk.attr)
        valid[:, row].scatter_(1, slot, True)
        ptr[:, row] += mask.sum(dim=1, dtype=torch.int32)
    return Buffers(ts[:, :, :bcap].contiguous(),
                   attr[:, :, :bcap].contiguous(),
                   valid[:, :, :bcap].contiguous(), ptr)


def _leaf(spec: _Spec, cfg: EngineConfig, buffers: Buffers, pos, t0,
          out_rows: int) -> MatchSet:
    """View one buffer row per partition (``pos`` (K,)) as a
    single-position match set, padded to ``out_rows``.

    Eviction threshold is ``t0 - W``: a match completed in (t0, t1] may
    reference events up to one window older than the chunk start.
    """
    n, b = spec.n, cfg.b_cap
    kidx = torch.arange(pos.shape[0], device=pos.device)
    ts_b = buffers.ts[kidx, pos]                          # (K, B)
    attr_b = buffers.attr[kidx, pos]                      # (K, B, A)
    valid = buffers.valid[kidx, pos] & (ts_b > (t0 - spec.window)[:, None])
    onehot = (torch.arange(n, device=pos.device)[None, :] == pos[:, None])
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


# ---------------------------------------------------------------------------
# Post-processing: completion filter, negation, Kleene
# ---------------------------------------------------------------------------


def _finalize(spec: _Spec, cfg: EngineConfig, buffers: Buffers,
              pm: MatchSet, t0, t1, born_lo, born_hi):
    """Count full matches completed in (t0, t1]; apply negation and Kleene.

    ``born_lo <= min_ts < born_hi`` implements the [36] plan-migration
    split (old plan: matches with a pre-replan event; new plan: matches
    born entirely after it — disjoint, so nothing is detected twice).
    All bounds are (K,) per-partition values.
    """
    n = spec.n
    k, m = pm.valid.shape
    b = cfg.b_cap
    dev = pm.valid.device
    completed = (pm.valid & (pm.max_ts > t0[:, None])
                 & (pm.max_ts <= t1[:, None])
                 & (pm.min_ts >= born_lo[:, None])
                 & (pm.min_ts < born_hi[:, None]))
    neg_rejected = torch.zeros(k, dtype=torch.int32, device=dev)
    horizon = (t0 - spec.window)[:, None]

    if spec.has_neg:
        row = n  # negated buffer row
        nts = buffers.ts[:, row]
        nvalid = buffers.valid[:, row] & (nts > horizon)
        rows = _validity_rows(completed, nvalid)
        rows += _window_rows(pm.min_ts, pm.max_ts, nts, nts, spec.window)
        np_ = spec.negated_pos
        if np_ is not None and np_ > 0:
            rows.append((pm.ts[:, :, np_ - 1], nts, _LT, 0.0))
        if np_ is not None and np_ < n:
            rows.append((pm.ts[:, :, np_], nts, _GT, 0.0))
        for (pos, op, ma, na, th) in spec.neg_rows:
            rows.append((pm.attr[:, :, pos, ma], buffers.attr[:, row, :, na],
                         op, th))
        veto = _row_counts(cfg, rows, k, m, b, dev) > 0
        neg_rejected = (completed & veto).sum(dim=1, dtype=torch.int32)
        completed = completed & ~veto

    closure = torch.zeros(k, dtype=torch.int32, device=dev)
    if spec.kleene_pos is not None:
        kp = spec.kleene_pos
        kts = buffers.ts[:, kp]
        kvalid = buffers.valid[:, kp] & (kts > horizon)
        rows = _validity_rows(completed, kvalid)
        rows += _window_rows(pm.min_ts, pm.max_ts, kts, kts, spec.window)
        if spec.is_seq and kp > 0:
            rows.append((pm.ts[:, :, kp - 1], kts, _LT, 0.0))
        if spec.is_seq and kp < n - 1:
            rows.append((pm.ts[:, :, kp + 1], kts, _GT, 0.0))
        for (p, q) in spec.pred_pairs:
            if q == kp:
                rows.append((pm.attr[:, :, p, spec.a_attr_t[p, kp]],
                             buffers.attr[:, kp, :, spec.b_attr_t[p, kp]],
                             spec.op_t[p, kp], spec.theta_t[p, kp]))
            elif p == kp:
                rows.append((pm.attr[:, :, q, spec.a_attr_t[q, kp]],
                             buffers.attr[:, kp, :, spec.b_attr_t[q, kp]],
                             spec.op_t[q, kp], spec.theta_t[q, kp]))
        cnt = _row_counts(cfg, rows, k, m, b, dev)
        comp = torch.clamp(cnt - 1, min=0)  # exclude the match's own
        if spec.kleene_bound is not None:
            comp = torch.clamp(comp, max=spec.kleene_bound)
        closure = torch.where(completed, comp, 0).sum(dim=1,
                                                      dtype=torch.int32)

    return completed.sum(dim=1, dtype=torch.int32), neg_rejected, closure


# ---------------------------------------------------------------------------
# Predicate strips: the plan-constant half of the join operands
# ---------------------------------------------------------------------------
#
# The constraint stack of plan step ``i`` splits into stream-dependent
# values (gathers from the ring buffers and the match set, every chunk) and
# plan-dependent structure (which op applies per row, which placed position
# anchors the sequence-order rows) — a function of the order row alone.
# ``build_order_strips`` derives the second half on the host, once per
# order row: ``OrderEngine`` keeps each row's strips, so a new plan matrix
# is stacked from strips already derived and builds only orders it has not
# seen.  Thresholds and attribute gather columns are static pattern data
# (``_packed_thetas`` / ``_pred_cols``).


class PredicateStrips(NamedTuple):
    """Plan-constant packed join operands for an order plan (n-1 steps)."""

    ops8: object    # (n-1, C) i8 — per-step op-code strip
    lo_idx: object  # (n-1,) i32 — clipped lower order-anchor position
    hi_idx: object  # (n-1,) i32 — clipped upper order-anchor position


class PlanOperands(NamedTuple):
    """A stacked (K, n) order-row matrix with its stacked strips, on the
    engine's device."""

    row: torch.Tensor  # (K, n) i64 order rows
    strips: PredicateStrips


def packed_row_count(spec: _Spec) -> int:
    """Rows in the packed constraint stack (validity lives in the masks)."""
    return 2 + (2 if spec.is_seq else 0) + 2 * len(spec.pred_pairs)


def _packed_thetas(spec: _Spec) -> np.ndarray:
    """Static per-row thresholds matching the packed row layout."""
    ths = [float(spec.window), float(spec.window)]
    if spec.is_seq:
        ths += [0.0, 0.0]
    for (p, q) in spec.pred_pairs:
        for (a, b_) in ((p, q), (q, p)):
            ths.append(float(spec.theta_t[a, b_]))
    return np.asarray(ths, np.float32)


def _pred_cols(spec: _Spec):
    """Static (a, b, a_attr_col, b_attr_col) per packed predicate row."""
    cols = []
    for (p, q) in spec.pred_pairs:
        for (a, b_) in ((p, q), (q, p)):
            cols.append((a, b_, int(spec.a_attr_t[a, b_]),
                         int(spec.b_attr_t[a, b_])))
    return tuple(cols)


def build_order_strips(spec: _Spec, order) -> PredicateStrips:
    """Derive the plan-constant strips from one order vector (numpy).

    Step ``i`` joins the accumulated prefix {order[0..i-1]} with the leaf
    of position ``order[i]``: a predicate row (a, b) fires iff ``a`` is
    already placed and ``b == order[i]``, and the sequence-order rows
    anchor on the nearest placed position below/above ``order[i]``.
    """
    n = spec.n
    C = packed_row_count(spec)
    order = [int(x) for x in np.asarray(order).reshape(-1)]
    ops_steps, lo_steps, hi_steps = [], [], []
    pos = np.arange(n)
    member = pos == order[0]
    for i in range(1, n):
        q = order[i]
        row_ops = [_LT, _GT]
        lo = hi = 0
        if spec.is_seq:
            p_lo = int(np.where(member & (pos < q), pos, -1).max())
            p_hi = int(np.where(member & (pos > q), pos, n).min())
            row_ops += [_LT if p_lo >= 0 else _NONE,
                        _GT if p_hi < n else _NONE]
            lo = min(max(p_lo, 0), n - 1)
            hi = min(max(p_hi, 0), n - 1)
        for (a, b_, _ac, _bc) in _pred_cols(spec):
            row_ops.append(int(spec.op_t[a, b_]) if member[a] and q == b_
                           else _NONE)
        ops_steps.append(row_ops)
        lo_steps.append(lo)
        hi_steps.append(hi)
        member = member | (pos == q)
    return PredicateStrips(
        ops8=np.asarray(ops_steps, np.int8).reshape(max(n - 1, 0), C),
        lo_idx=np.asarray(lo_steps, np.int32),
        hi_idx=np.asarray(hi_steps, np.int32))


# ---------------------------------------------------------------------------
# The shared engine base; the order-based engine (lazy-NFA style)
# ---------------------------------------------------------------------------


class _Engine:
    """What both plan families share: the pattern's spec, the config, the
    device, the state and the single-stream convenience.  A subclass maps
    a plan to its row (``plan_row``), a stacked row matrix to the device
    operands (``plan_operands``) and runs one chunk (``process``)."""

    def __init__(self, pattern: Pattern, cfg: EngineConfig = EngineConfig()):
        self.pattern = pattern
        self.spec = make_spec(pattern)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)

    def init_state(self, k: int = 1) -> Buffers:
        return init_buffers(self.spec, self.cfg, k, self.device)

    def single_stream(self, chunk: Chunk, t0, t1, born_lo, born_hi):
        """One unbatched chunk as a K = 1 batch on the device, and its
        clock ``(t0, t1, born_lo, born_hi)`` as (1,) f32 tensors from one
        host-to-device copy."""
        dev = self.device
        chunk = Chunk(*(torch.as_tensor(np.asarray(x), device=dev)[None]
                        for x in chunk))
        clock = torch.as_tensor(
            np.asarray([[t0], [t1], [born_lo], [born_hi]], np.float32),
            device=dev)
        return chunk, tuple(clock)

    def process_chunk(self, buffers: Buffers, chunk: Chunk, plan,
                      t0: float, t1: float, born_lo: float = NEG_INF,
                      born_hi: float = POS_INF):
        """Single-stream convenience (K = 1): unbatched chunk arrays, one
        plan; the buffers keep their leading K = 1 axis and the counters
        come back as (1,) tensors."""
        chunk, clock = self.single_stream(chunk, t0, t1, born_lo, born_hi)
        return self.process(buffers, chunk,
                            self.plan_operands(self.plan_row(plan)), *clock)


class OrderEngine(_Engine):
    """Executes order-based plans for K partitions at once; the (K, n)
    order-row matrix is an argument, so plans change without new shapes."""

    # Order rows whose strips are kept, least recently used out first:
    # every order of a SEQ of 6 (720) fits, so a replan derives at most
    # its own row's strips.
    _STRIPS_CAP = 4096

    def __init__(self, pattern: Pattern, cfg: EngineConfig = EngineConfig()):
        super().__init__(pattern, cfg)
        self._thetas = torch.as_tensor(_packed_thetas(self.spec),
                                       device=self.device)
        self._pred_cols = _pred_cols(self.spec)
        self._strips: "OrderedDict[bytes, PredicateStrips]" = OrderedDict()

    @staticmethod
    def plan_row(plan) -> np.ndarray:
        return np.asarray(plan.order, np.int32)

    def _row_strips(self, row: np.ndarray) -> PredicateStrips:
        """One int32 order row's strips: kept, or derived and kept."""
        key = row.tobytes()
        strips = self._strips.get(key)
        if strips is None:
            STRIP_COUNTS["built"] += 1
            strips = self._strips[key] = build_order_strips(self.spec, row)
            if len(self._strips) > self._STRIPS_CAP:
                self._strips.popitem(last=False)
        else:
            STRIP_COUNTS["reused"] += 1
            self._strips.move_to_end(key)
        return strips

    def plan_operands(self, rows) -> PlanOperands:
        """Stacked strips for a (K, n) row matrix (or one (n,) row, K = 1),
        each row's taken from the engine's memo (derived on the host the
        first time its order is seen), moved to the engine's device."""
        rows = np.atleast_2d(np.asarray(rows, np.int64))
        strips = [self._row_strips(r) for r in rows.astype(np.int32)]
        dev = self.device
        return PlanOperands(
            row=torch.as_tensor(rows, device=dev),
            strips=PredicateStrips(*(
                torch.as_tensor(np.stack([getattr(s, f) for s in strips]),
                                device=dev)
                for f in PredicateStrips._fields)))

    def packed_step(self, buffers, pm, q, sops, lo, hi, t0):
        """gather + packed kernel + compaction — one plan step."""
        spec, cfg = self.spec, self.cfg
        R = _leaf(spec, cfg, buffers, q, t0, cfg.b_cap)
        kidx = torch.arange(q.shape[0], device=q.device)
        attr_b = buffers.attr[kidx, q]                     # (K, B, A)
        Lr = [pm.max_ts, pm.min_ts]
        Rr = [R.min_ts, R.max_ts]
        if spec.is_seq:
            Lr += [pm.ts[kidx, :, lo], pm.ts[kidx, :, hi]]
            Rr += [R.min_ts, R.min_ts]
        for (a, _b, ac, bc) in self._pred_cols:
            Lr.append(pm.attr[:, :, a, ac])
            Rr.append(attr_b[:, :, bc])
        Ls = torch.stack([x.to(torch.float32) for x in Lr], dim=1)
        Rs = torch.stack([x.to(torch.float32) for x in Rr], dim=1)
        bits, counts = kops.window_join_packed_bits(
            Ls, Rs, sops.contiguous(), self._thetas, pm.valid, R.valid,
            backend=cfg.backend)
        return _compact(pm, R, bits, counts, cfg.m_cap, cfg.backend)

    def process(self, buffers: Buffers, chunk: Chunk, plan: PlanOperands,
                t0, t1, born_lo, born_hi) -> Tuple[Buffers, StepResult]:
        """One chunk for K partitions: ingest, leaf, n-1 packed steps,
        finalize.  ``chunk`` fields, ``t0``/``t1``/``born_*`` (K,) and the
        plan all carry the leading partition axis."""
        spec, cfg = self.spec, self.cfg
        order, strips = plan.row, plan.strips
        buffers = _ingest(spec, cfg, buffers, chunk)
        pm = _leaf(spec, cfg, buffers, order[:, 0], t0, cfg.m_cap)
        pm_total = pm.valid.sum(dim=1, dtype=torch.int32)
        overflow = torch.zeros_like(pm_total)
        for i in range(1, spec.n):  # static loop over plan steps
            pm, created, ov = self.packed_step(
                buffers, pm, order[:, i], strips.ops8[:, i - 1],
                strips.lo_idx[:, i - 1].long(),
                strips.hi_idx[:, i - 1].long(), t0)
            pm_total = pm_total + created
            overflow = overflow + ov
        full, neg_rej, closure = _finalize(
            spec, cfg, buffers, pm, t0, t1, born_lo, born_hi)
        return buffers, StepResult(full, pm_total, overflow, closure,
                                   neg_rej)


# ---------------------------------------------------------------------------
# Tree-based engine (ZStream style)
# ---------------------------------------------------------------------------


def tree_plan_to_slots(plan: TreePlan) -> np.ndarray:
    """Convert a TreePlan into an (n-1, 2) slot-join program.

    Slots 0..n-1 are the leaves (pattern positions); slot n+s is the result
    of join step s.  The interval DP guarantees every node's left child
    covers the earlier contiguous interval, which the tree engine's single
    cross-order constraint relies on for sequence patterns.
    """
    n = plan.n
    steps = []

    def walk(node: TreeNode) -> int:
        if node.is_leaf:
            return node.leaf
        li = walk(node.left)
        ri = walk(node.right)
        # Contiguity + ordering sanity (host-side).
        ll, rl = node.left.leaves(), node.right.leaves()
        leaves = sorted(ll + rl)
        assert leaves == list(range(leaves[0], leaves[-1] + 1)), (
            "tree engine requires contiguous-interval plans")
        assert max(ll) < min(rl), "left child must cover earlier interval"
        sid = n + len(steps)
        steps.append((li, ri))
        return sid

    walk(plan.root)
    return np.asarray(steps, np.int32).reshape(len(steps), 2)


class TreeEngine(_Engine):
    """Executes tree-based plans for K partitions at once; the
    (K, n-1, 2) slot-join matrix is an argument, so plans change without
    new shapes."""

    plan_row = staticmethod(tree_plan_to_slots)

    def plan_operands(self, rows) -> torch.Tensor:
        """A (K, n-1, 2) slot matrix (or one (n-1, 2) program, K = 1) on
        the engine's device."""
        rows = np.asarray(rows, np.int64)
        if rows.ndim == 2:
            rows = rows[None]
        return torch.as_tensor(rows, device=self.device)

    def process(self, buffers: Buffers, chunk: Chunk, steps: torch.Tensor,
                t0, t1, born_lo, born_hi) -> Tuple[Buffers, StepResult]:
        """One chunk for K partitions: ingest, n leaves, n-1 slot joins,
        finalize.  ``steps`` is the (K, n-1, 2) slot matrix; the other
        arguments are as in ``OrderEngine.process``."""
        spec, cfg = self.spec, self.cfg
        n, m = spec.n, cfg.m_cap
        k = steps.shape[0]
        dev = steps.device
        buffers = _ingest(spec, cfg, buffers, chunk)
        leaves = [_leaf(spec, cfg, buffers,
                        torch.full((k,), p, dtype=torch.long, device=dev),
                        t0, m) for p in range(n)]

        # Stacked slots (K, 2n-1, ...): leaves first, then one per join
        # step, zeroed (empty, no members) until the step writes it.
        def stack(xs):
            out = torch.zeros((k, 2 * n - 1) + xs[0].shape[1:],
                              dtype=xs[0].dtype, device=dev)
            out[:, :n] = torch.stack(xs, dim=1)
            return out

        slots = MatchSet(*(stack(xs) for xs in zip(*leaves)))
        # Leaf cardinalities count as materialized state (ZStream cost).
        pm_total = sum(leaf.valid.sum(dim=1, dtype=torch.int32)
                       for leaf in leaves)
        overflow = torch.zeros_like(pm_total)
        kidx = torch.arange(k, device=dev)
        pm = leaves[0]
        for s in range(n - 1):  # static loop; slot gathers are per partition
            L = MatchSet(*(x[kidx, steps[:, s, 0]] for x in slots))
            R = MatchSet(*(x[kidx, steps[:, s, 1]] for x in slots))
            rows = [(L.max_ts, R.min_ts, _LT, 0.0)] if spec.is_seq else []
            pm, created, ov = _join(spec, cfg, L, R, rows, m)
            pm_total = pm_total + created
            overflow = overflow + ov
            # The reference rebuilds the slot stack with .at[n + s].set;
            # the port writes the step's slot in place.
            for x, new in zip(slots, pm):
                x[:, n + s] = new
        full, neg_rej, closure = _finalize(
            spec, cfg, buffers, pm, t0, t1, born_lo, born_hi)
        return buffers, StepResult(full, pm_total, overflow, closure,
                                   neg_rej)


def _make_engine(kind: str, pattern: Pattern,
                 cfg: EngineConfig = EngineConfig()):
    if kind == "order":
        return OrderEngine(pattern, cfg)
    if kind == "tree":
        return TreeEngine(pattern, cfg)
    raise ValueError(f"unknown engine kind {kind!r}")


def make_engine(kind: str, pattern: Pattern,
                cfg: EngineConfig = EngineConfig()):
    """Deprecated: the ``repro_torch.cep`` facade selects the plan family
    via ``cep.open(..., plan="order"|"tree"|"auto")``."""
    warn_legacy("make_engine")
    return _make_engine(kind, pattern, cfg)


# ---------------------------------------------------------------------------
# Device-resident monitoring: process + statistics + invariants in one step
# ---------------------------------------------------------------------------


def make_monitored_process(process_fn, spec: _Spec, laplace: float = 1.0):
    """Fuse a plan-execution step with invariant monitoring (paper §3.3-§3.5).

    The returned function runs, for K partitions on the device:

    1. the join cascade (``process_fn`` — the plan is still data);
    2. the per-chunk statistics observation (``stats.chunk_observations``)
       and the sliding-window ring update (``stats.monitor_update``);
    3. the lowered deciding-condition evaluation
       (``invariants.eval_lowered``) over the fresh snapshot.

    It returns ``(buffers, monitor, StepResult, violated (K,), drift (K,),
    rates (K, n), sel (K, n, n))``.  Only ``violated`` and ``drift`` need
    to reach the host each chunk; ``rates``/``sel`` stay on the device and
    are pulled only for partitions whose flag fired.
    """
    from .invariants import eval_lowered
    from .stats import chunk_observations, monitor_snapshot, monitor_update

    pred_tensors = {"op": spec.op_t, "a_attr": spec.a_attr_t,
                    "b_attr": spec.b_attr_t, "theta": spec.theta_t}

    def mprocess(buffers, monitor, chunk, plan, lowered, t0, t1,
                 born_lo, born_hi):
        buffers, res = process_fn(buffers, chunk, plan, t0, t1,
                                  born_lo, born_hi)
        counts, trials, hits = chunk_observations(
            chunk.type_id, chunk.attr, chunk.valid, spec.type_ids,
            pred_tensors)
        monitor = monitor_update(monitor, counts, t1 - t0, trials, hits)
        rates, sel = monitor_snapshot(monitor, laplace)
        violated, drift = eval_lowered(lowered, rates, sel)
        return buffers, monitor, res, violated, drift, rates, sel

    return mprocess


class MonitoredEngine:
    """Single-stream engine with the monitored step built in.

    The fleet executor (``fleet.FleetEngine``) runs the same fused step for
    K partitions; this wrapper is the K = 1 building block used by
    examples and tests.  Plans enter as rows (``plan_row``) and invariant
    sets as ``LoweredInvariants`` (host numpy, moved to the engine's device
    each call), so neither a replan nor an invariant redeployment changes
    a shape.  The buffers and the statistics ring keep their leading
    K = 1 axis; the counters, ``violated``, ``drift``, ``rates`` and
    ``sel`` come back without it, as the reference's do.
    """

    def __init__(self, kind: str, pattern: Pattern,
                 cfg: EngineConfig = EngineConfig(),
                 monitor_buckets: int = 16, laplace: float = 1.0):
        warn_legacy("MonitoredEngine")
        self.base = _make_engine(kind, pattern, cfg)
        self.kind = kind
        self.pattern = pattern
        self.cfg = cfg
        self.device = self.base.device
        self.monitor_buckets = monitor_buckets
        self._step = make_monitored_process(self.base.process,
                                            self.base.spec, laplace)

    def init_state(self) -> Buffers:
        return self.base.init_state()

    def init_monitor(self):
        from .stats import monitor_init

        return monitor_init(self.pattern.n, self.monitor_buckets,
                            self.device)

    def plan_row(self, plan) -> np.ndarray:
        return self.base.plan_row(plan)

    def process_chunk(self, buffers, monitor, chunk, plan_row, lowered,
                      t0: float, t1: float,
                      born_lo: float = NEG_INF, born_hi: float = POS_INF):
        """One fused chunk: joins, statistics ring, invariants.  Returns
        ``(buffers, monitor, StepResult, violated, drift, rates, sel)``."""
        from .invariants import LoweredInvariants

        chunk, clock = self.base.single_stream(chunk, t0, t1, born_lo,
                                               born_hi)
        lowered = LoweredInvariants(*(
            torch.as_tensor(np.asarray(x), device=self.device)[None]
            for x in lowered))
        buffers, monitor, res, violated, drift, rates, sel = self._step(
            buffers, monitor, chunk, self.base.plan_operands(plan_row),
            lowered, *clock)
        return (buffers, monitor, StepResult(*(x[0] for x in res)),
                violated[0], drift[0], rates[0], sel[0])
