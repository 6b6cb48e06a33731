"""Rulebook: one data plane serving Q heterogeneous patterns.

The port of ``repro.cep.rulebook``.  ``cep.open`` gives one pattern one
data plane; a :class:`Rulebook` lowers Q patterns (any mix the ``P`` DSL
can build, minus OR-composites) into the stacked structural tensors of
``core.multipattern``: rules are bucketed by arity/shape, each bucket runs
Qb rules × K partitions through one step per chunk, and everything a rule
*is* lives in row ``q`` of the bucket's tensors:

* **hot add / remove are row writes.**  ``add_rule`` lowers the pattern
  into a free slot (ops row, plan rows, invariant rows, zeroed state
  rows, each a row write on the bucket's device tensors) and
  ``remove_rule`` masks a slot out; neither builds a kernel nor captures
  a graph.  Growing a full bucket's capacity changes its shapes: its next
  superchunk window captures again (``trace_count``).
* **adaptation is per (q, k) cell.**  Each cell owns an
  ``InvariantPolicy``; the monitored step returns a (K, Qb) violation
  bitmap and the host replans exactly the flagged cells, deploying the
  fresh plan + lowered invariant set as row writes.
* **common sub-joins run once, at every depth** (the sharing lattice of
  arXiv 1801.09413): rules whose cold plans open on the same sub-join
  chain share a node; shared rules keep their common plan prefix pinned
  (``greedy_order_plan(pin=...)``) so later replans never break the
  share; hot-added rules start their own chain.  ``config.sharing``
  selects "lattice" (default), "prefix" or "none".
* **small buckets fuse** (``config.bucket_fusion``): rules of one arity
  share a bucket even when only some carry negation / Kleene post-blocks.
* **superchunk windows.**  ``config.superchunk = S`` runs S chunks per
  bucket per window (``core.scan.RulebookWindow``: on CUDA one replay of
  a captured graph per chunk, no host sync inside the window); a flag at
  in-window chunk ``f`` cuts the window there and the bucket continues
  from the carry after chunk ``f``, so replans deploy on the very next
  chunk and counters equal per-chunk stepping for every S.

Counter semantics are the serving front's: immediate deployment, no
migration split, exactly-once chunked counting — and per-rule counters
equal Q independent sessions over the same stream.

``host_syncs`` counts device-to-host reads as the reference does: one
coalesced counter read per bucket per chunk (per window under
``superchunk``) and one statistics read per tick or window with a flag.
The reference re-runs a window's prefix after an in-window flag and
counts that dispatch's read too; the port continues from a carry
snapshot instead, so its windowed ``host_syncs`` is the reference's less
``in_window_events``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import Chunk, EngineConfig, make_spec, resolve_device
from ..core.fleet import stack_chunks
from ..core.greedy import greedy_order_plan
from ..core.invariants import LoweredInvariants, lower_invariants
from ..core.multipattern import (BucketSpec, RuleOps, RulePlans, ShareOps,
                                 build_rule_strips, init_rule_buffers,
                                 init_rule_monitor, lower_rule,
                                 make_rulebook_plane, pad_rule,
                                 packed_rule_row_count, stack_rule_ops)
from ..core.patterns import PRED_NONE, CompositePattern, Pattern
from ..core.scan import (_upload, block_xs, first_event, make_rulebook_scan,
                         stack_rulebook_window, upload_rulebook_window)
from ..core.stats import MonitorState, Stat, uniform_stat
from ..distributed.sharding import (BlockLayout, Blocks, per_block,
                                    resolve_cep_mesh, to_host)
from .config import RuntimeConfig
from .dsl import as_pattern
from .session import Stream, Telemetry, _normalize_stream

__all__ = ["Rulebook", "open_rulebook"]


def _subjoin_chain(pattern: Pattern,
                   order: Sequence[int]) -> Tuple[tuple, ...]:
    """Cumulative identity of a rule's sub-joins along one plan order.

    ``chain[d]`` identifies the ``d + 2``-position sub-join after plan
    step ``d + 1``; two rules with equal ``chain[d]`` produce equal
    partial-match sets at that depth.  Each step key pins the buffer
    contents (types), the eviction horizon (window), the sequence anchors
    (positions + is_seq) and every live constraint row of the packed join
    — at the step that joins position ``q`` the only active strip rows are
    ``(a, q)`` for already-joined ``a`` — plus the positions the values
    land in.  Cumulative keys make sharing prefix-closed.
    """
    spec = make_spec(pattern)
    member = [int(order[0])]
    key = (float(spec.window), bool(spec.is_seq), int(order[0]),
           int(spec.type_ids[int(order[0])]))
    chain = []
    for i in range(1, spec.n):
        q = int(order[i])
        rows = []
        for a in sorted(member):
            op = int(spec.op_t[a, q])
            if op == PRED_NONE:
                rows.append((a, op, 0, 0, 0.0))
            else:
                rows.append((a, op, int(spec.a_attr_t[a, q]),
                             int(spec.b_attr_t[a, q]),
                             float(spec.theta_t[a, q])))
        key = key + (q, int(spec.type_ids[q]), tuple(rows))
        chain.append(key)
        member.append(q)
    return tuple(chain)


def _row_write(dev, host, index) -> None:
    """Copy row ``index`` of each host array into the matching device
    tensor (a row write; shapes never change)."""
    for d, h in zip(dev, host):
        d[index].copy_(torch.from_numpy(np.array(np.asarray(h)[index])))


def _cell_write(layout, dev, host, k, q) -> None:
    """Cell ``(k, q)`` of (K, Qb, ...) host arrays into their device
    tensors, every partition when ``k`` is None.  On a mesh (``layout``)
    ``dev`` is ``Blocks`` and each write goes to the block that owns the
    partition, at its row there."""
    if layout is None:
        _row_write(dev, host, (slice(None) if k is None else k, q))
        return
    owners = ([(b, slice(None)) for b in range(layout.d)] if k is None
              else [layout.owner(k)])
    for b, kl in owners:
        sl = layout.slices[b]
        _row_write(dev[b], [np.asarray(h)[sl] for h in host], (kl, q))


def _replica_write(dev, host, q) -> None:
    """Row ``q`` of replicated host arrays into every device copy (one
    write per device on a mesh, whose blocks share a device's copy)."""
    parts = dev if isinstance(dev, Blocks) else (dev,)
    for part in {id(p): p for p in parts}.values():
        _row_write(part, host, q)


class _Lowered2D:
    """(K, Qb) invariant matrix: host-writable rows, device copy patched
    row by row (the fleet's ``StackedLowered`` with a rule axis); on a
    mesh (``layout``) the device copy is ``Blocks``."""

    def __init__(self, host: LoweredInvariants, device, layout=None):
        self.host = host
        self.device_name = device
        self.layout = layout
        self._dev = None

    @classmethod
    def build(cls, rows_kq: Sequence[Sequence[LoweredInvariants]], device,
              layout=None):
        return cls(LoweredInvariants(
            *(np.stack([np.stack([np.asarray(getattr(r, f)) for r in krow])
                        for krow in rows_kq])
              for f in LoweredInvariants._fields)), device, layout)

    def write(self, k: int, q: int, row: LoweredInvariants) -> None:
        for f in LoweredInvariants._fields:
            dst, src = getattr(self.host, f), np.asarray(getattr(row, f))
            if dst[k, q].shape != src.shape:
                raise ValueError(
                    f"lowered field {f!r}: row shape {src.shape} != "
                    f"stacked {dst[k, q].shape}")
            dst[k, q] = src
        if self._dev is not None:
            _cell_write(self.layout, self._dev, self.host, k, q)

    def grow(self, new_qcap: int) -> None:
        pad = new_qcap - self.host.active.shape[1]
        self.host = LoweredInvariants(*(
            np.pad(x, ((0, 0), (0, pad)) + ((0, 0),) * (x.ndim - 2))
            for x in self.host))
        self._dev = None

    def device(self):
        if self._dev is None:
            arrays = [np.asarray(x) for x in self.host]
            self._dev = (LoweredInvariants(*_upload(arrays, self.device_name))
                         if self.layout is None else
                         Blocks(LoweredInvariants(*b)
                                for b in self.layout.upload(arrays)))
        return self._dev


@dataclasses.dataclass
class _RuleEntry:
    """Host bookkeeping + cumulative counters for one rule."""

    rid: int
    pattern: Pattern
    bucket: "_Bucket"
    slot: int                # q row in the bucket (fixed while active)
    chain: Tuple[int, ...]   # lattice class per depth (len = n - 1)
    pinned: Tuple[int, ...]  # () or the pinned shared plan prefix
    active: bool = True
    matches: np.ndarray = None       # (K,) int64
    overflow: int = 0
    neg_rejected: int = 0
    closure_expansions: int = 0
    pm_created: int = 0
    replans: int = 0
    deployments: int = 0
    violations: int = 0
    chunks: int = 0


class _Bucket:
    """One arity bucket: stacked tensors + plane + per-cell policies."""

    def __init__(self, rb: "Rulebook", bspec: BucketSpec):
        self.rb = rb
        self.bspec = bspec
        self.depth = bspec.n - 1            # lattice depths (>= 1)
        self.q_cap = 0
        self.u_caps: List[int] = []         # class capacity per depth
        self.slots: List[Optional[_RuleEntry]] = []
        # [d][u] -> member slots of the depth-d class u
        self.class_members: List[List[List[int]]] = []
        self.free_slots: List[int] = []
        self.free_classes: List[List[int]] = []     # per depth
        # Host mirrors; the device copies are written row by row.
        self.ops_h: Optional[RuleOps] = None
        self.ops_d: Optional[RuleOps] = None
        self.plans_h: Optional[np.ndarray] = None   # (K, Qb, n) i32
        self.strips_h: Optional[tuple] = None       # ops8, lo, hi
        self.plans_d: Optional[RulePlans] = None
        self.rep_h: List[np.ndarray] = []           # [d]: (U_d,) i32
        self.parent_h: List[np.ndarray] = []        # [d]: (U_d,) i32
        self.expand_h: Optional[np.ndarray] = None  # (Qb,) i32
        self.share_d: Optional[ShareOps] = None
        self.state = None
        self.monitor = None
        self.lowered: Optional[_Lowered2D] = None
        self.policies: List[List] = []              # [k][q] -> policy
        self.caps: Tuple[int, int] = (1, 1)
        self.plane = None
        self.scan_plane = None              # built on the first window

    # -- layout ------------------------------------------------------------

    def _refresh_share(self) -> None:
        d = self.depth

        def share(up):
            return ShareOps(rep=tuple(up[:d]), parent=tuple(up[d:2 * d]),
                            expand=up[2 * d])

        self.share_d = per_block(share, self.rb._replicate(
            [np.asarray(x, np.int64) for x in
             (*self.rep_h, *self.parent_h, self.expand_h)]))

    def _make_plane(self) -> None:
        rb = self.rb
        self.plane = make_rulebook_plane(
            self.bspec, rb.engine_cfg, rb.k, rb.monitored,
            laplace=rb.config.laplace, mesh=rb.mesh)

    def scan_plane_ref(self):
        """The bucket's window, built on the first superchunk window
        (``core.scan.make_rulebook_scan``: memoized like the per-chunk
        plane, keyed without capacity, so growth re-enters the same
        window with a new shape)."""
        if self.scan_plane is None:
            rb = self.rb
            self.scan_plane = make_rulebook_scan(
                self.bspec, rb.engine_cfg, rb.k, rb.monitored,
                laplace=rb.config.laplace, mesh=rb.mesh)
        return self.scan_plane

    def _strip_cell(self, k: int, q: int) -> None:
        """Re-derive the join strips of cell (k, q) from its rule row and
        its plan row (host)."""
        row = RuleOps(*(np.asarray(x)[q] for x in self.ops_h))
        for dst, src in zip(self.strips_h,
                            build_rule_strips(self.bspec, row,
                                              self.plans_h[k, q])):
            dst[k, q] = src

    def _all_strips(self) -> None:
        k, q_cap, n = self.plans_h.shape
        c = packed_rule_row_count(n)
        self.strips_h = (np.zeros((k, q_cap, n - 1, c), np.int8),
                         np.zeros((k, q_cap, n - 1), np.int64),
                         np.zeros((k, q_cap, n - 1), np.int64))
        for kk in range(k):
            for q in range(q_cap):
                self._strip_cell(kk, q)

    def _upload_ops(self) -> None:
        self.ops_d = per_block(lambda up: RuleOps(*up), self.rb._replicate(
            [np.asarray(x) for x in self.ops_h]))

    def _upload_plans(self) -> None:
        self.plans_d = per_block(lambda up: RulePlans(*up), self.rb._k_led(
            [self.plans_h.astype(np.int64), *self.strips_h]))

    def _plans_host(self):
        return (self.plans_h, *self.strips_h)

    def build(self, entries: Sequence[Tuple[_RuleEntry, RuleOps,
                                            np.ndarray, list, object]],
              spare: int,
              probe_patterns: Optional[Sequence[Pattern]] = None) -> None:
        """Initial layout from (entry, ops_row, order, dcs, stat) tuples.

        Entries arrive pre-grouped (``entry.chain`` / ``entry.slot`` set);
        ``spare`` free rule slots and per-depth class slots are
        pre-provisioned so the first hot-adds are pure row writes.
        ``probe_patterns`` seeds the invariant-cap probe when the bucket
        opens empty (hot-add into a new shape).
        """
        rb = self.rb
        n_rules = len(entries)
        n_classes = [1 + max((e.chain[d] for e, *_ in entries), default=-1)
                     for d in range(self.depth)]
        self.q_cap = n_rules + spare
        self.u_caps = [max(1, nc + spare) for nc in n_classes]
        rows = [None] * self.q_cap
        self.slots = [None] * self.q_cap
        self.class_members = [[[] for _ in range(uc)] for uc in self.u_caps]
        self.free_classes = [[] for _ in range(self.depth)]
        self.rep_h = [np.zeros((uc,), np.int32) for uc in self.u_caps]
        self.parent_h = [np.zeros((uc,), np.int32) for uc in self.u_caps]
        self.expand_h = np.zeros((self.q_cap,), np.int32)
        self.plans_h = np.tile(np.arange(self.bspec.n, dtype=np.int32),
                               (rb.k, self.q_cap, 1))
        if rb.monitored:
            self.policies = [[None] * self.q_cap for _ in range(rb.k)]
            self.caps = self._probe_caps(
                probe_patterns if probe_patterns is not None
                else [e.pattern for e, *_ in entries])
        low_rows: List[List[LoweredInvariants]] = [
            [None] * self.q_cap for _ in range(rb.k)]
        for entry, ops_row, order, dcs, stat in entries:
            q = entry.slot
            rows[q] = ops_row
            self.slots[q] = entry
            for d, u in enumerate(entry.chain):
                self.class_members[d][u].append(q)
                if d:
                    self.parent_h[d][u] = entry.chain[d - 1]
            self.expand_h[q] = entry.chain[-1]
            self.plans_h[:, q] = order
            if rb.monitored:
                for k in range(rb.k):
                    pol = rb.config.policy_factory()()
                    pol.on_replan(_OrderRow(order), dcs, stat)
                    self.policies[k][q] = pol
                    low_rows[k][q] = pol.compile(
                        self.bspec.n, max_inv=self.caps[0],
                        max_terms=self.caps[1])
        for d in range(self.depth):
            for u, members in enumerate(self.class_members[d]):
                if members:
                    self.rep_h[d][u] = members[0]
                else:
                    self.free_classes[d].append(u)
        for q in range(self.q_cap):
            if rows[q] is None:
                rows[q] = pad_rule(self.bspec)
                self.free_slots.append(q)
        dev = rb.device
        if rb.monitored:
            empty = self._empty_lowered()
            for k in range(rb.k):
                for q in range(self.q_cap):
                    if low_rows[k][q] is None:
                        low_rows[k][q] = empty
            self.lowered = _Lowered2D.build(low_rows, dev, rb.layout)
            self.monitor = rb._init_monitor(self.bspec, self.q_cap)
        self.ops_h = stack_rule_ops(rows)
        self._upload_ops()
        self._all_strips()
        self._upload_plans()
        self._refresh_share()
        self.state = rb._init_state(self.bspec, self.q_cap)
        self._make_plane()

    def _probe_caps(self, patterns: Sequence[Pattern]) -> Tuple[int, int]:
        """Bucket-wide lowered-invariant caps from UNPINNED cold plans
        (pinning only removes deciding conditions); every cell lowers at
        the bucket max so invariant deployments stay row writes.
        ``config.max_invariants/max_terms`` override upward."""
        rb = self.rb
        i_cap = t_cap = 1
        stat0 = uniform_stat(self.bspec.n)
        for p in patterns:
            plan, dcs = greedy_order_plan(p, stat0)
            pol = rb.config.policy_factory()()
            pol.on_replan(plan, dcs, stat0)
            low = pol.compile(self.bspec.n)
            i_cap = max(i_cap, low.active.shape[0])
            t_cap = max(t_cap, low.scale.shape[-1])
        if rb.config.max_invariants is not None:
            i_cap = max(i_cap, int(rb.config.max_invariants))
        if rb.config.max_terms is not None:
            t_cap = max(t_cap, int(rb.config.max_terms))
        return (i_cap, t_cap)

    def _empty_lowered(self) -> LoweredInvariants:
        """An inert invariant row (active all-False) for empty slots."""
        return lower_invariants([], 0.0, self.bspec.n,
                                max_inv=self.caps[0],
                                max_terms=self.caps[1])

    # -- growth (the one shape change) -------------------------------------

    def grow_slots(self) -> None:
        """Double the rule capacity: pad every host/device tensor along the
        rule axis.  The next window of this bucket captures again (new
        shapes); per chunk nothing is rebuilt."""
        rb = self.rb
        old, new = self.q_cap, max(1, self.q_cap * 2)
        pad_n = new - old
        pad_rows = [pad_rule(self.bspec)] * pad_n
        self.ops_h = RuleOps(*(
            np.concatenate([getattr(self.ops_h, f),
                            np.stack([np.asarray(getattr(r, f))
                                      for r in pad_rows])])
            for f in RuleOps._fields))
        self._upload_ops()
        self.plans_h = np.concatenate(
            [self.plans_h,
             np.tile(np.arange(self.bspec.n, dtype=np.int32),
                     (rb.k, pad_n, 1))], axis=1)
        self._all_strips()
        self._upload_plans()
        self.expand_h = np.concatenate(
            [self.expand_h, np.zeros((pad_n,), np.int32)])
        self._refresh_share()

        def pad(x):
            z = torch.zeros((x.shape[0], pad_n) + tuple(x.shape[2:]),
                            dtype=x.dtype, device=x.device)
            return torch.cat([x, z], dim=1)

        self.state = per_block(lambda st: type(st)(*(pad(x) for x in st)),
                               self.state)
        if rb.monitored:
            self.monitor = per_block(
                lambda mon: MonitorState(*(pad(x) for x in mon)),
                self.monitor)
            self.lowered.grow(new)
            empty = self._empty_lowered()
            for k in range(rb.k):
                self.policies[k].extend([None] * pad_n)
                for q in range(old, new):
                    self.lowered.write(k, q, empty)
        self.slots.extend([None] * pad_n)
        self.free_slots.extend(range(old, new))
        self.q_cap = new

    def grow_classes(self, d: int) -> None:
        """Double depth ``d``'s class capacity (a shape change, like
        ``grow_slots``)."""
        old, new = self.u_caps[d], max(1, self.u_caps[d] * 2)
        self.rep_h[d] = np.concatenate(
            [self.rep_h[d], np.zeros((new - old,), np.int32)])
        self.parent_h[d] = np.concatenate(
            [self.parent_h[d], np.zeros((new - old,), np.int32)])
        self.class_members[d].extend([] for _ in range(new - old))
        self.free_classes[d].extend(range(old, new))
        self._refresh_share()
        self.u_caps[d] = new

    # -- row writes --------------------------------------------------------

    def write_ops_row(self, q: int, row: RuleOps) -> None:
        for f in RuleOps._fields:
            np.asarray(getattr(self.ops_h, f))[q] = np.asarray(
                getattr(row, f))
        _replica_write(self.ops_d, self.ops_h, q)
        for k in range(self.rb.k):
            self._strip_cell(k, q)
        _cell_write(self.rb.layout, self.plans_d, self._plans_host(), None,
                    q)

    def write_plan_row(self, k: int, q: int, order: np.ndarray) -> None:
        self.plans_h[k, q] = order
        self._strip_cell(k, q)
        _cell_write(self.rb.layout, self.plans_d, self._plans_host(), k, q)

    def write_plan_all_k(self, q: int, order: np.ndarray) -> None:
        self.plans_h[:, q] = order
        for k in range(self.rb.k):
            self._strip_cell(k, q)
        _cell_write(self.rb.layout, self.plans_d, self._plans_host(), None,
                    q)

    def zero_state_row(self, q: int) -> None:
        for part in (self.state, self.monitor):
            for blk in (part if isinstance(part, Blocks) else (part,)):
                for x in (blk or ()):
                    x[:, q] = 0


class _OrderRow:
    """Minimal plan object handed to decision policies (order-only)."""

    def __init__(self, order):
        self.order = tuple(int(o) for o in order)


def _stats_host(rates, sel):
    """(rates, sel) of every cell of a block as float64 numpy, in one
    transfer."""
    flat = torch.cat([rates.reshape(-1), sel.reshape(-1)]).cpu().numpy()
    r = flat[:rates.numel()].reshape(tuple(rates.shape))
    s = flat[rates.numel():].reshape(tuple(sel.shape))
    return r.astype(np.float64), s.astype(np.float64)


class Rulebook:
    """Q patterns, one data plane per arity bucket.

    Construct via :func:`open_rulebook`.  ``step``/``run`` advance every
    rule at once; ``add_rule``/``remove_rule`` mutate the rule set live.
    """

    def __init__(self, rules: Sequence, *, partitions: int = 1,
                 monitor: bool = True,
                 config: Optional[RuntimeConfig] = None,
                 spare_slots: int = 0):
        self.config = config or RuntimeConfig()
        self.config.validate(monitor=bool(monitor),
                             partitions=int(partitions))
        self.k = int(partitions)
        self.monitored = bool(monitor)
        self.engine_cfg: EngineConfig = self.config.engine()
        self.device = resolve_device(self.config.device)
        self.mesh = resolve_cep_mesh(self.config.mesh, self.k, self.device)
        self.layout = (None if self.mesh is None
                       else BlockLayout(self.mesh, self.k))
        self.spare_slots = int(spare_slots)
        patterns = [self._check_pattern(as_pattern(r)) for r in rules]
        if not patterns:
            raise ValueError("open_rulebook needs at least one rule")
        # Rulebook-wide attribute width: chunks are shared by every rule.
        self.n_attrs = max(p.n_attrs for p in patterns)
        patterns = [self._widen(p) for p in patterns]
        self._rules: List[_RuleEntry] = []
        self._buckets: List[_Bucket] = []
        self._chunks = 0
        self._host_syncs = 0
        # Windows cut at an in-window flag (the reference re-runs their
        # prefix; the port continues from the carry after the flag).
        self.in_window_events = 0
        self._build(patterns)

    # -- construction -------------------------------------------------------

    def _check_pattern(self, p) -> Pattern:
        if isinstance(p, CompositePattern):
            raise ValueError(
                "OR-composites decompose into independent branches; add "
                "each branch to the rulebook as its own rule")
        return p

    def _widen(self, p: Pattern) -> Pattern:
        if p.n_attrs > self.n_attrs:
            raise ValueError("rule exceeds rulebook attribute width")
        if p.n_attrs != self.n_attrs:
            p = dataclasses.replace(p, n_attrs=self.n_attrs)
        return p

    def _bucket_key(self, p: Pattern):
        spec = make_spec(p)
        return (spec.n, spec.has_neg, spec.kleene_pos is not None,
                len(spec.neg_rows))

    def _build(self, patterns: Sequence[Pattern]) -> None:
        # rid == position in the caller's rule list; buckets regroup the
        # rules physically but never renumber them.
        base = len(self._rules)
        self._rules.extend([None] * len(patterns))
        by_shape: Dict[tuple, List[Tuple[int, Pattern]]] = {}
        for idx, p in enumerate(patterns):
            n, has_neg, has_kl, _ = self._bucket_key(p)
            # Fused: one bucket per arity, spec'd to the superset of its
            # members' post-blocks.  Unfused: one per exact shape class.
            fkey = ((n,) if self.config.bucket_fusion
                    else (n, has_neg, has_kl))
            by_shape.setdefault(fkey, []).append((idx, p))
        stat0_cache: Dict[int, Stat] = {}
        mode = self.config.sharing
        for fkey, ps in by_shape.items():
            n = fkey[0]
            specs = [make_spec(p) for _, p in ps]
            bspec = BucketSpec(
                n=n,
                has_neg=any(s.has_neg for s in specs),
                has_kleene=any(s.kleene_pos is not None for s in specs),
                n_attrs=self.n_attrs,
                neg_rows_cap=max(len(s.neg_rows) for s in specs))
            bucket = _Bucket(self, bspec)
            stat0 = stat0_cache.setdefault(n, uniform_stat(n))
            # Cold-plan free, then build the sharing lattice from the
            # cumulative sub-join chains along each free plan.
            cold = [greedy_order_plan(p, stat0) for _, p in ps]
            depth = n - 1
            class_maps: List[Dict[tuple, int]] = [{} for _ in range(depth)]
            assign = []
            for r, ((_, p), (plan, _)) in enumerate(zip(ps, cold)):
                ck = _subjoin_chain(p, plan.order)
                row = []
                for d in range(depth):
                    if mode == "none" or (mode == "prefix" and d > 0):
                        key = ("solo", r, d)
                    else:
                        key = ck[d]
                    row.append(class_maps[d].setdefault(
                        key, len(class_maps[d])))
                assign.append(tuple(row))
            sizes = [np.bincount([a[d] for a in assign],
                                 minlength=len(class_maps[d]))
                     for d in range(depth)]
            entries = []
            for slot, ((idx, p), (plan, dcs)) in enumerate(zip(ps, cold)):
                # Deepest depth actually shared (>= 2 members); cumulative
                # keys make this a plan prefix, which gets pinned so later
                # replans never break the share.
                shared = -1
                for d in range(depth):
                    if sizes[d][assign[slot][d]] >= 2:
                        shared = d
                    else:
                        break
                pinned: Tuple[int, ...] = ()
                if shared >= 0:
                    pinned = tuple(int(o) for o in plan.order[:shared + 2])
                    plan, dcs = greedy_order_plan(p, stat0, pin=pinned)
                entry = _RuleEntry(
                    rid=base + idx, pattern=p, bucket=bucket,
                    slot=slot, chain=assign[slot], pinned=pinned,
                    matches=np.zeros((self.k,), np.int64))
                self._rules[base + idx] = entry
                entries.append((entry, lower_rule(p, bspec),
                                np.asarray(plan.order, np.int32), dcs,
                                stat0))
            bucket.build(entries, self.spare_slots)
            self._buckets.append(bucket)

    # -- placement ----------------------------------------------------------

    def _replicate(self, arrays):
        """Fleet-wide host arrays on the device, one copy (one per mesh
        device, shared by its blocks)."""
        if self.layout is None:
            return _upload(arrays, self.device)
        return self.layout.replicate(arrays)

    def _k_led(self, arrays):
        """K-led host arrays on the device, one copy (on a mesh each
        block's rows on its device, one copy per block)."""
        if self.layout is None:
            return _upload(arrays, self.device)
        return self.layout.upload(arrays)

    def _init_state(self, bspec: BucketSpec, q_cap: int):
        if self.layout is None:
            return init_rule_buffers(bspec, self.engine_cfg, self.k, q_cap,
                                     self.device)
        return self.layout.build(lambda kb, dev: init_rule_buffers(
            bspec, self.engine_cfg, kb, q_cap, dev))

    def _init_monitor(self, bspec: BucketSpec, q_cap: int):
        n_buckets = self.config.estimator_buckets
        if self.layout is None:
            return init_rule_monitor(bspec, self.k, q_cap, n_buckets,
                                     self.device)
        return self.layout.build(lambda kb, dev: init_rule_monitor(
            bspec, kb, q_cap, n_buckets, dev))

    def _fired_stats(self, rates, sel, fired_k):
        """(rates, sel) of every cell as float64 numpy (K, Qb, ...), read
        in one transfer; on a mesh one per block that owns a fired
        partition (the other blocks' rows stay zero, unread)."""
        if self.layout is None:
            return _stats_host(rates, sel)
        lay = self.layout
        r = np.zeros((self.k,) + tuple(rates[0].shape[1:]), np.float64)
        s = np.zeros((self.k,) + tuple(sel[0].shape[1:]), np.float64)
        for b in sorted({lay.owner(k)[0] for k in fired_k}):
            r[lay.slices[b]], s[lay.slices[b]] = _stats_host(rates[b], sel[b])
        return r, s

    # -- data plane ---------------------------------------------------------

    def _check_chunk(self, chunk: Chunk) -> Chunk:
        if len(chunk.type_id.shape) == 1:
            if self.k != 1:
                raise ValueError("unstacked chunk on a multi-partition "
                                 "rulebook; stack K per-partition chunks")
            chunk = (Chunk(*(x[None] for x in chunk))
                     if isinstance(chunk.type_id, torch.Tensor)
                     else stack_chunks([chunk]))
        if chunk.attr.shape[-1] != self.n_attrs:
            raise ValueError(
                f"chunk has {chunk.attr.shape[-1]} attributes; this "
                f"rulebook is built for {self.n_attrs}")
        return chunk

    def _device_chunk(self, chunk: Chunk, t0: float, t1: float):
        """The chunk and its clock on the device, in one copy (tensors
        already on the device are used as they are).  On a mesh,
        ``Blocks``: each block's slice of the chunk and the clock go
        straight to its device in one copy."""
        clock = np.asarray([t0, t1], np.float32)
        lay = self.layout
        if isinstance(chunk.type_id, torch.Tensor):
            if lay is None:
                up = [[x.to(self.device) for x in chunk]
                      + [torch.as_tensor(clock, device=self.device)]]
            else:
                up = [[x[sl].to(dev) for x in chunk]
                      + [torch.as_tensor(clock, device=dev)]
                      for sl, dev in zip(lay.slices, lay.devices)]
        elif lay is None:
            up = [_upload([np.asarray(x) for x in chunk] + [clock],
                          self.device)]
        else:
            up = lay.upload([np.asarray(x) for x in chunk], shared=[clock])
        parts = [(Chunk(*u[:4]), u[4][0], u[4][1]) for u in up]
        if lay is None:
            return parts[0]
        return tuple(Blocks(p[i] for p in parts) for i in range(3))

    def _accumulate(self, bucket: _Bucket, cnt, n_rows: int, out,
                    base=None) -> None:
        """Fold the first ``n_rows`` chunks of ``cnt`` (5, S, K, Qb) into
        the bucket's active rules and ``out`` (full matches)."""
        for q, entry in enumerate(bucket.slots):
            if entry is None or not entry.active:
                continue
            full_k = cnt[0, :n_rows, :, q].astype(np.int64)
            entry.matches += full_k.sum(axis=0)
            entry.pm_created += int(cnt[1, :n_rows, :, q].sum())
            entry.overflow += int(cnt[2, :n_rows, :, q].sum())
            entry.closure_expansions += int(cnt[3, :n_rows, :, q].sum())
            entry.neg_rejected += int(cnt[4, :n_rows, :, q].sum())
            entry.chunks += n_rows
            if base is None:
                out[entry.rid] = full_k[0]
            else:
                out[base:base + n_rows, entry.rid] += full_k

    def step(self, chunk: Chunk, t0: float, t1: float) -> np.ndarray:
        """Advance every rule one tick over an already-stacked chunk.

        ``chunk`` fields carry a leading K axis (a bare single-partition
        ``Chunk`` is accepted when K = 1); numpy arrays or tensors.
        Returns this tick's full-match counts as an (R, K) array over
        rules in insertion order (removed rules contribute zero rows).
        Monitored rulebooks also run the violation → sync → replan →
        row-deploy loop per flagged (q, k) cell inside the call.
        """
        chunk = self._check_chunk(chunk)
        dchunk, t0d, t1d = self._device_chunk(chunk, t0, t1)
        self._chunks += 1
        out = np.zeros((len(self._rules), self.k), np.int64)
        for bucket in self._buckets:
            low = bucket.lowered.device() if self.monitored else None
            (bucket.state, bucket.monitor, res, violated, _drift, rates,
             sel) = bucket.plane.step(bucket.state, bucket.monitor, dchunk,
                                      bucket.ops_d, bucket.share_d,
                                      bucket.plans_d, low, t0d, t1d)
            # One coalesced counter (and flag) transfer per bucket per tick
            # (one per block on a mesh).
            h = to_host(lambda r, v: torch.cat(
                [torch.stack(tuple(r)), v.to(torch.int32)[None]]),
                res, violated, axis=1)
            self._host_syncs += 1
            self._accumulate(bucket, h[:5, None], 1, out)
            if self.monitored:
                fired = np.nonzero(h[5])
                if fired[0].size:
                    # One coalesced stats transfer serves every fired cell.
                    self._host_syncs += 1
                    rates_h, sel_h = self._fired_stats(rates, sel, fired[0])
                    for k, q in zip(*fired):
                        self._replan_cell(bucket, int(k), int(q),
                                          rates_h, sel_h)
        return out

    def _replan_cell(self, bucket: _Bucket, k: int, q: int,
                     rates, sel) -> None:
        """Invariant violation at cell (k, q): re-run the planner on that
        cell's device statistics and deploy plan + invariant rows."""
        entry = bucket.slots[q]
        if entry is None or not entry.active:
            return
        entry.violations += 1
        stat = Stat(np.asarray(rates[k, q], np.float64),
                    np.asarray(sel[k, q], np.float64))
        plan, dcs = greedy_order_plan(entry.pattern, stat,
                                      pin=entry.pinned)
        order = np.asarray(plan.order, np.int32)
        changed = not np.array_equal(order, bucket.plans_h[k, q])
        bucket.write_plan_row(k, q, order)
        pol = bucket.policies[k][q]
        pol.on_replan(plan, dcs, stat)
        bucket.lowered.write(k, q, pol.compile(
            bucket.bspec.n, max_inv=bucket.caps[0],
            max_terms=bucket.caps[1]))
        entry.replans += 1
        if changed:
            entry.deployments += 1

    def step_superchunk(self, chunks: Sequence[Chunk],
                        edges: Sequence[Tuple[float, float]]) -> np.ndarray:
        """Advance every rule over a sequence of stacked chunks with
        ``config.superchunk`` chunks per window (``core.scan``).

        Equal to looping :meth:`step`: each bucket runs a window, and a
        flag at in-window chunk ``f`` accepts chunks ``[0..f]`` only, takes
        the carry after chunk ``f``, replans the flagged cells and resumes
        at ``f + 1``.  Buckets hold disjoint state, so windowing them one
        after the other commutes with the per-chunk bucket interleave.
        Returns the per-chunk ``(len(chunks), R, K)`` full-match counts
        over rules in insertion order.
        """
        chunks = [self._check_chunk(c) for c in chunks]
        t0s = [float(t0) for t0, _ in edges]
        t1s = [float(t1) for _, t1 in edges]
        if len(chunks) != len(t0s):
            raise ValueError("chunks and edges length mismatch")
        s_cap = max(2, self.config.superchunk)
        n_chunks = len(chunks)
        out = np.zeros((n_chunks, len(self._rules), self.k), np.int64)
        # Buckets walk the same window boundaries until a flag splits one;
        # cache each uploaded window per (i, j) range.
        xs_cache: Dict[Tuple[int, int], object] = {}
        for bucket in self._buckets:
            i = 0
            while i < n_chunks:
                j = min(i + s_cap, n_chunks)
                xs = xs_cache.get((i, j))
                if xs is None:
                    xs = xs_cache[(i, j)] = self._upload_window(
                        stack_rulebook_window(chunks[i:j], t0s[i:j],
                                              t1s[i:j], s_cap))
                i += self._scan_window(bucket, xs, j - i, out, i)
        self._chunks += n_chunks
        return out

    def _upload_window(self, xs):
        """A window's host inputs on the device in one copy; on a mesh
        ``Blocks``, each block's slice on its device."""
        if self.layout is None:
            return upload_rulebook_window(xs, self.device)
        return Blocks(upload_rulebook_window(x, dev) for x, dev in
                      zip(block_xs(self.layout, xs), self.layout.devices))

    def _scan_window(self, bucket: _Bucket, xs, n_en: int,
                     out: np.ndarray, base: int) -> int:
        """One window of one bucket over an uploaded window (``n_en`` of
        its padded rows enabled).  Commits the accepted prefix (state,
        counters, ``out`` rows) and applies invariant replans for flags at
        the last accepted chunk; returns the number of chunks accepted
        (>= 1)."""
        window = bucket.scan_plane_ref()
        low = bucket.lowered.device() if self.monitored else None
        state, monitor, ys = window(bucket.state, bucket.monitor,
                                    bucket.ops_d, bucket.share_d,
                                    bucket.plans_d, low, xs)
        h = ys.host(n_en)
        self._host_syncs += 1
        f = (first_event(h.violated, h.overflow, n_en, escalate=False)
             if self.monitored else None)
        if f is not None and f < n_en - 1:
            state, monitor = ys.carry_after(f)
            self.in_window_events += 1
        accept = n_en if f is None else f + 1
        bucket.state, bucket.monitor = state, monitor
        cnt = np.stack([h.full, h.pm, h.overflow, h.closure, h.neg])
        self._accumulate(bucket, cnt, accept, out, base)
        if f is not None:
            last = accept - 1
            fired = np.nonzero(h.violated[last])
            if fired[0].size:
                # One coalesced stats transfer serves every fired cell.
                self._host_syncs += 1
                rates_h, sel_h = self._fired_stats(*ys.stats(last), fired[0])
                for k, q in zip(*fired):
                    self._replan_cell(bucket, int(k), int(q),
                                      rates_h, sel_h)
        return accept

    def run(self, stream: Stream) -> Telemetry:
        """Consume a chunk stream (any shape ``cep.Session.run`` accepts)
        and return this run's aggregate ``Telemetry``.  Stream state
        persists across calls, so feeding a stream in segments is
        equivalent to one continuous run.  With ``config.superchunk > 1``
        chunks are windowed through :meth:`step_superchunk`."""
        before = self.telemetry()
        s_cap = self.config.superchunk
        if s_cap > 1:
            win: List[Chunk] = []
            edges: List[Tuple[float, float]] = []
            for fc in _normalize_stream(stream, self.k):
                win.append(fc.chunk)
                edges.append((fc.t0, fc.t1))
                if len(win) == s_cap:
                    self.step_superchunk(win, edges)
                    win, edges = [], []
            if win:
                self.step_superchunk(win, edges)
        else:
            for fc in _normalize_stream(stream, self.k):
                self.step(fc.chunk, fc.t0, fc.t1)
        after = self.telemetry()
        delta = Telemetry(partitions=self.k)
        for f in ("chunks", "matches", "replans", "deployments",
                  "violations", "host_syncs", "overflow", "neg_rejected",
                  "closure_expansions"):
            setattr(delta, f, getattr(after, f) - getattr(before, f))
        delta.per_partition_matches = (after.per_partition_matches
                                       - before.per_partition_matches)
        return delta

    # -- rule lifecycle ------------------------------------------------------

    def add_rule(self, rule) -> int:
        """Hot-add a rule; returns its rule id.

        Row writes into a free slot when one exists (ops row, plan rows,
        invariant rows, zeroed state rows): no kernel build, no graph
        capture.  Growing a full bucket's capacity, or opening a bucket
        for a shape the rulebook has never seen, changes shapes (the next
        window captures).  The new rule starts its own lattice chain.
        """
        p = self._widen(self._check_pattern(as_pattern(rule)))
        n, has_neg, has_kl, neg_rows = self._bucket_key(p)
        bucket = None
        for b in self._buckets:
            # Coverage, not equality: a fused bucket's spec is a superset
            # its members gate per rule.  Without fusion, require the
            # exact shape class.
            if b.bspec.n != n or neg_rows > b.bspec.neg_rows_cap:
                continue
            if has_neg and not b.bspec.has_neg:
                continue
            if has_kl and not b.bspec.has_kleene:
                continue
            if not self.config.bucket_fusion and \
                    (b.bspec.has_neg, b.bspec.has_kleene) != \
                    (has_neg, has_kl):
                continue
            bucket = b
            break
        if bucket is None:
            bucket = _Bucket(self, BucketSpec(
                n=n, has_neg=has_neg, has_kleene=has_kl,
                n_attrs=self.n_attrs, neg_rows_cap=neg_rows))
            bucket.build([], max(1, self.spare_slots),
                         probe_patterns=[p])
            self._buckets.append(bucket)
        if not bucket.free_slots:
            bucket.grow_slots()
        for d in range(bucket.depth):
            if not bucket.free_classes[d]:
                bucket.grow_classes(d)
        q = bucket.free_slots.pop(0)
        chain = tuple(bucket.free_classes[d].pop(0)
                      for d in range(bucket.depth))
        stat0 = uniform_stat(n)
        plan, dcs = greedy_order_plan(p, stat0)
        order = np.asarray(plan.order, np.int32)
        entry = _RuleEntry(
            rid=len(self._rules), pattern=p, bucket=bucket, slot=q,
            chain=chain, pinned=(), matches=np.zeros((self.k,), np.int64))
        self._rules.append(entry)
        bucket.slots[q] = entry
        for d, u in enumerate(chain):
            bucket.class_members[d][u] = [q]
            bucket.rep_h[d][u] = q
            bucket.parent_h[d][u] = chain[d - 1] if d else 0
        bucket.expand_h[q] = chain[-1]
        bucket._refresh_share()
        bucket.zero_state_row(q)
        bucket.write_ops_row(q, lower_rule(p, bucket.bspec))
        bucket.write_plan_all_k(q, order)
        if self.monitored:
            for k in range(self.k):
                pol = self.config.policy_factory()()
                pol.on_replan(_OrderRow(order), dcs, stat0)
                bucket.policies[k][q] = pol
                bucket.lowered.write(k, q, pol.compile(
                    n, max_inv=bucket.caps[0], max_terms=bucket.caps[1]))
        entry.deployments += 1
        return entry.rid

    def remove_rule(self, rid: int) -> None:
        """Hot-remove a rule: mask its slot out (row writes).  The slot is
        recycled by a later ``add_rule``."""
        entry = self._entry(rid)
        if not entry.active:
            raise ValueError(f"rule {rid} already removed")
        bucket, q = entry.bucket, entry.slot
        entry.active = False
        bucket.write_ops_row(q, pad_rule(bucket.bspec))
        bucket.slots[q] = None
        bucket.free_slots.append(q)
        reroute = False
        for d, u in enumerate(entry.chain):
            members = bucket.class_members[d][u]
            members.remove(q)
            if not members:
                bucket.free_classes[d].append(u)
            elif int(bucket.rep_h[d][u]) == q:
                # Any member can represent the class: the chain key pins
                # every operand of the shared join steps.
                bucket.rep_h[d][u] = members[0]
                reroute = True
        if reroute:
            bucket._refresh_share()
        if self.monitored:
            for k in range(self.k):
                bucket.policies[k][q] = None
                bucket.lowered.write(k, q, bucket._empty_lowered())

    def _entry(self, rid: int) -> _RuleEntry:
        if not (0 <= rid < len(self._rules)):
            raise KeyError(f"unknown rule id {rid}")
        return self._rules[rid]

    # -- introspection -------------------------------------------------------

    @property
    def rules(self) -> Tuple[int, ...]:
        """Active rule ids, insertion-ordered."""
        return tuple(e.rid for e in self._rules if e.active)

    @property
    def match_counts(self) -> np.ndarray:
        """(R, K) cumulative full-match counts over all rules ever added
        (removed rules keep their totals)."""
        return np.stack([e.matches for e in self._rules])

    def sharing_ratio(self) -> float:
        """Join work avoided by the sub-join lattice: per-rule plan steps
        over executed lattice node evaluations per chunk (1.0 = no
        sharing)."""
        steps = nodes = 0
        for b in self._buckets:
            n_active = sum(1 for e in b.slots
                           if e is not None and e.active)
            steps += n_active * b.depth
            for d in range(b.depth):
                nodes += sum(1 for m in b.class_members[d] if m)
        return steps / max(nodes, 1)

    def trace_count(self) -> int:
        """Shape signatures the buckets' superchunk windows have entered,
        one CUDA-graph capture each on the card — the hot-add probe (a
        rule added into a free slot leaves it unchanged; growth adds one;
        the per-chunk step runs eagerly and enters nothing).  Windows are
        shared with equal-config rulebooks through the memo, so this
        counts their shapes too, as the reference counts its shared
        planes' traces."""
        return sum(b.scan_plane.traces for b in self._buckets
                   if b.scan_plane is not None)

    @property
    def n_buckets(self) -> int:
        """Bucket steps per tick (fusion folds shape classes of one arity
        into a single bucket)."""
        return len(self._buckets)

    def telemetry(self, rule: Optional[int] = None) -> Telemetry:
        """Cumulative telemetry, aggregate or for one rule id."""
        entries = ([self._entry(rule)] if rule is not None
                   else self._rules)
        tel = Telemetry(partitions=self.k)
        tel.per_partition_matches = np.zeros((self.k,), np.int64)
        for e in entries:
            tel.matches += int(e.matches.sum())
            tel.per_partition_matches += e.matches
            tel.overflow += e.overflow
            tel.neg_rejected += e.neg_rejected
            tel.closure_expansions += e.closure_expansions
            tel.replans += e.replans
            tel.deployments += e.deployments
            tel.violations += e.violations
        tel.chunks = (self._entry(rule).chunks if rule is not None
                      else self._chunks)
        tel.host_syncs = self._host_syncs
        return tel

    def reset(self) -> None:
        """Clear stream state (rings, monitors, counters); keep the planes,
        the rule set and deployed plans."""
        for bucket in self._buckets:
            bucket.state = self._init_state(bucket.bspec, bucket.q_cap)
            if self.monitored:
                bucket.monitor = self._init_monitor(bucket.bspec,
                                                    bucket.q_cap)
        for e in self._rules:
            e.matches = np.zeros((self.k,), np.int64)
            e.overflow = e.neg_rejected = e.closure_expansions = 0
            e.pm_created = e.chunks = 0
        self._chunks = 0
        self._host_syncs = 0
        self.in_window_events = 0


def open_rulebook(rules: Iterable, *, partitions: int = 1,
                  monitor: bool = True,
                  config: Optional[RuntimeConfig] = None,
                  spare_slots: int = 0) -> Rulebook:
    """Open a rulebook: Q patterns behind one data plane per arity bucket.

    Parameters
    ----------
    rules:       patterns (``P`` builders or ``Pattern``s; OR-composites
                 must be added branch-by-branch).
    partitions:  K stream partitions, exactly as ``cep.open``.
    monitor:     fuse statistics rings + per-(q, k) invariant verification
                 into the step; ``False`` runs static cold plans.
    config:      a :class:`RuntimeConfig` (``config.device``, default
                 "cuda", places the plane); ``superchunk = S`` runs S
                 chunks per window (``run`` windows the stream,
                 ``step_superchunk`` takes explicit windows), ``sharing``
                 and ``bucket_fusion`` tune the multi-query optimizer;
                 the plane shards over ``config.mesh`` when set.
    spare_slots: pre-provisioned free rule/lattice-class slots per bucket
                 so that many hot-adds are pure row writes.
    """
    return Rulebook(list(rules), partitions=partitions, monitor=monitor,
                    config=config, spare_slots=spare_slots)
