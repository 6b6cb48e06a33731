"""Superchunk data plane: S chunks per window, no host sync inside it.

The port of the superchunk half of ``repro.core.scan``.  The per-chunk
runners cross the host/device boundary once per chunk: launch the step,
read back a ``(K,)`` flag vector, decide, repeat.  On the card that loop
is host-bound (a few hundred small launches and a counter pull per
chunk), so a window of S chunks runs here with the host out of it:

* the monitored (or plain) fleet step — pass A, and pass B where a
  partition migrates — reads its chunk, clock, plan operands and lowered
  invariants from **static input tensors** and updates a **static carry**
  (ring buffers, statistics rings) in place;
* on CUDA each step variant is captured once as a CUDA graph
  (``torch.cuda.graph``) and the window replays it once per chunk; between
  replays the host only issues device-to-device copies (the next chunk
  into the static inputs, the step's outputs into slot ``s`` of the
  window's ``(S, ...)`` output tensors).  The whole window's chunks and
  control go up in ONE host-to-device copy, and the host reads the
  counters, flags and drift back in ONE transfer after the window;
* on the CPU the same step function runs eagerly in a Python loop (what
  the tests exercise).  On CUDA there is no eager window: a capture that
  fails raises.

Every condition the JAX scan evaluates on the device is known on the host
before the window runs: ``enabled`` is a prefix of the window, and
``migrating[s]`` comes from the host-precomputed migration fold
(``window_control``).  So ``lax.cond(x.enabled, ...)`` becomes "run only
the enabled chunks", and ``lax.cond(x.migrating.any(), with_pass_b, ...)``
becomes "replay the A+B variant for chunks where some partition
migrates"; pass B's counters are masked by ``migrating`` on the device, as
in the reference.  No branch depends on device data.

Reactive control follows the reference's optimistic window: the runner
inspects the window's flags once, and if an invariant flag (or an overflow
needing escalation) fired at in-window chunk ``f < n - 1``, it accepts
chunks ``[0..f]`` only, takes the carry after chunk ``f``, replans and
resumes at ``f + 1``.  The reference re-runs the prefix ``[0..f]`` from
the pre-window carry to get that carry; the port keeps a snapshot of the
carry after every chunk instead (the carry is packed into one flat
tensor, so a snapshot is one device copy: 612,736 bytes for the K=16
FlowSense session of ``chip_smoke.py``), which is equally exact and
spares the re-run: on a drifting fleet most windows hold an event, and a
re-run would replay up to S - 1 chunks each time.  Semantics are
bit-identical to per-chunk stepping for every window size.

The rulebook's window (``RulebookWindow``, built through the memo by
``make_rulebook_scan`` as in the reference) runs the same way: one
bucket step per chunk (``core.multipattern``), its carry the bucket's
(K, Qb) ring buffers and statistics rings, its constant inputs the rule
rows, the lattice routing, the plan matrix and the lowered invariants.
Every chunk takes the one variant (the rulebook has no migration split),
so a bucket captures once per shape signature: row writes (a rule added
into a free slot, a removed rule, a replan) change no shape, bucket
growth does.

Both windows are entries of the fleet's process-wide memo
(``fleet._shared_trace``): equal-config sessions and rulebooks share one
window, its static tensors and its graphs, so a second session captures
nothing.  Sharing is safe because a window copies its carry and inputs
into the statics when it starts, and copies every replay's outputs out
of the graph pool before the next replay; windows run one at a time
(from one host thread).  A meshed fleet or rulebook (``MeshWindow``,
``MeshRulebookWindow``) runs one window per block instead, each with its
own statics and graphs on its block's device, outside the memo.

Launch counts.  A graph replay makes no kernel-wrapper call, so
``kernels.window_join.LAUNCHES`` does not move under replay; the launches
a capture records are added to ``GRAPH_LAUNCHES`` once per replay
(``kernels.window_join.capturing`` / ``count_replay``).
"""

from __future__ import annotations

import contextlib
import functools
import gc
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..distributed.sharding import Blocks, map_blocks
from ..kernels import window_join as _wj
from .engine import NEG_INF, POS_INF, Buffers, Chunk, make_monitored_process
from .stats import MonitorState

# Window activity, for tests and chip_smoke.py: windows run, CUDA graphs
# captured, graph replays, eager (CPU) steps.
COUNTS: Dict[str, int] = {"windows": 0, "captures": 0, "replays": 0,
                          "eager_steps": 0}

# Drift's skip value, -inf, as the int32 bits ``SuperchunkOut.head`` holds.
_NEG_INF_BITS = int(np.float32(NEG_INF).view(np.int32))

# One memory pool per CUDA device for every captured window step, so the
# graphs of escalated fleets share their intermediates' memory, and one
# capture stream per device.
_POOLS: Dict[int, object] = {}
_STREAMS: Dict[int, object] = {}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


class SuperchunkXs(NamedTuple):
    """Per-chunk window inputs (host numpy); every leaf leads with ``S``.

    ``enabled`` marks the chunks the window runs (a prefix: tail padding of
    a short final window disables a suffix).  ``born_lo`` /
    ``migrating`` / ``old_sel`` are the host-precomputed migration fold;
    for control planes without the [36] migration split they are
    ``-inf`` / ``False`` / ``False``.
    """

    chunk: Chunk          # (S, K, cap) / (S, K, cap, A) fields
    t0: np.ndarray        # (S,) f32 shared chunk clock
    t1: np.ndarray        # (S,) f32
    enabled: np.ndarray   # (S,) bool
    born_lo: np.ndarray   # (S, K) f32 — post-fold replan_t per chunk
    migrating: np.ndarray  # (S, K) bool — partition mid-migration
    old_sel: np.ndarray   # (S, K) bool — migration lapsed: old row := cur


class HostOut(NamedTuple):
    """The window outputs the host reads every window, as numpy."""

    full: np.ndarray      # (S, K) i32 full matches (pass A + masked B)
    pm: np.ndarray        # (S, K) i32 partial matches materialized
    overflow: np.ndarray  # (S, K) i32 candidates dropped by capacity
    closure: np.ndarray   # (S, K) i32 Kleene companion count
    neg: np.ndarray       # (S, K) i32 negation vetoes
    violated: np.ndarray  # (S, K) bool invariant flags
    drift: np.ndarray     # (S, K) f32 §3.4 relative margins


class SuperchunkOut(NamedTuple):
    """Per-chunk window outputs on the device.

    The reference's nine ``(S, K, ...)`` leaves, held so that the host
    reads the seven it needs every window in one transfer: ``head`` is
    ``(S, 7, K)`` int32 — rows full, pm, overflow, closure, neg, violated
    (0/1) and the f32 bits of drift.  ``rates`` / ``sel`` stay on the
    device; the host pulls a partition's row only when its flag fired.
    Disabled chunks hold the reference's skip values (zero counters, no
    flag, drift ``-inf``, zero statistics).  ``carry`` holds the packed
    carry after each enabled chunk (``carry_after``).
    """

    head: torch.Tensor    # (S, 7, K) i32
    rates: torch.Tensor   # (S, K, n) f32 monitor snapshot at each chunk
    sel: torch.Tensor     # (S, K, n, n) f32
    carry: torch.Tensor   # (n_enabled, bytes) u8 carry after each chunk
    layout: object        # the window's carry packing (views of a row)

    def carry_after(self, s: int):
        """The carry ``(buffers, monitor)`` after chunk ``s`` (views of its
        snapshot; ``monitor`` is None for a plain window)."""
        return self.layout.views(self.carry[s])

    def host(self, n: Optional[int] = None) -> HostOut:
        """The first ``n`` chunks' counters, flags and drift as numpy, in
        one device-to-host transfer."""
        h = self.head[:n].cpu().numpy()
        return HostOut(*(h[:, i] for i in range(5)), h[:, 5] != 0,
                       np.ascontiguousarray(h[:, 6]).view(np.float32))

    def stats(self, s: int):
        """``(rates, sel)`` at chunk ``s``, on the device (device slices
        of the window's outputs, not a graph's output buffers, which the
        next replay overwrites)."""
        return self.rates[s], self.sel[s]


class MeshOut(NamedTuple):
    """A meshed window's outputs: each block's ``SuperchunkOut``, on its
    device, read the same way.  ``host`` reads every block's head (one
    transfer per block) and joins them along K; ``carry_after`` and
    ``stats`` give ``Blocks``."""

    blocks: tuple

    def host(self, n: Optional[int] = None) -> HostOut:
        hs = [o.host(n) for o in self.blocks]
        return HostOut(*(np.concatenate(f, axis=1) for f in zip(*hs)))

    def carry_after(self, s: int):
        return map_blocks(lambda o: o.carry_after(s), Blocks(self.blocks))

    def stats(self, s: int):
        return map_blocks(lambda o: o.stats(s), Blocks(self.blocks))


# ---------------------------------------------------------------------------
# Host-side window control (exact float64 twin of the per-chunk fold)
# ---------------------------------------------------------------------------


class WindowControl(NamedTuple):
    """Precomputed per-chunk migration control for one superchunk window.

    ``replan_seq[s]`` is the float64 ``replan_t`` state *after* the fold at
    chunk ``s`` — the host rolls its mirrors forward to row ``f`` once the
    window's first ``f+1`` chunks are accepted.
    """

    born_lo: np.ndarray     # (S, K) f32 — pass-A born_lo / pass-B born_hi
    migrating: np.ndarray   # (S, K) bool
    old_sel: np.ndarray     # (S, K) bool — cumulative "old row := cur row"
    replan_seq: np.ndarray  # (S, K) f64


def window_control(replan_t: np.ndarray, migration_until: np.ndarray,
                   t0s: Sequence[float], s_pad: int) -> WindowControl:
    """Roll the [36] migration fold over a window of chunk starts.

    Bit-identical to ``FleetRunner._fold_lapsed`` applied per chunk: all
    comparisons in float64 on the host, only the final ``born_lo`` cast to
    f32 (exactly what the per-chunk runner feeds the device).  Does NOT
    mutate its inputs — the caller commits row ``f`` after acceptance.
    ``s_pad`` rows beyond ``len(t0s)`` are emitted disabled-shaped.
    """
    k = replan_t.shape[0]
    rt = np.asarray(replan_t, np.float64).copy()
    born_lo = np.full((s_pad, k), NEG_INF, np.float32)
    migrating = np.zeros((s_pad, k), bool)
    old_sel = np.zeros((s_pad, k), bool)
    replan_seq = np.full((s_pad, k), NEG_INF, np.float64)
    folded = np.zeros(k, bool)
    for i, t0 in enumerate(t0s):
        lapsed = (rt > NEG_INF) & (t0 >= migration_until)
        rt[lapsed] = NEG_INF
        folded |= lapsed
        born_lo[i] = rt.astype(np.float32)
        migrating[i] = rt > NEG_INF
        old_sel[i] = folded
        replan_seq[i] = rt
    return WindowControl(born_lo, migrating, old_sel, replan_seq)


def static_control(k: int, s_pad: int) -> WindowControl:
    """No-migration window control (the serving fronts deploy immediately,
    so born-windows are unbounded and pass B never runs)."""
    return WindowControl(
        born_lo=np.full((s_pad, k), NEG_INF, np.float32),
        migrating=np.zeros((s_pad, k), bool),
        old_sel=np.zeros((s_pad, k), bool),
        replan_seq=np.full((s_pad, k), NEG_INF, np.float64))


def stack_window(chunks: Sequence[Chunk], t0s, t1s, ctl: WindowControl,
                 s_pad: int) -> SuperchunkXs:
    """Stack a window of stacked ``(K, ...)`` host chunks into window
    inputs.

    Short windows (the stream's tail) are padded to ``s_pad``
    with disabled repeats of the last chunk, as in the reference.
    """
    s = len(chunks)
    if s == 0:
        raise ValueError("empty superchunk window")
    padded = list(chunks) + [chunks[-1]] * (s_pad - s)
    chunk = Chunk(*(np.stack([np.asarray(c[i]) for c in padded])
                    for i in range(len(Chunk._fields))))
    t0a = np.zeros(s_pad, np.float32)
    t1a = np.zeros(s_pad, np.float32)
    t0a[:s] = np.asarray(t0s, np.float32)
    t1a[:s] = np.asarray(t1s, np.float32)
    enabled = np.zeros(s_pad, bool)
    enabled[:s] = True
    return SuperchunkXs(chunk=chunk, t0=t0a, t1=t1a, enabled=enabled,
                        born_lo=ctl.born_lo, migrating=ctl.migrating,
                        old_sel=ctl.old_sel)


def first_event(violated: np.ndarray, overflow: np.ndarray,
                n_enabled: int, escalate: bool) -> Optional[int]:
    """Index of the first in-window chunk needing host attention.

    An *event* is an invariant flag on any partition, or (when escalation
    is on) a truncated join — both require the host before the *next*
    chunk runs.  Returns None when the window is event-free.
    """
    ev = violated[:n_enabled].reshape(n_enabled, -1).any(axis=1)
    if escalate:
        ev = ev | (overflow[:n_enabled].reshape(n_enabled, -1).sum(axis=1)
                   > 0)
    idx = np.nonzero(ev)[0]
    return int(idx[0]) if idx.size else None


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------


def _packing(specs):
    """Byte offsets of (shape, torch dtype) leaves packed one after the
    other, each 16-byte aligned; returns (offsets, total bytes)."""
    offs, total = [], 0
    for shape, dtype in specs:
        offs.append(total)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        total += -(-nbytes // 16) * 16
    return offs, max(total, 16)


def _unpack(buf, specs, offs):
    """Views of the packed leaves of a flat uint8 tensor."""
    out = []
    for (shape, dtype), o in zip(specs, offs):
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out.append(buf[o:o + n].view(dtype).view(shape))
    return out


def _upload(arrays, device):
    """Host arrays -> device tensors of the same dtypes and shapes, in one
    host-to-device copy (packed into one byte buffer)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    specs = [(a.shape, torch.from_numpy(a[:0].reshape(-1)).dtype)
             for a in arrays]
    offs, total = _packing(specs)
    buf = np.zeros(total, np.uint8)
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    return _unpack(torch.from_numpy(buf).to(device), specs, offs)


def _flat(x):
    """The tensor leaves of a (nested) NamedTuple, or a lone tensor."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in x for t in _flat(f)]


def _copy_into(dst, src) -> None:
    for d, s in zip(_flat(dst), _flat(src)):
        d.copy_(s)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if type(x) is tuple:
        return tuple(_clone(f) for f in x)
    return type(x)(*(_clone(f) for f in x))


def _blend(sel, cur, old):
    """Per-partition row select of two operand trees: ``cur`` where
    ``sel`` (K,), else ``old``."""
    if isinstance(cur, torch.Tensor):
        s = sel.reshape((-1,) + (1,) * (cur.dim() - 1))
        return torch.where(s, cur, old)
    return type(cur)(*(_blend(sel, c, o) for c, o in zip(cur, old)))


class _Carry:
    """The window's carry — ring buffers (and statistics rings) — packed
    into one flat byte tensor, so that a snapshot after a chunk is one
    device copy; ``views`` rebuilds the NamedTuples over any such
    buffer."""

    def __init__(self, buffers, monitor):
        leaves = _flat(buffers) + (_flat(monitor) if monitor is not None
                                   else [])
        self.n_buffers = len(buffers)
        self.has_monitor = monitor is not None
        self.specs = [(tuple(t.shape), t.dtype) for t in leaves]
        self.offs, self.nbytes = _packing(self.specs)
        self.flat = torch.empty(self.nbytes, dtype=torch.uint8,
                                device=leaves[0].device)
        self.buffers, self.monitor = self.views(self.flat)
        _copy_into(self.buffers, buffers)
        if monitor is not None:
            _copy_into(self.monitor, monitor)

    def views(self, flat):
        leaves = _unpack(flat, self.specs, self.offs)
        buffers = Buffers(*leaves[:self.n_buffers])
        monitor = (MonitorState(*leaves[self.n_buffers:])
                   if self.has_monitor else None)
        return buffers, monitor


def _on(dev):
    """``dev`` as the current CUDA device (a capture records, and a
    replay launches, on the current device's stream); a no-op off CUDA."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _capture(dev, step):
    """Capture ``step`` (a closure over static tensors) as a CUDA graph in
    the device's shared pool; returns ``(graph, outputs, launches)``.

    Warm-up runs on a side stream against the static tensors before a
    window copies its carry in, so no chunk reaches the live state twice;
    the capture records every kernel launch of the step.  Python's cyclic
    garbage collector is held off during the capture: a collection there
    may free an earlier session's graph (sessions and their windows form
    reference cycles), and destroying a graph while a stream captures
    invalidates the capture.  The capture stream is the device's own
    (``_STREAMS``): ``torch.cuda.graph``'s default is one stream for the
    whole process, made on the first capture's device, and a capture on
    another device's stream than its tensors' fails.
    """
    _wj.load_library()
    pool = _POOLS.get(dev.index)
    if pool is None:
        pool = _POOLS[dev.index] = torch.cuda.graph_pool_handle()
    stream = _STREAMS.get(dev.index)
    if stream is None:
        stream = _STREAMS[dev.index] = torch.cuda.Stream(device=dev)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        with _wj.capturing() as launches:
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                outs = step()
    finally:
        if gc_was_on:
            gc.enable()
    COUNTS["captures"] += 1
    return graph, outs, launches


class _Statics(NamedTuple):
    """The static tensors a window step reads and updates."""

    carry: _Carry
    chunk: Chunk
    t0: torch.Tensor       # () f32 shared chunk clock
    t1: torch.Tensor       # () f32
    born_lo: torch.Tensor  # (K,) f32
    migrating: torch.Tensor  # (K,) bool
    old_sel: torch.Tensor  # (K,) bool
    cur_ops: object
    old_ops: object
    lowered: object


class SuperchunkWindow:
    """The window function of one ``FleetEngine`` config, monitored or
    plain: ``window(buffers, monitor, cur_rows, old_rows, lowered, xs) ->
    (buffers, monitor, SuperchunkOut)``, the counterpart of the
    reference's compiled ``make_superchunk_scan``.

    ``buffers``/``monitor`` are the pre-window carry: copied into the
    static carry, never written.  The returned carry is the one after the
    last enabled chunk; ``ys.carry_after(s)`` gives the one after chunk
    ``s``.
    ``cur_rows``/``old_rows`` are the (K, ...) plan row matrices (host
    numpy), ``lowered`` the stacked device invariant rows (monitored
    windows; None otherwise).  Static tensors and captured graphs are
    tables inside the window, keyed by the shapes of the static tensors
    (and graphs also by variant: pass A, pass A + B), so an equal-config
    engine that shares the window through the fleet's memo replays its
    graphs.  A call is ``stage`` (the host inputs go up) then ``launch``
    (the replays); a meshed fleet's window (``MeshWindow``) stages every
    block before it launches any.
    """

    def __init__(self, fleet, monitored: bool):
        self.fleet = fleet
        self.monitored = bool(monitored)
        base = fleet.base
        self._process = base.process
        self._mprocess = (make_monitored_process(
            base.process, base.spec, fleet.monitor_laplace)
            if monitored else None)
        self._bodies = {with_b: functools.partial(self._body, with_b)
                        for with_b in (False, True)}
        self._statics: Dict[tuple, _Statics] = {}
        self._graphs: Dict[tuple, tuple] = {}

    # -- the step ------------------------------------------------------------

    def _body(self, with_b: bool, buffers, monitor, cur_ops, old_ops,
              lowered, x: SuperchunkXs):
        """One chunk ``x`` (a row of ``SuperchunkXs``): pass A (monitored
        or plain), pass B where ``with_b``.  Returns ``(buffers, monitor,
        (out (K, 7) i32, rates (K, n), sel (K, n, n)))``, every output
        leading with this block's partitions."""
        k, n = x.born_lo.shape[0], self.fleet.pattern.n
        dev = x.born_lo.device
        t0, t1 = x.t0.expand(k), x.t1.expand(k)
        pos_v = torch.full((k,), POS_INF, dtype=torch.float32, device=dev)
        if self.monitored:
            buffers, monitor, res, violated, drift, rates, sel = \
                self._mprocess(buffers, monitor, x.chunk, cur_ops, lowered,
                               t0, t1, x.born_lo, pos_v)
        else:
            buffers, res = self._process(buffers, x.chunk, cur_ops, t0, t1,
                                         x.born_lo, pos_v)
            violated = torch.zeros((k,), dtype=torch.bool, device=dev)
            drift = torch.full((k,), NEG_INF, dtype=torch.float32,
                               device=dev)
            rates = torch.zeros((k, n), dtype=torch.float32, device=dev)
            sel = torch.zeros((k, n, n), dtype=torch.float32, device=dev)
        counters = torch.stack([c.to(torch.int32) for c in res], dim=1)
        if with_b:
            # Pass B: old plans over an empty chunk pick up matches born
            # before each partition's replan; non-migrating partitions are
            # masked out of the counters.
            empty = x.chunk._replace(valid=torch.zeros_like(x.chunk.valid))
            old_eff = _blend(x.old_sel, cur_ops, old_ops)
            neg_v = torch.full((k,), NEG_INF, dtype=torch.float32,
                               device=dev)
            buffers, res_b = self._process(buffers, empty, old_eff, t0, t1,
                                           neg_v, x.born_lo)
            extra = torch.stack([c.to(torch.int32) for c in res_b], dim=1)
            counters = counters + torch.where(x.migrating[:, None], extra, 0)
        out = torch.cat([counters, violated.to(torch.int32)[:, None],
                         drift.to(torch.float32).view(torch.int32)[:, None]],
                        dim=1)
        return buffers, monitor, (out, rates, sel)

    def _step(self, st: _Statics, with_b: bool):
        """One chunk from the static inputs; writes the carry into ``st``
        and returns ``(head (7, K) i32, rates (K, n), sel (K, n, n))``."""
        carry = st.carry
        x = SuperchunkXs(st.chunk, st.t0, st.t1, None, st.born_lo,
                         st.migrating, st.old_sel)
        buffers, monitor, (out, rates, sel) = self._bodies[with_b](
            carry.buffers, carry.monitor, st.cur_ops, st.old_ops, st.lowered,
            x)
        _copy_into(carry.buffers, buffers)
        if monitor is not None:
            _copy_into(carry.monitor, monitor)
        return out.T, rates, sel

    # -- statics and graphs --------------------------------------------------

    def _get_statics(self, buffers, monitor, cur_ops, old_ops, lowered,
                     chunk):
        """The static tensors for these shapes, created (as copies of the
        first window's inputs, so every value is valid) on first use."""
        key = tuple(tuple(t.shape) for t in _flat(
            (buffers, chunk, cur_ops)
            + ((monitor, lowered) if self.monitored else ())))
        st = self._statics.get(key)
        if st is None:
            dev = self.fleet.device
            k = self.fleet.k
            f32 = dict(dtype=torch.float32, device=dev)
            st = self._statics[key] = _Statics(
                carry=_Carry(buffers, monitor if self.monitored else None),
                chunk=Chunk(*(c[0].clone() for c in chunk)),
                t0=torch.zeros((), **f32),
                t1=torch.ones((), **f32),
                born_lo=torch.full((k,), NEG_INF, **f32),
                migrating=torch.zeros((k,), dtype=torch.bool, device=dev),
                old_sel=torch.zeros((k,), dtype=torch.bool, device=dev),
                cur_ops=_clone(cur_ops), old_ops=_clone(old_ops),
                lowered=_clone(lowered) if self.monitored else None)
        return key, st

    def _graph(self, key, st: _Statics, with_b: bool):
        """The captured step of this variant (CUDA only; ``_capture``)."""
        gkey = (key, with_b)
        entry = self._graphs.get(gkey)
        if entry is None:
            entry = self._graphs[gkey] = _capture(
                self.fleet.device, lambda: self._step(st, with_b))
        return entry

    # -- the window ----------------------------------------------------------

    def __call__(self, buffers, monitor, cur_rows, old_rows, lowered,
                 xs: SuperchunkXs):
        return self.launch(buffers, monitor, lowered,
                           self.stage(cur_rows, old_rows, xs))

    def stage(self, cur_rows, old_rows, xs: SuperchunkXs):
        """The window's host inputs on the device: its chunks and control
        in one host-to-device copy, and the plan operands (the fleet's
        cache: an upload only when the rows changed)."""
        fleet = self.fleet
        n_run = int(np.asarray(xs.enabled).sum())
        if n_run == 0 or not np.asarray(xs.enabled)[:n_run].all():
            raise ValueError("enabled chunks must be a non-empty prefix of "
                             "the window")
        up = _upload([*xs.chunk, xs.t0, xs.t1, xs.born_lo, xs.migrating,
                      xs.old_sel], fleet.device)
        with_b = np.asarray(xs.migrating)[:n_run].any(axis=1)
        return (Chunk(*up[:4]), up[4:], fleet.plan_operands(cur_rows),
                fleet.plan_operands(old_rows), with_b)

    def launch(self, buffers, monitor, lowered, staged):
        """The window's replays (eager steps on the CPU) over ``stage``'s
        inputs, with the fleet's device current; no host sync after a
        graph's first capture."""
        with _on(self.fleet.device):
            return self._launch(buffers, monitor, lowered, staged)

    def _launch(self, buffers, monitor, lowered, staged):
        fleet = self.fleet
        chunk, (t0, t1, born_lo, migrating, old_sel), cur_ops, old_ops, \
            with_b = staged
        n_run = len(with_b)
        key, st = self._get_statics(buffers, monitor, cur_ops, old_ops,
                                    lowered, chunk)
        on_cuda = fleet.device.type == "cuda"
        graphs = ({b: self._graph(key, st, b) for b in set(with_b.tolist())}
                  if on_cuda else {})
        # The window's carry and plan-constant inputs: device copies.
        carry = st.carry
        _copy_into(carry.buffers, buffers)
        if self.monitored:
            _copy_into(carry.monitor, monitor)
            _copy_into(st.lowered, lowered)
        _copy_into(st.cur_ops, cur_ops)
        _copy_into(st.old_ops, old_ops)

        s_len, k, n = len(t0), fleet.k, fleet.pattern.n
        dev = fleet.device
        head = torch.zeros((s_len, 7, k), dtype=torch.int32, device=dev)
        head[:, 6] = _NEG_INF_BITS
        rates = torch.zeros((s_len, k, n), dtype=torch.float32, device=dev)
        sel = torch.zeros((s_len, k, n, n), dtype=torch.float32, device=dev)
        snaps = torch.empty((n_run, carry.nbytes), dtype=torch.uint8,
                            device=dev)
        for s in range(n_run):
            _copy_into(st.chunk, Chunk(*(c[s] for c in chunk)))
            st.t0.copy_(t0[s])
            st.t1.copy_(t1[s])
            st.born_lo.copy_(born_lo[s])
            st.migrating.copy_(migrating[s])
            st.old_sel.copy_(old_sel[s])
            if on_cuda:
                graph, outs, launches = graphs[bool(with_b[s])]
                graph.replay()
                _wj.count_replay(launches)
                COUNTS["replays"] += 1
            else:
                outs = self._step(st, bool(with_b[s]))
                COUNTS["eager_steps"] += 1
            head[s].copy_(outs[0])
            rates[s].copy_(outs[1])
            sel[s].copy_(outs[2])
            snaps[s].copy_(carry.flat)
        COUNTS["windows"] += 1
        ys = SuperchunkOut(head, rates, sel, snaps, carry)
        return (*ys.carry_after(n_run - 1), ys)


def block_xs(layout, xs):
    """Each block's window inputs (a ``SuperchunkXs`` or a
    ``RulebookXs`` of host arrays): leaves led by (S, K) cut along K, the
    clock and the gate, led by S alone, shared."""
    chunk = [layout.split(c, axis=1) for c in xs.chunk]
    rest = [layout.split(x, axis=1) for x in xs[1:]]
    return [type(xs)(Chunk(*(c[i] for c in chunk)), *(r[i] for r in rest))
            for i in range(layout.d)]


class MeshWindow:
    """A meshed fleet's window: one ``SuperchunkWindow`` per block, each
    with its own statics and CUDA graphs on its block's device, so no
    graph spans two devices.  Same call as a ``SuperchunkWindow``, with
    ``Blocks`` for the carry and the lowered rows and host (K, ...) plan
    rows and window inputs, which are cut per block here.  Every block is
    staged (its slice of the window uploaded to its device) before any
    block launches, and every block launches its replays before the host
    reads any back; the result is ``(Blocks, Blocks or None, MeshOut)``.
    """

    def __init__(self, layout, windows):
        self.layout = layout
        self.windows = list(windows)

    def __call__(self, buffers, monitor, cur_rows, old_rows, lowered,
                 xs: SuperchunkXs):
        return self.launch(buffers, monitor, lowered,
                           self.stage(cur_rows, old_rows, xs))

    def stage(self, cur_rows, old_rows, xs: SuperchunkXs):
        """Every block's ``SuperchunkWindow.stage``, as ``Blocks``."""
        lay = self.layout
        cur, old = lay.split(cur_rows), lay.split(old_rows)
        return Blocks(w.stage(c, o, x) for w, c, o, x in
                      zip(self.windows, cur, old, block_xs(lay, xs)))

    def launch(self, buffers, monitor, lowered, staged):
        """Every block's ``SuperchunkWindow.launch`` over its staged
        inputs."""
        state, mon, outs = map_blocks(
            lambda w, b, m, low, st: w.launch(b, m, low, st),
            Blocks(self.windows), buffers, monitor, lowered, staged)
        return state, mon, MeshOut(tuple(outs))


# ---------------------------------------------------------------------------
# The rulebook window: S chunks × K partitions × Qb rules per window
# ---------------------------------------------------------------------------


class RulebookXs(NamedTuple):
    """Rulebook window inputs; every leaf leads with ``S``.

    The rulebook deploys plan rows immediately (serving semantics: no [36]
    migration split), so the only reactive control is the invariant flag;
    ``enabled`` (host numpy) marks the chunks the window runs, a prefix.
    ``stack_rulebook_window`` gives numpy leaves, ``upload_rulebook_window``
    the same leaves on the device in one copy.
    """

    chunk: Chunk          # (S, K, cap) / (S, K, cap, A) fields
    t0: object            # (S,) f32
    t1: object            # (S,) f32
    enabled: np.ndarray   # (S,) bool


# The rulebook window's outputs: a ``SuperchunkOut`` whose ``head`` is
# (S, 7, K, Qb), ``rates`` (S, K, Qb, n) and ``sel`` (S, K, Qb, n, n), so
# ``host()`` gives (S, K, Qb) counters, flags and drift.
RulebookOut = SuperchunkOut


def stack_rulebook_window(chunks: Sequence[Chunk], t0s, t1s,
                          s_pad: int) -> RulebookXs:
    """Stack a window of stacked ``(K, ...)`` host chunks into rulebook
    window inputs, padding short windows with disabled repeats of the last
    chunk, as in the reference."""
    s = len(chunks)
    if s == 0:
        raise ValueError("empty superchunk window")
    padded = list(chunks) + [chunks[-1]] * (s_pad - s)
    chunk = Chunk(*(np.stack([np.asarray(c[i]) for c in padded])
                    for i in range(len(Chunk._fields))))
    t0a = np.zeros(s_pad, np.float32)
    t1a = np.zeros(s_pad, np.float32)
    t0a[:s] = np.asarray(t0s, np.float32)
    t1a[:s] = np.asarray(t1s, np.float32)
    enabled = np.zeros(s_pad, bool)
    enabled[:s] = True
    return RulebookXs(chunk=chunk, t0=t0a, t1=t1a, enabled=enabled)


def upload_rulebook_window(xs: RulebookXs, device) -> RulebookXs:
    """The window's chunks and clock on ``device``: one host-to-device
    copy."""
    up = _upload([*xs.chunk, xs.t0, xs.t1], device)
    return RulebookXs(Chunk(*up[:4]), up[4], up[5], xs.enabled)


class _RulebookStatics(NamedTuple):
    """The static tensors a rulebook window step reads and updates."""

    carry: _Carry
    chunk: Chunk
    t0: torch.Tensor   # () f32
    t1: torch.Tensor   # () f32
    ops: object
    share: object
    plans: object
    lowered: object


class RulebookWindow:
    """The window function of one rulebook bucket config: ``window(state,
    monitor, ops, share, plans, lowered, xs) -> (state, monitor,
    RulebookOut)``, the counterpart of the reference's scanned plane
    (``make_rulebook_scan``, which builds it through the memo).

    ``state``/``monitor`` are the pre-window carry (copied into the static
    carry, never written); ``ops``/``share``/``plans``/``lowered`` the
    bucket's device tensors, window-constant; ``xs`` an uploaded
    ``RulebookXs``.  The returned carry is the one after the last enabled
    chunk; ``ys.carry_after(s)`` gives the one after chunk ``s`` (the
    reference re-runs the window's prefix instead).  Static tensors and
    graphs are per-shape tables: on CUDA the step is captured once per
    shape signature — a hot-added rule in a free slot changes no shape,
    bucket growth does — and replayed per chunk; on the CPU it runs
    eagerly.  ``traces`` counts the shape signatures entered (one capture
    each on the card), the counterpart of the reference plane's retrace
    counter.  A meshed rulebook's window is one such window per block
    (``MeshRulebookWindow``).
    """

    def __init__(self, bspec, cfg, monitored: bool, laplace: float = 1.0):
        from .multipattern import _make_bucket_step

        self.bspec = bspec
        self.monitored = bool(monitored)
        self.traces = 0
        self._bucket_step = _make_bucket_step(bspec, cfg, monitored, laplace)
        self._statics: Dict[tuple, _RulebookStatics] = {}
        self._graphs: Dict[tuple, tuple] = {}

    def _chunk_body(self, state, monitor, ops, share, plans, lowered,
                    x: RulebookXs):
        """One chunk ``x`` (a row of ``RulebookXs``) through the bucket
        step; returns ``(state, monitor, (out (K, 7, Qb) i32, rates,
        sel))``, every output leading with this block's partitions."""
        state, monitor, res, violated, drift, rates, sel = self._bucket_step(
            state, monitor, x.chunk, ops, share, plans, lowered, x.t0, x.t1)
        out = torch.stack([c.to(torch.int32) for c in res]
                          + [violated.to(torch.int32),
                             drift.to(torch.float32).view(torch.int32)],
                          dim=1)
        return state, monitor, (out, rates, sel)

    def _step(self, st: _RulebookStatics):
        """One chunk from the static inputs; writes the carry into ``st``
        and returns ``(head (7, K, Qb) i32, rates, sel)``."""
        carry = st.carry
        state, monitor, (out, rates, sel) = self._chunk_body(
            carry.buffers, carry.monitor, st.ops, st.share, st.plans,
            st.lowered, RulebookXs(st.chunk, st.t0, st.t1, None))
        _copy_into(carry.buffers, state)
        if monitor is not None:
            _copy_into(carry.monitor, monitor)
        return out.transpose(0, 1), rates, sel

    def __call__(self, state, monitor, ops, share, plans, lowered,
                 xs: RulebookXs):
        with _on(state.ts.device):
            return self._call(state, monitor, ops, share, plans, lowered, xs)

    def _call(self, state, monitor, ops, share, plans, lowered, xs):
        monitored = self.monitored
        enabled = np.asarray(xs.enabled)
        n_run = int(enabled.sum())
        if n_run == 0 or not enabled[:n_run].all():
            raise ValueError("enabled chunks must be a non-empty prefix of "
                             "the window")
        dev = state.ts.device
        consts = (ops, share, plans) + ((lowered,) if monitored else ())
        key = tuple(tuple(t.shape) for t in _flat(
            (state, xs.chunk) + consts
            + ((monitor,) if monitored else ())))
        st = self._statics.get(key)
        if st is None:
            self.traces += 1
            st = self._statics[key] = _RulebookStatics(
                carry=_Carry(state, monitor if monitored else None),
                chunk=Chunk(*(c[0].clone() for c in xs.chunk)),
                t0=torch.zeros((), dtype=torch.float32, device=dev),
                t1=torch.ones((), dtype=torch.float32, device=dev),
                ops=_clone(ops), share=_clone(share), plans=_clone(plans),
                lowered=_clone(lowered) if monitored else None)
        on_cuda = dev.type == "cuda"
        graph = None
        if on_cuda:
            graph = self._graphs.get(key)
            if graph is None:
                graph = self._graphs[key] = _capture(
                    dev, lambda: self._step(st))
        # The window's carry and constant inputs: device copies.
        carry = st.carry
        _copy_into(carry.buffers, state)
        if monitored:
            _copy_into(carry.monitor, monitor)
            _copy_into(st.lowered, lowered)
        _copy_into(st.ops, ops)
        _copy_into(st.share, share)
        _copy_into(st.plans, plans)

        s_len = len(enabled)
        k, qb = state.ptr.shape[:2]
        n = self.bspec.n
        head = torch.zeros((s_len, 7, k, qb), dtype=torch.int32, device=dev)
        head[:, 6] = _NEG_INF_BITS
        rates = torch.zeros((s_len, k, qb, n), dtype=torch.float32,
                            device=dev)
        sel = torch.zeros((s_len, k, qb, n, n), dtype=torch.float32,
                          device=dev)
        snaps = torch.empty((n_run, carry.nbytes), dtype=torch.uint8,
                            device=dev)
        for s in range(n_run):
            _copy_into(st.chunk, Chunk(*(c[s] for c in xs.chunk)))
            st.t0.copy_(xs.t0[s])
            st.t1.copy_(xs.t1[s])
            if on_cuda:
                g, outs, launches = graph
                g.replay()
                _wj.count_replay(launches)
                COUNTS["replays"] += 1
            else:
                outs = self._step(st)
                COUNTS["eager_steps"] += 1
            head[s].copy_(outs[0])
            rates[s].copy_(outs[1])
            sel[s].copy_(outs[2])
            snaps[s].copy_(carry.flat)
        COUNTS["windows"] += 1
        ys = RulebookOut(head, rates, sel, snaps, carry)
        return (*ys.carry_after(n_run - 1), ys)


class MeshRulebookWindow:
    """A meshed rulebook's window: one ``RulebookWindow`` per block, each
    with its own statics and graphs on its block's device.  Same call as
    a ``RulebookWindow`` with ``Blocks`` throughout (``xs`` too: each
    block's slice of the window, uploaded to its device); every block
    launches its replays before the host reads any back.  Returns
    ``(Blocks, Blocks or None, MeshOut)``."""

    def __init__(self, windows):
        self.windows = list(windows)

    @property
    def traces(self) -> int:
        """Shape signatures entered (every block enters the same ones)."""
        return max(w.traces for w in self.windows)

    def __call__(self, state, monitor, ops, share, plans, lowered, xs):
        state, monitor, outs = map_blocks(
            lambda w, *a: w(*a), Blocks(self.windows), state, monitor, ops,
            share, plans, lowered, xs)
        return state, monitor, MeshOut(tuple(outs))


def make_rulebook_scan(bspec, cfg, k: int, monitored: bool,
                       laplace: float = 1.0, mesh=None):
    """The bucket window of this config, from the process-wide memo.

    Like the per-chunk plane (``multipattern.make_rulebook_plane``) the
    key leaves out every capacity (Qb, lattice class counts, S): growing a
    bucket under superchunk re-enters the SAME window with a new shape —
    one capture, no new memo entry — and equal-config rulebooks share its
    captures.  Meshed windows (one per block) are never shared.
    """
    from .fleet import _memo_config, _shared_trace

    if mesh is not None:
        return MeshRulebookWindow(
            RulebookWindow(bspec, cfg, monitored, laplace)
            for _ in mesh.devices)
    return _shared_trace(
        ("rulebook-scan", bspec, _memo_config(cfg), int(k), bool(monitored),
         float(laplace)),
        lambda: RulebookWindow(bspec, cfg, monitored, laplace))
