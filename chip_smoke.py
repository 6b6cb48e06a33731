#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the CEP runtime on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

1. device   — torch's device name, and nvidia-smi's name and power limit;
2. build    — nvcc builds the CUDA kernels from ``src/repro_torch``;
3. kernels  — each of the five kernels against its plain PyTorch version
              on the card, bit for bit, at its path's shapes, at ragged
              shapes, over every op code with ties and negative
              thresholds, on all-op-0 stacks and on stacks led by the
              engine's validity rows (tiles that end at the first row):
              the two joins' bit words and row counts, the row and pair
              counts, and the survivor selection (with overflow, zero
              survivors and a capacity past M*B); median times (CUDA
              events) beside each kernel's bound, and the counts' and the
              tree join's times on validity-led stacks.  The packed join
              and the row count also with a threshold row per batch
              element (rows that differ) at the rulebook's shapes (the
              unpacked join and the pair count at a ragged one), and a
              shared (C,) vector (batch stride 0) against the same values
              as (K, C);
4. main     — ``repro_torch.cep.open(..., plan="order").run(...)`` on the
              K=16 FlowSense alert rule at full width, with the launch
              counters zeroed just before and read just after; then the
              same stream again with ``backend="ref"`` (plain versions, on
              the card), which must give equal integer telemetry;
5. oracle   — a narrow K=4 order-plan stream on the card against the
              brute-force ``RefEngine``;
6. profile  — the first chunks of the main path under ``torch.profiler``:
              device-busy share and the ops with the most device time;
              fails if a device-wide scan (an M*B-cell scan) remains;
7. tree     — phases 4-6 for ``plan="tree"`` (ZStream trees, the unpacked
              join): the full-width run with its own launch counts and its
              plain rerun, the narrow run against ``RefEngine``, and the
              profile of its first chunks;
8. superchunk — for each plan, the same K=16 session with
              ``superchunk=8`` (``core/scan.py``: each chunk of a window is
              one replay of a captured CUDA graph, no host sync inside the
              window); its integer telemetry and per-partition matches
              must equal the per-chunk kernel run of phase 4 / 7 (itself
              held against the plain versions), and so must the same
              window run with ``backend="ref"`` (the plain versions,
              captured and replayed on the card).  Prints events/s beside
              the per-chunk run's, peak memory, graph captures and
              replays, in-window events (windows cut at a flag or an
              overflow and continued from the carry of that chunk), and per
              kernel the launches the captures recorded times their
              replays;
9. window profile — 16 chunks of the order window path under
              ``torch.profiler``, after a first run that captured its
              graphs: device-busy share of the wall;
10. serving — a monitored K=16 order session driven chunk by chunk
              through ``Session.step`` over the 64 chunks, and a second one
              through ``Session.step_superchunk`` with S=8, and a third
              with S=8 and ``backend="ref"``: per-chunk match arrays,
              violations, replans and host syncs must be equal;
11. rulebook — ``repro_torch.cep.open_rulebook`` with the FlowSense
              tenant's three rules (alert chain, acknowledgement, combo:
              two buckets, n=3 with negation and n=2 fusing two rules of
              different windows and predicates, so the per-batch
              thresholds are live), K=16, the 64 chunks of phase 4, one
              spare slot per bucket: ``run`` per chunk with the launch
              counters zeroed just before and read just after; zero
              overflow; per-rule counters equal three solo sessions
              (``Session.step``), the ``backend="ref"`` rerun, and the
              ``superchunk=8`` window run; a narrow K=4 run equals
              ``RefEngine``; a fourth rule hot-added into a spare slot
              after 32 chunks of a window run builds no kernel and
              captures no graph, and equals its solo session.  Prints
              events/s and peak memory of the per-chunk and window runs;
              then 16 chunks of the per-chunk rulebook under
              ``torch.profiler`` (as phase 6).

Launch counts: the counters are zeroed just before each path runs and
read just after.  ``LAUNCHES`` counts wrapper calls that launch a kernel;
a graph replay calls no wrapper, so the window paths also count
``GRAPH_LAUNCHES`` (the launches a capture recorded, once per replay), and
each of their kernels must show graph launches.  A window path's
``launches_by_path`` entry is the sum of the two; the rulebook's are
"rulebook" and "rulebook window".

The survivor selection's record is a JSON line of its own; the line
before the last is the JSON ``kernels`` record of the four kernels that
replace TPU kernels; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits with code 1 and prints no result.

``python3 chip_smoke.py --bench N`` (a measurement, not the check) runs
only the device and build phases, then for the order and tree sessions
and the serving plane N per-chunk and N window runs of the K=16 stream
in turns (per-chunk, window, window, per-chunk, ...), each held to equal
telemetry, and prints each run's events/s over all 64 chunks (graph
captures included) and over the chunks after the first 8, with the
medians and ranges.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# The FlowSense alert rule (src/repro/data/scenarios/flowsense.py:40-44):
# temperature spike, no acknowledgement, humidity drop, gas alarm.
TEMP, HUMID, GAS, ACK = 0, 1, 2, 3
K_MAIN = 16
CHUNKS_MAIN = 64
BASE_RATE = 40.0
CHUNK_CAP = 512
B_CAP = 1024
M_CAP = 8192

# Monitored tree sessions need explicit invariant caps (the ZStream set's
# size depends on the statistics): the JAX tests'.  A replan whose set
# outgrows them raises, so a run that finishes shows they suffice.
TREE_CAPS = dict(max_invariants=8, max_terms=16)
# One pow2 escalation of a tree step (m_cap 16384) holds a 512 MiB bit
# mask and no running count, so memory no longer limits it.  The cap
# stays at one step so the tree path's work matches the earlier
# measurements in PERF.md; the port's first benchmark is where to raise it.
TREE_MAX_ESCALATIONS = 1
# Chunks per window of the superchunk and serving phases.
SUPERCHUNK = 8
# --bench times each run's first chunks (graph captures) apart.
BENCH_SPLIT = 8

# The rulebook phase: one spare slot per bucket (the hot add's), and the
# chunk after which the fourth rule is hot-added.
RULEBOOK_SPARE = 1
HOT_ADD_AT = 32

SOURCE = "src/repro_torch/kernels/csrc/window_join.cu"
REPLACES = {
    "window_join_packed": "src/repro/kernels/window_join.py:295",
    "window_join_rowcount": "src/repro/kernels/window_join.py:383",
    "window_join": "src/repro/kernels/window_join.py:120",
    "window_join_count": "src/repro/kernels/window_join.py:202",
}
# The survivor selection replaces the reference's jnp.nonzero in _compact,
# not a TPU kernel.
SELECT = "select_survivors"
SELECT_REPLACES = "src/repro/core/engine.py:167"
# The kernels each path must launch.
PATH_KERNELS = {"order": ("window_join_packed", "window_join_rowcount",
                          SELECT),
                "tree": ("window_join", "window_join_rowcount", SELECT)}
INT_FIELDS = ("chunks", "events", "matches", "replans", "deployments",
              "violations", "host_syncs", "overflow", "dropped",
              "neg_rejected", "closure_expansions", "escalations",
              "migration_partition_chunks")


def flowsense_rule():
    from repro_torch.cep import P

    return (P.seq(TEMP, P.neg(ACK), HUMID, GAS)
            .where(P.attr(0) < P.attr(1) + 0.3,
                   P.attr(1) < P.attr(2) + 0.3)
            .within(3.0))


def flowsense_rulebook():
    """The FlowSense tenant rulebook (src/repro/data/scenarios/flowsense.py:
    63, rules at :40-59): the alert chain, the acknowledged spike, and the
    humidity-gas combo."""
    from repro_torch.cep import P

    return [flowsense_rule(),
            P.seq(TEMP, ACK).within(3.0),
            P.and_(HUMID, GAS).where(P.attr(0) < P.attr(1) + 0.3)
            .within(2.0)]


def hot_added_rule():
    """The fourth rule, hot-added into the n=2 bucket's spare slot: a
    humidity drop followed by a gas alarm with ascending readings."""
    from repro_torch.cep import P

    return (P.seq(HUMID, GAS).where(P.attr(0) < P.attr(1) + 0.3)
            .within(2.0))


def streams(k, n_chunks, base_rate, chunk_cap, seed=0):
    from repro_torch.data.cep_streams import StreamConfig, traffic_stream

    cfg = StreamConfig(n_types=4, n_chunks=n_chunks, chunk_cap=chunk_cap,
                       base_rate=base_rate, shift_every=16.0)
    return [traffic_stream(dataclasses.replace(cfg, seed=seed + p))
            for p in range(k)]


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name, t):
    print(f"   {name} seconds: {time.perf_counter() - t:.3f}", flush=True)


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------


def coarse(gen, shape, device):
    """Values on a 0.25 grid, so l == r + theta ties occur often."""
    import torch

    return (torch.randint(-8, 9, shape, generator=gen, device=device)
            .to(torch.float32) * 0.25)


def packed_inputs(gen, k, c, m, b, device):
    import torch

    L = coarse(gen, (k, c, m), device)
    R = coarse(gen, (k, c, b), device)
    ops8 = torch.randint(0, 4, (k, c), generator=gen,
                         device=device).to(torch.int8)
    th = coarse(gen, (c,), device).abs()
    mv = (torch.rand((k, m), generator=gen, device=device) < 0.5)
    bv = (torch.rand((k, b), generator=gen, device=device) < 0.5)
    return L, R, ops8, th, mv, bv


def rowcount_inputs(gen, k, c, m, b, device):
    import torch

    L = coarse(gen, (k, c, m), device)
    R = coarse(gen, (k, c, b), device)
    ops = torch.randint(0, 5, (k, c), generator=gen,  # 4: "else true"
                        device=device).to(torch.int32)
    th = coarse(gen, (c,), device).abs() + 1.0
    return L, R, ops, th


def unpacked_inputs(gen, k, c, m, b, device):
    """Operands of the tree engine's join: every op code 0-4 (4: "else
    true") and thresholds of either sign."""
    import torch

    L = coarse(gen, (k, c, m), device)
    R = coarse(gen, (k, c, b), device)
    ops = torch.randint(0, 5, (k, c), generator=gen,
                        device=device).to(torch.int32)
    th = coarse(gen, (c,), device)
    return L, R, ops, th


def validity_first(args, gen):
    """``args`` (L, R, ops, thresholds) behind the engine's two validity
    rows (``core/engine.py::_validity_rows``): row 0 keeps the leading
    M/8 rows (``l > 1.0 - 0.5``), as the compaction packs live match slots
    first, so every 32 x 32 tile past them dies at the first row; row 1
    keeps about 3/4 of the columns (``1.0 < r + 0.5``)."""
    import torch

    L, R, ops, th = (a.clone() for a in args)
    k, c, m = L.shape
    b = R.shape[2]
    dev = L.device
    L[:, 0] = (torch.arange(m, device=dev) < m // 8).to(torch.float32)
    R[:, 0], ops[:, 0], th[0] = 1.0, 2, 0.5
    if c > 1:
        L[:, 1] = 1.0
        R[:, 1] = (torch.rand((k, b), generator=gen, device=dev)
                   < 0.75).to(torch.float32)
        ops[:, 1], th[1] = 1, 0.5
    return L, R, ops, th


def check_counts(args, what):
    """The row count and the pair count against their plain versions; an
    all-op-0 stack must count B per row and M*B per partition."""
    import torch

    from repro_torch.kernels import ops as kops

    k, c, m = args[0].shape
    b = args[1].shape[2]
    for fn in (kops.window_join_rowcount, kops.window_join_count):
        if not torch.equal(fn(*args), fn(*args, backend="ref")):
            raise AssertionError(f"{fn.__name__} kernel != plain at "
                                 f"{(k, c, m, b)} ({what})")
    if not bool((args[2] == 0).all()):
        return
    if not bool((kops.window_join_rowcount(*args) == b).all()):
        raise AssertionError(f"all-op-0 row count != B at {(k, c, m, b)}")
    if kops.window_join_count(*args).tolist() != [m * b] * k:
        raise AssertionError(f"all-op-0 count != M*B at {(k, c, m, b)}")


def cuda_ms(fn, reps=10, inner=5):
    """Median ms per call over ``reps`` event-timed runs of ``inner``
    calls each, after a warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def roofline(nbytes, n_ops):
    """(ms, what bounds it): the larger of the bytes over the card's
    memory rate and the f32 operations over its non-tensor f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bit_output_bytes(k, m, b):
    """Bytes of a bit-word join's outputs: (K, M, ceil(B/32)) int32 words
    and (K, M) int32 row counts."""
    return 4 * k * m * -(-b // 32) + 4 * k * m


def packed_bound(L, R, ops8, th, mv, bv):
    """Least time for the packed join on these inputs: each input read
    once and the bit words and row counts written once, against 3 f32
    operations (shift, compare, AND) per active constraint row of each
    valid cell."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel()) + ops8.numel() \
        + mv.numel() + bv.numel() + bit_output_bytes(k, m, b)
    cells = (mv.sum(1).double() * bv.sum(1).double())
    active = (ops8 != 0).sum(1).double()
    ops = float((cells * (3 * active + 1)).sum())
    return roofline(nbytes, ops)


def rowcount_bound(L, R, ops, th):
    """Least time for the row count: inputs read once, counts written
    once, against 3 f32 operations per active row of every (m, b) cell
    plus one add per cell."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel() + ops.numel() + k * m)
    active = ((ops >= 1) & (ops <= 3)).sum(1).double()
    ops_n = float((m * b * (3 * active + 1)).sum())
    return roofline(nbytes, ops_n)


def join_bound(L, R, ops, th):
    """Least time for the unpacked join on these inputs: each input read
    once and the bit words and row counts written once, against 3 f32
    operations (shift, compare, AND) per active constraint row of every
    cell."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel() + ops.numel()) \
        + bit_output_bytes(k, m, b)
    active = ((ops >= 1) & (ops <= 3)).sum(1).double()
    ops_n = float((m * b * 3 * active).sum())
    return roofline(nbytes, ops_n)


def count_bound(L, R, ops, th):
    """Least time for the pair count: inputs read once, K counts written
    once, against 3 f32 operations per active row of every cell plus one
    add per cell."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel() + ops.numel() + k)
    active = ((ops >= 1) & (ops <= 3)).sum(1).double()
    ops_n = float((m * b * (3 * active + 1)).sum())
    return roofline(nbytes, ops_n)


def select_bound(bits, counts, b, out_cap):
    """Least time for the survivor selection on these inputs: the row
    counts read once, the bit words of the rows holding a survivor ranked
    below ``out_cap`` read once, and the (K, out_cap) int64 indices written
    once; its operations (a popcount per word, an index per survivor) are
    negligible beside the bytes."""
    import torch

    k, m, w = bits.shape
    ends = torch.cumsum(counts, dim=1, dtype=torch.int64)
    needed = (counts > 0) & (ends - counts < out_cap)
    nbytes = 4 * counts.numel() + 4 * w * int(needed.sum()) \
        + 8 * k * out_cap
    return roofline(nbytes, 0)


def mask_err(got, want):
    """max_abs_err of a (bit words, row counts) pair: 1 if any mask cell
    differs, else the largest row-count difference."""
    import torch

    if not torch.equal(got[0], want[0]):
        return 1.0
    return float((got[1].to(torch.int64) - want[1].to(torch.int64))
                 .abs().max())


def check_select(bits, counts, b, caps, what):
    """The selection kernel against its plain version for each capacity."""
    import torch

    from repro_torch.kernels import ops as kops

    for cap in caps:
        got = kops.select_survivors(bits, counts, b, cap)
        want = kops.select_survivors(bits, counts, b, cap, backend="ref")
        if not torch.equal(got, want):
            raise AssertionError(f"select_survivors kernel != plain at "
                                 f"{tuple(bits.shape)}, B={b}, out_cap="
                                 f"{cap} ({what})")


def sparse_bits(gen, k, m, b, per_partition, device):
    """Bit words and row counts of a random mask with about
    ``per_partition`` survivors per partition spread over all rows: the
    selection's worst case at a capacity near that count (every row holds
    a survivor, every row's words are read)."""
    import torch

    from repro_torch.kernels import ref

    mask = torch.rand((k, m, b), generator=gen, device=device) \
        < per_partition / (m * b)
    return ref.pack_bits(mask), mask.sum(dim=-1, dtype=torch.int32)


def check_kernels(device, c_packed, c_rowcount, c_join):
    """The five kernels vs their plain versions at their paths' shapes and
    at ragged / extreme shapes; returns the timing records."""
    import torch

    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    # The validity-led stacks draw from their own generator, so the timed
    # inputs below stay the ones earlier runs timed.
    gen2 = torch.Generator(device=device)
    gen2.manual_seed(1)
    shapes = [(K_MAIN, c_packed, M_CAP, B_CAP), (3, 5, 1000, 333),
              (2, 32, 257, 129), (1, 1, 1, 1), (4, 64, 37, 1030)]
    n_select = 0
    for (k, c, m, b) in shapes:
        args = packed_inputs(gen, k, c, m, b, device)
        none = (args[0], args[1], torch.zeros_like(args[2]), *args[3:])
        for a, what in ((args, "mixed ops"), (none, "all-op-0 stack")):
            got = kops.window_join_packed_bits(*a)
            if mask_err(got, kops.window_join_packed_bits(
                    *a, backend="ref")) != 0:
                raise AssertionError(f"packed kernel != plain at "
                                     f"{(k, c, m, b)} ({what})")
            # Overflow (1, 100 or M_CAP below the survivors), a capacity
            # past M*B, and the real one.
            check_select(*got, b, (1, 100, M_CAP, m * b + 7), what)
            n_select += 4
    for (k, c, m, b) in [(K_MAIN, c_rowcount, M_CAP, B_CAP)] + shapes[1:]:
        args = rowcount_inputs(gen, k, c, m, b, device)
        check_counts(args, "mixed ops")
        check_counts(validity_first(args, gen2), "validity rows first")
    tree_shape = (K_MAIN, c_join, M_CAP, M_CAP)
    for (k, c, m, b) in [tree_shape] + shapes[1:]:
        args = unpacked_inputs(gen, k, c, m, b, device)
        none = (args[0], args[1], torch.zeros_like(args[2]), args[3])
        for a, what in ((args, "mixed ops"), (none, "all-op-0 stack"),
                        (validity_first(args, gen2), "validity rows first")):
            got = kops.window_join_bits(*a)
            if mask_err(got, kops.window_join_bits(*a, backend="ref")) != 0:
                raise AssertionError(f"join kernel != plain at "
                                     f"{(k, c, m, b)} ({what})")
            check_counts(a, what)
            check_select(*got, b, (1, M_CAP, m * b + 7), what)
            n_select += 3
    # Zero survivors, and about one survivor per row at the tree shape.
    k, _, m, b = tree_shape
    zero = (torch.zeros((k, m, -(-b // 32)), dtype=torch.int32,
                        device=device),
            torch.zeros((k, m), dtype=torch.int32, device=device))
    check_select(*zero, b, (1, M_CAP), "zero survivors")
    sparse = sparse_bits(gen, k, m, b, M_CAP, device)
    check_select(*sparse, b, (M_CAP // 2, M_CAP, 2 * M_CAP),
                 "one survivor per row")
    n_select += 5
    print(f"   bit-identical to the plain versions at {len(shapes)} packed, "
          f"{len(shapes)} rowcount and {len(shapes)} join/count shapes (all "
          "op codes, ties, negative thresholds, all-none stacks, validity "
          "rows first; all-op-0 counts == B per row, M*B) and in "
          f"{n_select} selections (overflow, zero survivors, capacity past "
          "M*B, ragged B)")

    records = {}
    p_args = packed_inputs(gen, K_MAIN, c_packed, M_CAP, B_CAP, device)
    r_args = rowcount_inputs(gen, K_MAIN, c_rowcount, M_CAP, B_CAP, device)
    u_args = unpacked_inputs(gen, *tree_shape, device)
    for name, fn, args, bound, diff in (
            ("window_join_packed", kops.window_join_packed_bits, p_args,
             packed_bound, mask_err),
            ("window_join_rowcount", kops.window_join_rowcount, r_args,
             rowcount_bound, None),
            ("window_join", kops.window_join_bits, u_args, join_bound,
             mask_err),
            ("window_join_count", kops.window_join_count, u_args,
             count_bound, None),
            (SELECT, kops.select_survivors, (*sparse, b, M_CAP),
             select_bound, None)):
        got = fn(*args)
        want = fn(*args, backend="ref")
        err = (diff(got, want) if diff else
               float((got.to(torch.int64) - want.to(torch.int64))
                     .abs().max()))
        ms = cuda_ms(lambda: fn(*args))
        plain_ms = cuda_ms(lambda: fn(*args, backend="ref"), reps=5,
                           inner=2)
        bound_ms, bound_by = bound(*args)
        shape = (f"(K, M, B, out_cap)={tuple(args[0].shape[:2]) + args[2:]}"
                 if name == SELECT else f"(K, C, M, B)="
                 f"{tuple(args[0].shape) + (args[1].shape[2],)}")
        print(f"   {name} {shape}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max_abs_err {err}")
        records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    # The counts beside the tree join on path-like stacks: the validity
    # rows first, 1/8 of the match slots live.
    g_u = validity_first(u_args, gen2)
    for name, fn, args in (
            ("window_join_rowcount", kops.window_join_rowcount,
             validity_first(r_args, gen2)),
            ("window_join", kops.window_join_bits, g_u),
            ("window_join_count", kops.window_join_count, g_u)):
        ms = cuda_ms(lambda: fn(*args))
        print(f"   {name} (K, C, M, B)="
              f"{tuple(args[0].shape) + (args[1].shape[2],)}, validity rows "
              f"first (1/8 of M live): kernel {ms:.4f} ms")
    # The selection at the order path's shape, from the packed join.
    p_out = kops.window_join_packed_bits(*p_args)
    o_ms = cuda_ms(lambda: kops.select_survivors(*p_out, B_CAP, M_CAP))
    o_bound, _ = select_bound(*p_out, B_CAP, M_CAP)
    print(f"   {SELECT} (K, M, B, out_cap)={(K_MAIN, M_CAP, B_CAP, M_CAP)} "
          f"(packed join output): kernel {o_ms:.4f} ms, bound "
          f"{o_bound:.4f} ms (bytes)")
    return records


def check_per_batch_thresholds(device, c_packed, c_rowcount, batch):
    """The packed join and the row count with a threshold row per batch
    element (rows that differ), bit for bit against their plain versions,
    at the rulebook's shapes (``batch`` = K x rule slots, M_CAP, B_CAP) and
    a ragged one; a shared (C,) vector (batch stride 0) must equal the
    same values given as (K, C).  Prints the kernels' times with per-batch
    and shared thresholds at the rulebook's shapes."""
    import torch

    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    for (k, cp, cr, m, b) in [(batch, c_packed, c_rowcount, M_CAP, B_CAP),
                              (5, 7, 5, 1000, 333)]:
        L, R, ops8, _, mv, bv = packed_inputs(gen, k, cp, m, b, device)
        step = 0.25 * torch.arange(k, device=device)[:, None]
        th = coarse(gen, (k, cp), device).abs() + step
        shared = th[0].contiguous()
        for t, what in ((th, "per batch"), (shared, "shared")):
            if mask_err(kops.window_join_packed_bits(L, R, ops8, t, mv, bv),
                        kops.window_join_packed_bits(
                            L, R, ops8, t, mv, bv, backend="ref")) != 0:
                raise AssertionError(f"packed kernel != plain, {what} "
                                     f"thresholds, at {(k, cp, m, b)}")
        if mask_err(kops.window_join_packed_bits(L, R, ops8, shared, mv, bv),
                    kops.window_join_packed_bits(
                        L, R, ops8, shared.expand(k, cp).contiguous(), mv,
                        bv)) != 0:
            raise AssertionError("packed: stride-0 thresholds != (K, C)")
        rL, rR, rops, _ = rowcount_inputs(gen, k, cr, m, b, device)
        rth = coarse(gen, (k, cr), device) + 0.25 * torch.arange(
            k, device=device)[:, None]
        rshared = rth[0].contiguous()
        for t, what in ((rth, "per batch"), (rshared, "shared")):
            if not torch.equal(kops.window_join_rowcount(rL, rR, rops, t),
                               kops.window_join_rowcount(rL, rR, rops, t,
                                                         backend="ref")):
                raise AssertionError(f"rowcount kernel != plain, {what} "
                                     f"thresholds, at {(k, cr, m, b)}")
        if not torch.equal(
                kops.window_join_rowcount(rL, rR, rops, rshared),
                kops.window_join_rowcount(
                    rL, rR, rops, rshared.expand(k, cr).contiguous())):
            raise AssertionError("rowcount: stride-0 thresholds != (K, C)")
        if k != batch:  # the unpacked join and the pair count take it too
            for fn in (kops.window_join_bits, kops.window_join_count):
                got = fn(rL, rR, rops, rth)
                want = fn(rL, rR, rops, rth, backend="ref")
                if not all(torch.equal(g, w) for g, w in zip(
                        *((got, want) if isinstance(got, tuple)
                          else ((got,), (want,))))):
                    raise AssertionError(f"{fn.__name__} kernel != plain, "
                                         f"per-batch thresholds")
        if k == batch:
            packed = kops.window_join_packed_bits
            rowcount = kops.window_join_rowcount
            times = {
                "packed, per batch": cuda_ms(
                    lambda: packed(L, R, ops8, th, mv, bv)),
                "packed, shared": cuda_ms(
                    lambda: packed(L, R, ops8, shared, mv, bv)),
                "rowcount, per batch": cuda_ms(
                    lambda: rowcount(rL, rR, rops, rth)),
                "rowcount, shared": cuda_ms(
                    lambda: rowcount(rL, rR, rops, rshared)),
            }
            print(f"   rulebook shapes (batch, C, M, B): packed "
                  f"{(k, cp, m, b)}, rowcount {(k, cr, m, b)}: " + ", ".join(
                      f"{n} {v:.4f} ms" for n, v in times.items()))
    print("   per-batch thresholds: packed join and row count (and, at the "
          "ragged shape, the unpacked join and the pair count) "
          "bit-identical to the plain versions; stride-0 shared "
          "thresholds equal (K, C)")


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def path_config(plan, **kw):
    """The session configuration of a path: the same capacities for both
    plan families; tree plans add their invariant caps and escalation
    limit."""
    from repro_torch.cep import RuntimeConfig

    if plan == "tree":
        kw = dict(TREE_CAPS, max_escalations=TREE_MAX_ESCALATIONS, **kw)
    return RuntimeConfig(**kw)


def run_main(device, backend=None, plan="order", superchunk=1,
             sessions=None):
    """The full-width path through ``cep.open(...).run``; returns the
    telemetry, the wall seconds and the peak device memory (bytes), and
    appends the session to ``sessions`` if given."""
    import torch

    from repro_torch import cep

    cfg = path_config(plan, buffer_capacity=B_CAP, match_capacity=M_CAP,
                      chunk_capacity=CHUNK_CAP, device=device,
                      backend=backend, superchunk=superchunk)
    sess = cep.open(flowsense_rule(), partitions=K_MAIN, plan=plan,
                    monitor=True, config=cfg)
    if sessions is not None:
        sessions.append(sess)
    data = streams(K_MAIN, CHUNKS_MAIN, BASE_RATE, CHUNK_CAP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tel = sess.run(data)
    torch.cuda.synchronize()
    return tel, time.perf_counter() - t, torch.cuda.max_memory_allocated()


def same_telemetry(tel, want, what):
    """Every integer telemetry field and the per-partition matches."""
    for f in INT_FIELDS:
        if getattr(tel, f) != getattr(want, f):
            raise AssertionError(f"{what}: {f} {getattr(tel, f)} != "
                                 f"{getattr(want, f)}")
    if tel.per_partition_matches.tolist() != \
            want.per_partition_matches.tolist():
        raise AssertionError(f"{what}: per-partition matches differ")


def check_path(plan):
    """Drives one path with the launch counters zeroed just before and
    read just after, then reruns it with the plain versions; returns the
    launch counts, the telemetry and the events/s."""
    from repro_torch.kernels import ops as kops

    kops.reset_launch_counts()
    tel, secs, peak = run_main("cuda", plan=plan)
    launches = dict(kops.LAUNCHES)
    for name in PATH_KERNELS[plan]:
        if launches[name] <= 0:
            raise AssertionError(f"{plan} path never launched {name}")
    print(f"   plan={plan} K={K_MAIN} FlowSense rule, base_rate="
          f"{BASE_RATE}, b_cap={B_CAP}, m_cap={M_CAP}: {tel.events} events "
          f"in {secs:.3f} s = {tel.events / secs:.1f} events/s, peak "
          f"device memory {peak / 2 ** 30:.3f} GiB")
    print("   " + ", ".join(f"{f}={getattr(tel, f)}" for f in INT_FIELDS))
    print(f"   kernel launches on the {plan} path: {launches}")
    kops.reset_launch_counts()
    ref_tel, ref_secs, ref_peak = run_main("cuda", backend="ref", plan=plan)
    if any(kops.LAUNCHES.values()):
        raise AssertionError("backend='ref' launched a kernel")
    same_telemetry(tel, ref_tel, f"{plan}: kernels vs plain")
    print(f"   plain-version rerun on the card: equal integer telemetry "
          f"({ref_secs:.3f} s = {ref_tel.events / ref_secs:.1f} events/s, "
          f"peak device memory {ref_peak / 2 ** 30:.3f} GiB)")
    return launches, tel, tel.events / secs


def window_launches(path, kernels):
    """A window path's launches per kernel: wrapper launches plus the
    launches replayed from captured graphs; fails if a kernel of the path
    shows no graph launch."""
    from repro_torch.kernels import ops as kops

    for name in kernels:
        if kops.GRAPH_LAUNCHES[name] <= 0:
            raise AssertionError(f"{path}: no graph replay launched {name}")
    print(f"   launches recorded at capture x replays: "
          f"{dict(kops.GRAPH_LAUNCHES)}; wrapper launches (warm-up, eager "
          f"escalation recounts): {dict(kops.LAUNCHES)}")
    return {k: kops.LAUNCHES[k] + kops.GRAPH_LAUNCHES[k]
            for k in kops.LAUNCHES}


def check_superchunk(plan, want, want_rate):
    """The K=16 session with superchunk=8 on the card against the
    per-chunk kernel run ``want``; returns the launch counts."""
    from repro_torch.core import scan
    from repro_torch.kernels import ops as kops

    kops.reset_launch_counts()
    scan.reset_counts()
    box = []
    tel, secs, peak = run_main("cuda", plan=plan, superchunk=SUPERCHUNK,
                               sessions=box)
    launches = window_launches(f"superchunk {plan}", PATH_KERNELS[plan])
    counts = dict(scan.COUNTS)
    same_telemetry(tel, want, f"superchunk {plan} vs per-chunk")
    if counts["replays"] <= 0 or counts["eager_steps"] != 0:
        raise AssertionError(f"superchunk {plan}: window counts {counts}")
    print(f"   plan={plan} superchunk={SUPERCHUNK}: equal integer telemetry "
          f"to the per-chunk run; {tel.events / secs:.1f} events/s "
          f"(per-chunk run: {want_rate:.1f}), peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; windows {counts['windows']}, graph "
          f"captures {counts['captures']}, replays {counts['replays']}, "
          f"in-window events {box[0]._runner.in_window_events}, "
          f"escalations "
          f"{tel.escalations}, replans {tel.replans}")
    # The plain versions through the same window, captured and replayed on
    # the card like the kernels (their survivor selection is capture-safe).
    kops.reset_launch_counts()
    scan.reset_counts()
    ref_tel, ref_secs, _ = run_main("cuda", plan=plan, backend="ref",
                                    superchunk=SUPERCHUNK)
    check_plain_window(f"superchunk {plan}")
    same_telemetry(ref_tel, tel, f"superchunk {plan}: plain window vs "
                   "kernel window")
    print(f"   plain-version window rerun (backend='ref', S={SUPERCHUNK}) on "
          f"the card: equal integer telemetry ({ref_secs:.3f} s, graph "
          f"replays {scan.COUNTS['replays']})")
    return launches


def check_plain_window(what):
    """A ``backend="ref"`` window run launched no kernel and ran as graph
    replays (no eager CUDA window exists)."""
    from repro_torch.core import scan
    from repro_torch.kernels import ops as kops

    if any(kops.LAUNCHES.values()) or any(kops.GRAPH_LAUNCHES.values()):
        raise AssertionError(f"{what}: backend='ref' launched a kernel")
    if scan.COUNTS["replays"] <= 0 or scan.COUNTS["eager_steps"] != 0:
        raise AssertionError(f"{what}: plain window counts "
                             f"{dict(scan.COUNTS)}")


def serving_chunks():
    """The 64 stacked chunks of the K=16 stream and their event count."""
    import numpy as np

    from repro_torch.core.fleet import stacked_streams

    chunks = list(stacked_streams(streams(K_MAIN, CHUNKS_MAIN, BASE_RATE,
                                          CHUNK_CAP)))
    return chunks, int(sum(np.asarray(fc.chunk.valid).sum()
                           for fc in chunks))


def check_serving():
    """A monitored K=16 order session driven by ``step``, a second one by
    ``step_superchunk`` (S=8) and a third by ``step_superchunk`` with the
    plain versions, over the same 64 chunks; returns the launch counts of
    the first two runs."""
    from repro_torch.core import scan
    from repro_torch.kernels import ops as kops

    chunks, n_events = serving_chunks()
    out, tels, secs = {}, {}, {}
    for superchunk in (1, SUPERCHUNK):
        kops.reset_launch_counts()
        scan.reset_counts()
        seg_secs, out[superchunk], tels[superchunk], front = bench_run(
            "serving", superchunk, chunks)
        secs[superchunk] = sum(seg_secs)
        if superchunk == 1:
            step_launches = dict(kops.LAUNCHES)
            for name in PATH_KERNELS["order"]:
                if step_launches[name] <= 0:
                    raise AssertionError(f"serving step never launched "
                                         f"{name}")
    launches = window_launches("serving", PATH_KERNELS["order"])
    counts = dict(scan.COUNTS)
    a, b = tels[1], tels[SUPERCHUNK]
    if out[1].tolist() != out[SUPERCHUNK].tolist():
        raise AssertionError("step_superchunk per-chunk matches != step's")
    for f in ("matches", "violations", "replans", "host_syncs", "overflow"):
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"serving {f}: step {getattr(a, f)} != "
                                 f"step_superchunk {getattr(b, f)}")
    if counts["replays"] <= 0 or counts["eager_steps"] != 0:
        raise AssertionError(f"serving window counts {counts}")
    kops.reset_launch_counts()
    scan.reset_counts()
    _, ref_out, ref_tel, _ = bench_run("serving", SUPERCHUNK, chunks,
                                       backend="ref")
    check_plain_window("serving")
    if ref_out.tolist() != out[SUPERCHUNK].tolist():
        raise AssertionError("plain step_superchunk per-chunk matches != "
                             "the kernel window's")
    for f in ("matches", "violations", "replans", "host_syncs", "overflow"):
        if getattr(ref_tel, f) != getattr(b, f):
            raise AssertionError(f"serving {f}: plain window "
                                 f"{getattr(ref_tel, f)} != kernel window "
                                 f"{getattr(b, f)}")
    print(f"   step: {n_events / secs[1]:.1f} events/s; step_superchunk "
          f"(S={SUPERCHUNK}): {n_events / secs[SUPERCHUNK]:.1f} events/s; "
          f"equal per-chunk matches (total {b.matches}), violations "
          f"{b.violations}, replans {b.replans}, host syncs "
          f"{b.host_syncs}; graph replays {counts['replays']}, in-window "
          f"events {front.in_window_events}; the plain-version window "
          f"(backend='ref') equal")
    return step_launches, launches


# ---------------------------------------------------------------------------
# The rulebook
# ---------------------------------------------------------------------------


RULE_FIELDS = ("pm_created", "overflow", "neg_rejected",
               "closure_expansions", "replans", "deployments", "violations",
               "chunks")


def rulebook_counters(rb):
    """Per rule: the (K,) matches and every counter of ``RULE_FIELDS``."""
    return [(e.matches.tolist(), tuple(getattr(e, f) for f in RULE_FIELDS))
            for e in rb._rules]


def run_rulebook(chunks, backend=None, superchunk=1, k=None, caps=None):
    """The FlowSense rulebook through ``open_rulebook(...).run`` over the
    stacked ``chunks`` (K = ``k``, default K_MAIN; ``caps`` = (buffer,
    match, chunk) capacities, default the main path's); returns the book,
    the wall seconds and the peak device memory (bytes)."""
    import torch

    from repro_torch.cep import RuntimeConfig, open_rulebook

    b_cap, m_cap, cap = caps or (B_CAP, M_CAP, CHUNK_CAP)
    rb = open_rulebook(flowsense_rulebook(), partitions=k or K_MAIN,
                       monitor=True,
                       config=RuntimeConfig(
                           buffer_capacity=b_cap, match_capacity=m_cap,
                           chunk_capacity=cap, device="cuda",
                           backend=backend, superchunk=superchunk),
                       spare_slots=RULEBOOK_SPARE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rb.run(chunks)
    torch.cuda.synchronize()
    return rb, time.perf_counter() - t, torch.cuda.max_memory_allocated()


def solo_matches(rule, chunks):
    """A monitored K=16 order session stepped over ``chunks`` (the
    rulebook's immediate-deployment semantics): (K,) matches and the
    session's telemetry."""
    import numpy as np

    from repro_torch import cep

    sess = cep.open(rule, partitions=K_MAIN, plan="order", monitor=True,
                    config=path_config("order", buffer_capacity=B_CAP,
                                       match_capacity=M_CAP,
                                       chunk_capacity=CHUNK_CAP,
                                       device="cuda"))
    total = np.zeros(K_MAIN, np.int64)
    for fc in chunks:
        total += sess.step(fc.chunk, fc.t0, fc.t1)
    return total, sess.telemetry()


def check_rulebook():
    """The FlowSense rulebook at full width: the per-chunk kernel run
    (launches counted), zero overflow, three solo sessions, the plain
    rerun, the superchunk window and a hot add; returns the launch counts
    of the per-chunk and window runs."""
    from repro_torch.core import scan
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import window_join

    chunks, n_events = serving_chunks()
    kops.reset_launch_counts()
    rb, secs, peak = run_rulebook(chunks)
    launches = dict(kops.LAUNCHES)
    for name in PATH_KERNELS["order"]:
        if launches[name] <= 0:
            raise AssertionError(f"rulebook never launched {name}")
    tel = rb.telemetry()
    if tel.overflow != 0:
        raise AssertionError(f"rulebook overflow {tel.overflow} at "
                             f"match_capacity={M_CAP}: the comparisons below "
                             "are exact only without truncation")
    print(f"   rulebook: {len(rb.rules)} rules in {rb.n_buckets} buckets, "
          f"K={K_MAIN}, b_cap={B_CAP}, m_cap={M_CAP}, spare slots "
          f"{RULEBOOK_SPARE}: {n_events} events in {secs:.3f} s = "
          f"{n_events / secs:.1f} events/s, peak device memory "
          f"{peak / 2 ** 30:.3f} GiB")
    for rid in rb.rules:
        t = rb.telemetry(rid)
        print(f"   rule {rid}: matches {t.matches}, neg_rejected "
              f"{t.neg_rejected}, overflow {t.overflow}, replans "
              f"{t.replans}, pm_created {rb._rules[rid].pm_created}")
    print(f"   host syncs {tel.host_syncs}; kernel launches: {launches}")
    want = rulebook_counters(rb)

    for rid, rule in enumerate(flowsense_rulebook()):
        total, stel = solo_matches(rule, chunks)
        if total.tolist() != rb.match_counts[rid].tolist() or \
                stel.neg_rejected != rb.telemetry(rid).neg_rejected or \
                stel.overflow != 0:
            raise AssertionError(f"rule {rid} != its solo session")
    print("   per-rule matches and negation vetoes equal three solo "
          "sessions (Session.step), zero overflow")

    kops.reset_launch_counts()
    ref_rb, ref_secs, ref_peak = run_rulebook(chunks, backend="ref")
    if any(kops.LAUNCHES.values()):
        raise AssertionError("rulebook backend='ref' launched a kernel")
    if rulebook_counters(ref_rb) != want:
        raise AssertionError("rulebook: plain-version counters differ")
    print(f"   plain-version rerun: equal per-rule counters ({ref_secs:.3f} "
          f"s, peak device memory {ref_peak / 2 ** 30:.3f} GiB)")

    kops.reset_launch_counts()
    scan.reset_counts()
    win, wsecs, wpeak = run_rulebook(chunks, superchunk=SUPERCHUNK)
    w_launches = window_launches("rulebook window", PATH_KERNELS["order"])
    counts = dict(scan.COUNTS)
    if rulebook_counters(win) != want:
        raise AssertionError("rulebook: superchunk counters differ")
    if counts["replays"] <= 0 or counts["eager_steps"] != 0:
        raise AssertionError(f"rulebook window counts {counts}")
    print(f"   superchunk={SUPERCHUNK}: equal per-rule counters; "
          f"{n_events / wsecs:.1f} events/s (per chunk {n_events / secs:.1f}"
          f"), peak device memory {wpeak / 2 ** 30:.3f} GiB; windows "
          f"{counts['windows']}, graph captures {counts['captures']} "
          f"(trace_count {win.trace_count()}), replays {counts['replays']}, "
          f"in-window events {win.in_window_events}, host syncs "
          f"{win.telemetry().host_syncs}")

    # Hot add into a spare slot mid-stream: row writes only.
    scan.reset_counts()
    hot, _, _ = run_rulebook(chunks[:HOT_ADD_AT], superchunk=SUPERCHUNK)
    lib, so = window_join._lib, window_join.library_path()
    built = sorted(os.listdir(window_join.BUILD_DIR))
    before = (hot.trace_count(), scan.COUNTS["captures"])
    rid = hot.add_rule(hot_added_rule())
    hot.run(chunks[HOT_ADD_AT:])
    after = (hot.trace_count(), scan.COUNTS["captures"])
    if after != before:
        raise AssertionError(f"hot add captured: {before} -> {after}")
    if window_join._lib is not lib or window_join.library_path() != so or \
            sorted(os.listdir(window_join.BUILD_DIR)) != built:
        raise AssertionError("hot add rebuilt or reloaded the kernels")
    total, _ = solo_matches(hot_added_rule(), chunks[HOT_ADD_AT:])
    if total.tolist() != hot.match_counts[rid].tolist():
        raise AssertionError("hot-added rule != its solo session")
    if hot.match_counts[:3].tolist() != rb.match_counts.tolist() or \
            hot.telemetry().overflow != 0:
        raise AssertionError("hot add disturbed the other rules")
    print(f"   hot add of rule {rid} after {HOT_ADD_AT} chunks (window "
          f"run): no kernel build, no graph capture (trace_count "
          f"{after[0]}, captures {after[1]}); equals its solo session "
          f"({int(total.sum())} matches); rules 0-2 undisturbed")
    return launches, w_launches


def check_rulebook_oracle():
    """A narrow K=4 rulebook on the card against the brute-force oracle,
    per rule and partition."""
    from repro_torch.cep import RefEngine
    from repro_torch.core.fleet import stacked_streams

    k, n_chunks, rate, cap = 4, 24, 12.0, 64
    rb, _, _ = run_rulebook(
        list(stacked_streams(streams(k, n_chunks, rate, cap, seed=100))),
        k=k, caps=(64, 1024, cap))
    for rid, rule in enumerate(flowsense_rulebook()):
        want = [RefEngine(rule.build()).run(s)
                for s in streams(k, n_chunks, rate, cap, seed=100)]
        if rb.match_counts[rid].tolist() != [r.full_matches for r in want]:
            raise AssertionError(f"rulebook oracle mismatch, rule {rid}: "
                                 f"{rb.match_counts[rid].tolist()} vs "
                                 f"{[r.full_matches for r in want]}")
        if rb.telemetry(rid).neg_rejected != sum(r.neg_rejected
                                                 for r in want):
            raise AssertionError(f"rulebook oracle neg_rejected, rule {rid}")
    print(f"   K={k} b_cap=64: per-rule matches {rb.match_counts.tolist()} "
          f"== oracle; replans {rb.telemetry().replans}")


def bench_run(path, superchunk, chunks, backend=None):
    """One bench run of a fresh K=16 session over the stacked ``chunks``:
    its first ``BENCH_SPLIT`` chunks (in which a window path captures its
    graphs) and the rest, timed apart.  ``path`` is a plan ("order",
    "tree": ``Session.run``) or "serving" (order plans through ``step``,
    or ``step_superchunk`` with S > 1).  Returns the two segments'
    seconds, the per-chunk matches (serving), the telemetry and the
    runner or serving front.  ``backend="ref"`` runs the plain versions."""
    import numpy as np
    import torch

    from repro_torch import cep

    plan = "order" if path == "serving" else path
    cfg = path_config(plan, buffer_capacity=B_CAP, match_capacity=M_CAP,
                      chunk_capacity=CHUNK_CAP, device="cuda",
                      superchunk=superchunk, backend=backend)
    sess = cep.open(flowsense_rule(), partitions=K_MAIN, plan=plan,
                    monitor=True, config=cfg)
    secs, got = [], []
    for seg in (chunks[:BENCH_SPLIT], chunks[BENCH_SPLIT:]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if path != "serving":
            sess.run(seg, resume=bool(secs))
        elif superchunk == 1:
            got.append(np.stack([sess.step(fc.chunk, fc.t0, fc.t1)
                                 for fc in seg]))
        else:
            got.append(sess.step_superchunk(
                [fc.chunk for fc in seg], [(fc.t0, fc.t1) for fc in seg]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    runner = sess._serving if path == "serving" else sess._runner
    return (secs, np.concatenate(got) if got else None, sess.telemetry(),
            runner)


def bench(n_runs):
    """Per path (order, tree, serving), ``n_runs`` per-chunk and ``n_runs``
    window runs (S=8) in turns, each held to equal telemetry; prints
    events/s per run over all 64 chunks (captures included) and over the
    56 after the first ``BENCH_SPLIT`` (graphs captured), with medians and
    ranges, peak memory, and the window runs' graph replays and in-window
    events."""
    import numpy as np
    import torch

    from repro_torch.core import scan

    turns = ([1, SUPERCHUNK, SUPERCHUNK, 1] * n_runs)[:2 * n_runs]
    chunks, n_events = serving_chunks()
    n_late = int(sum(np.asarray(fc.chunk.valid).sum()
                     for fc in chunks[BENCH_SPLIT:]))
    for path in ("order", "tree", "serving"):
        rates = {(s, w): [] for s in (1, SUPERCHUNK) for w in ("all", "late")}
        peaks = {1: 0, SUPERCHUNK: 0}
        want = None  # the first run's telemetry and per-chunk matches
        for superchunk in turns:
            scan.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            secs, got, tel, runner = bench_run(path, superchunk, chunks)
            want = want or (tel, got)
            same_telemetry(tel, want[0], f"bench {path} S={superchunk}")
            if got is not None and got.tolist() != want[1].tolist():
                raise AssertionError(f"bench {path} S={superchunk}: "
                                     "per-chunk matches differ")
            rates[superchunk, "all"].append(n_events / sum(secs))
            rates[superchunk, "late"].append(n_late / secs[1])
            peaks[superchunk] = max(peaks[superchunk],
                                    torch.cuda.max_memory_allocated())
            if superchunk > 1:
                cut, counts = runner.in_window_events, dict(scan.COUNTS)
        for (superchunk, which), r in rates.items():
            span = ("all 64 chunks" if which == "all" else
                    f"chunks {BENCH_SPLIT}-{CHUNKS_MAIN - 1}")
            print(f"   bench {path} superchunk={superchunk}, {span}: "
                  f"events/s {[round(x, 1) for x in r]}, median "
                  f"{statistics.median(r):.1f} (range {min(r):.1f}-"
                  f"{max(r):.1f})")
        print(f"   bench {path}: peak device memory per-chunk "
              f"{peaks[1] / 2 ** 30:.3f} GiB, window "
              f"{peaks[SUPERCHUNK] / 2 ** 30:.3f} GiB; the last window "
              f"run's windows {counts['windows']}, graph captures "
              f"{counts['captures']}, replays {counts['replays']}, "
              f"in-window events {cut}")


def profile_main(plan="order", n_chunks=16, top=12, superchunk=1, warm=0):
    """Where a path's time goes: ``n_chunks`` chunks under
    ``torch.profiler``, after ``warm`` chunks run unprofiled (in which a
    window path, ``superchunk`` > 1, captures its graphs); prints the
    device-busy share of the wall time, the ops with the most device self
    time and the join-family kernels the profiler names.  ``plan`` is
    "order", "tree" or "rulebook" (the FlowSense rulebook)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import cep
    from repro_torch.core.fleet import stacked_streams

    cfg = path_config("order" if plan == "rulebook" else plan,
                      buffer_capacity=B_CAP, match_capacity=M_CAP,
                      chunk_capacity=CHUNK_CAP, device="cuda",
                      superchunk=superchunk)
    if plan == "rulebook":
        book = cep.open_rulebook(flowsense_rulebook(), partitions=K_MAIN,
                                 monitor=True, config=cfg,
                                 spare_slots=RULEBOOK_SPARE)

        def run(seg, resume):  # a rulebook's stream state always persists
            book.run(seg)
    else:
        sess = cep.open(flowsense_rule(), partitions=K_MAIN, plan=plan,
                        monitor=True, config=cfg)

        def run(seg, resume):
            sess.run(seg, resume=resume)
    chunks = list(stacked_streams(streams(K_MAIN, warm + n_chunks,
                                          BASE_RATE, CHUNK_CAP)))
    if warm:
        run(chunks[:warm], False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t = time.perf_counter()
        run(chunks[warm:], bool(warm))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # Device-side rows only (kernels, copies): the op-level rows repeat
    # their kernels' device time.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    what = f"{plan} window" if superchunk > 1 else plan
    named = sorted(k for k in ("packed_kernel", "join_kernel",
                               "rowcount_kernel", "select_kernel")
                   if any(k in e.key for e in rows))
    print(f"   profiled {n_chunks} chunks of the {what} path: wall "
          f"{wall:.3f} s, device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f}% of wall); join-family "
          f"kernels named: {named or 'none'}")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:top]:
        print(f"   device {e.self_device_time_total / 1e3:10.2f} ms  "
              f"calls {e.count:6d}  {e.key[:70]}")
    copies = [e for e in rows if "direct_copy" in e.key]
    print(f"   direct_copy kernels: "
          f"{sum(e.self_device_time_total for e in copies) / 1e3:.2f} ms "
          f"over {sum(e.count for e in copies)} calls")
    # The compaction reads the join's bit words: nothing scans M*B cells
    # (the old running count took PyTorch's device-wide scan).
    scans = [e.key for e in rows if "DeviceScan" in e.key]
    if scans:
        raise AssertionError(f"device-wide scans on the {what} path: "
                             f"{scans}")


def check_oracle(device, plan="order"):
    """K=4 narrow stream on the card vs the brute-force oracle."""
    from repro_torch import cep
    from repro_torch.cep import RefEngine

    k, n_chunks, rate, cap = 4, 24, 12.0, 64
    cfg = path_config(plan, buffer_capacity=64, match_capacity=1024,
                      chunk_capacity=cap, device=device)
    pattern = flowsense_rule()
    tel = cep.open(pattern, partitions=k, plan=plan, monitor=True,
                   config=cfg).run(streams(k, n_chunks, rate, cap, seed=100))
    want = [RefEngine(pattern.build()).run(s)
            for s in streams(k, n_chunks, rate, cap, seed=100)]
    got = tel.per_partition_matches.tolist()
    if got != [r.full_matches for r in want]:
        raise AssertionError(f"oracle mismatch: {got} vs "
                             f"{[r.full_matches for r in want]}")
    if tel.neg_rejected != sum(r.neg_rejected for r in want):
        raise AssertionError("oracle neg_rejected mismatch")
    print(f"   plan={plan} K={k} b_cap=64: matches {got} == oracle, "
          "neg_rejected "
          f"{tel.neg_rejected} == oracle, replans {tel.replans}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.engine import make_spec, packed_row_count
    from repro_torch.core.multipattern import packed_rule_row_count
    from repro_torch.kernels import window_join

    t_all = time.perf_counter()
    t = phase("device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"   torch device: {kind} (count {count}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    done("device", t)

    t = phase("build")
    window_join.build()
    window_join.load_library()
    print(f"   nvcc build seconds: {window_join.BUILD_INFO['seconds']:.2f}")
    for line in str(window_join.BUILD_INFO["log"]).splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"   ptxas: {line.strip()}")
    done("build", t)

    if "--bench" in sys.argv:
        t = phase("bench")
        bench(int(sys.argv[sys.argv.index("--bench") + 1]))
        done("bench", t)
        return 0

    t = phase("kernels")
    pattern = flowsense_rule().build()
    c_packed = packed_row_count(make_spec(pattern))
    # Negation veto rows: 2 validity + 2 window + 2 order anchors.
    c_rowcount = 6
    # Tree join rows: 2 validity + 2 window + 1 order + 2 per predicate.
    c_join = 2 + 2 + 1 + 2 * len(make_spec(pattern).pred_pairs)
    records = check_kernels("cuda", c_packed, c_rowcount, c_join)
    # The rulebook's n=3 bucket: packed rows for every ordered pair, the
    # veto's six rows, K x (one rule + one spare slot) batch elements.
    check_per_batch_thresholds("cuda", packed_rule_row_count(3), 6,
                               K_MAIN * (1 + RULEBOOK_SPARE))
    done("kernels", t)

    launches, per_chunk = {}, {}
    for plan in ("order", "tree"):
        t = phase(f"main path, plan={plan}")
        launches[plan], *per_chunk[plan] = check_path(plan)
        done(f"main path, plan={plan}", t)

        t = phase(f"oracle, plan={plan}")
        check_oracle("cuda", plan)
        done(f"oracle, plan={plan}", t)

        t = phase(f"profile, plan={plan}")
        profile_main(plan)
        done(f"profile, plan={plan}", t)

    for plan in ("order", "tree"):
        t = phase(f"superchunk, plan={plan}")
        launches[f"superchunk-{plan}"] = check_superchunk(
            plan, *per_chunk[plan])
        done(f"superchunk, plan={plan}", t)

    t = phase("window profile, plan=order")
    profile_main("order", superchunk=SUPERCHUNK, warm=8)
    done("window profile, plan=order", t)

    t = phase("serving")
    launches["serving-step"], launches["serving-superchunk"] = \
        check_serving()
    done("serving", t)

    t = phase("rulebook")
    launches["rulebook"], launches["rulebook window"] = check_rulebook()
    done("rulebook", t)

    t = phase("rulebook oracle")
    check_rulebook_oracle()
    done("rulebook oracle", t)

    t = phase("rulebook profile")
    profile_main("rulebook", top=8)
    done("rulebook profile", t)

    print(f"   total seconds: {time.perf_counter() - t_all:.3f}")
    print(json.dumps({"selection_kernel": dict(
        name=SELECT, route="cuda", source=SOURCE, replaces=SELECT_REPLACES,
        launches=sum(n[SELECT] for n in launches.values()),
        launches_by_path={p: n[SELECT] for p, n in launches.items()},
        library_ms=None, **records[SELECT])}))
    # ``launches`` sums a kernel's launches over the paths' runs; the
    # split is in ``launches_by_path``.
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name],
                    launches=sum(n[name] for n in launches.values()),
                    launches_by_path={p: n[name]
                                      for p, n in launches.items()},
                    library_ms=None, **records[name])
               for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
