"""Join kernel benchmark of the PyTorch/CUDA port: packed vs baseline,
fused row count, the scanned step, device-timed.

The twin of ``benchmarks/kernel_bench.py``.  Sections (all feed
``BENCH_torch_kernel.json``, schema ``kernel_bench/v1`` plus the
``device`` block):

* **packed vs baseline** — the unpacked join on the engine-realistic
  stack (C + 2 f32 validity rows; ``join_kernel``) against the packed
  join (int8 op strip, validity vectors; ``packed_kernel``) on the
  reference's shapes (one partition, K = 1).  Parity first: both give the
  same mask.  Gate: packed no slower than baseline (x1.15 tolerance),
  and in ``--full`` mode >= 1.5x on (16, 4096, 256).
* **fused row count** — per-m counts (``rowcount_kernel``) vs
  materialise-then-sum (the unpacked join's mask summed over B).
* **fleet shapes** — ``packed_kernel``, ``rowcount_kernel``,
  ``join_kernel``, ``count_kernel`` and ``select_kernel`` at the K = 16
  FlowSense session's shapes, each against its plain version on the
  same inputs.
* **scanned step** — the superchunk window (``FleetEngine.
  superchunk_scan``: CUDA-graph replays on the card) over an S sweep
  (4, 8, 16), and the kernel fraction: the join steps' device time
  (``packed_kernel`` + ``select_kernel`` at the engine shape, n - 1 per
  chunk) over the chunk's time.

Kernel times are taken **on the device**: CUDA events around one replay
of a CUDA graph holding ``--iters`` back-to-back launches (``graph_ms``),
so the host cannot pace a kernel shorter than its wrapper; the eager
time (CUDA events around ``--iters`` wrapper calls, ``eager_ms``) is
reported beside it.  On the CPU the plain versions run and are timed on
the host clock (records ``"perf": false``).

The reference's ``--sweep`` (a block-size autotune of the Pallas body)
is not carried over: the CUDA strip body's geometry is fixed, so the port
has no tunable (the JSON says so under ``"sweep"``), and nothing is
written to ``benchmarks/autotune_cache.json``.

    PYTHONPATH=src python -m benchmarks.torch_kernel_bench [--quick|--full]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.kernels import ops as kops

from .torch_common import check_device, device_block, sync, write_json
from .torch_roofline import join_roofline

SHAPES = [(8, 256, 128), (12, 1024, 256), (16, 4096, 256)]
# The K=16 FlowSense order and tree sessions' shapes (PERF.md §4):
# kernel -> (K, C, M, B); the selection's is (K, M, B, out_cap).
FLEET_SHAPES = {"packed": (16, 8, 8192, 1024),
                "rowcount": (16, 6, 8192, 1024),
                "join": (16, 9, 8192, 8192),
                "count": (16, 9, 8192, 8192),
                "select": (16, 8192, 8192, 8192)}
KERNEL_OF = {"packed": "packed_kernel", "rowcount": "rowcount_kernel",
             "join": "join_kernel", "count": "count_kernel",
             "select": "select_kernel"}

# Packed may not regress vs baseline (the reference's tolerance).
GATE_TOLERANCE = 1.15
# Full-mode gate on the flagship shape.
FULL_SPEEDUP_GATE = 1.5
FULL_GATE_SHAPE = (16, 4096, 256)
SWEEP = "no tunable: strip geometry fixed"


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median device ms per launch: CUDA events around one replay of a
    CUDA graph that holds ``iters`` back-to-back calls of ``fn``."""
    from repro_torch.kernels import window_join as wj

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with wj.capturing():   # a capture launches nothing: counts unchanged
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def eager_ms(fn, iters: int = 20, reps: int = 5, device="cuda") -> float:
    """Median ms per call of ``iters`` back-to-back calls: CUDA events on
    the card (the host paces a kernel shorter than its wrapper), the host
    clock on the CPU."""
    fn()
    sync(device)
    times = []
    for _ in range(reps):
        if _cuda(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times)


def timed(fn, iters, device) -> dict:
    """{"graph_ms", "eager_ms"}; no graph on the CPU."""
    out = {"eager_ms": eager_ms(fn, iters, device=device)}
    out["graph_ms"] = graph_ms(fn, iters) if _cuda(device) else None
    return out


def _ms(t) -> float:
    """The time a gate and a record read: device (graph) time on the
    card, host time on the CPU."""
    return t["graph_ms"] if t["graph_ms"] is not None else t["eager_ms"]


def _case(rng, C, M, B, K=1):
    """One engine-realistic join instance with a leading fleet axis K:
    values, ops, thetas, validity (the reference's draws for K = 1)."""
    L = rng.normal(size=(K, C, M)).astype(np.float32)
    R = rng.normal(size=(K, C, B)).astype(np.float32)
    op = rng.integers(1, 4, size=(K, C)).astype(np.int32)
    th = rng.normal(scale=0.5, size=(C,)).astype(np.float32)
    mv = (rng.random((K, M)) > 0.2).astype(np.int8)
    bv = (rng.random((K, B)) > 0.2).astype(np.int8)
    return L, R, op, th, mv, bv


def _baseline_operands(L, R, op, th, mv, bv):
    """The pre-packing stack: validity enters as two f32 constraint
    rows."""
    K, C, M = L.shape
    B = R.shape[2]
    Lv = np.concatenate(
        [L, mv[:, None, :].astype(np.float32), np.ones((K, 1, M),
                                                       np.float32)], 1)
    Rv = np.concatenate(
        [R, np.ones((K, 1, B), np.float32),
         bv[:, None, :].astype(np.float32)], 1)
    opv = np.concatenate([op, np.tile([[2, 1]], (K, 1))], 1).astype(
        np.int32)
    thv = np.concatenate([th, [0.5, 0.5]]).astype(np.float32)
    return Lv, Rv, opv, thv


def _on(device, *arrays):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _row(shape, config, ms, cells, perf, **extra):
    seconds = ms / 1e3
    rec = {"shape": "C{}_M{}_B{}".format(*shape[-3:]) if len(shape) == 3
           else "K{}_C{}_M{}_B{}".format(*shape),
           "config": config, "seconds": round(seconds, 9), "cells": cells,
           "cells_per_s": round(cells / max(seconds, 1e-12), 1)}
    if not perf:
        rec["perf"] = False
    rec.update(extra)
    return rec


def bench_shapes(shapes, iters, device):
    """Packed-vs-baseline + fused row count per shape (K = 1); returns
    (rows, gates, packed seconds per shape)."""
    rng = np.random.default_rng(0)
    perf = _cuda(device)
    rows, gates, packed_s = [], [], {}
    print("shape,config,us_per_call,cells_per_s,speedup")
    for shape in shapes:
        C, M, B = shape
        cells = M * B
        L, R, op, th, mv, bv = _case(rng, C, M, B)
        Lv, Rv, opv, thv = _on(device,
                               *_baseline_operands(L, R, op, th, mv, bv))
        Ld, Rd, opd, thd, mvd, bvd = _on(device, L, R, op, th, mv, bv)
        op8 = opd.to(torch.int8)
        # Parity first — a fast wrong kernel is not a result.
        if not torch.equal(kops.window_join(Lv, Rv, opv, thv),
                           kops.window_join_packed(Ld, Rd, op8, thd, mvd,
                                                   bvd)):
            raise AssertionError(f"packed != baseline mask at {shape}")
        t_base = timed(lambda: kops.window_join_bits(Lv, Rv, opv, thv),
                       iters, device)
        t_pack = timed(lambda: kops.window_join_packed_bits(
            Ld, Rd, op8, thd, mvd, bvd), iters, device)
        speedup = _ms(t_base) / max(_ms(t_pack), 1e-12)
        rows.append(_row(shape, "baseline_unpacked", _ms(t_base), cells,
                         perf, **t_base))
        rows.append(_row(shape, "packed", _ms(t_pack), cells, perf,
                         speedup_vs_baseline=round(speedup, 3), **t_pack))
        packed_s[shape] = _ms(t_pack) / 1e3
        print(f"C{C}_M{M}_B{B},baseline_unpacked,{_ms(t_base) * 1e3:.1f},"
              f"{cells / (_ms(t_base) / 1e3):.3g},1.00")
        print(f"C{C}_M{M}_B{B},packed,{_ms(t_pack) * 1e3:.1f},"
              f"{cells / (_ms(t_pack) / 1e3):.3g},{speedup:.2f}", flush=True)
        gates.append((shape, _ms(t_base), _ms(t_pack), speedup))

        # Fused per-m row count vs materialize + reduce.
        def cnt_base():
            return kops.window_join(Ld, Rd, opd, thd).sum(
                dim=-1, dtype=torch.int32)

        def cnt_fuse():
            return kops.window_join_rowcount(Ld, Rd, opd, thd)

        if not torch.equal(cnt_base(), cnt_fuse()):
            raise AssertionError(f"fused row count != materialized at "
                                 f"{shape}")
        t_cb = timed(cnt_base, iters, device)
        t_cf = timed(cnt_fuse, iters, device)
        sp = _ms(t_cb) / max(_ms(t_cf), 1e-12)
        rows.append(_row(shape, "rowcount_materialized", _ms(t_cb), cells,
                         perf, **t_cb))
        rows.append(_row(shape, "rowcount_fused", _ms(t_cf), cells, perf,
                         speedup_vs_baseline=round(sp, 3), **t_cf))
        print(f"C{C}_M{M}_B{B},rowcount_fused,{_ms(t_cf) * 1e3:.1f},"
              f"{cells / (_ms(t_cf) / 1e3):.3g},{sp:.2f}", flush=True)
    return rows, gates, packed_s


def check_gates(gates, full):
    """The throughput gates as records: packed no slower than baseline
    (x1.15) per shape, and >= 1.5x on the flagship shape in full mode."""
    out = {}
    for shape, t_base, t_pack, speedup in gates:
        name = "C{}_M{}_B{}".format(*shape)
        out[f"packed_ge_baseline_{name}"] = {
            "value": round(t_pack / max(t_base, 1e-12), 4),
            "threshold": GATE_TOLERANCE, "bound": "max",
            "met": t_pack <= t_base * GATE_TOLERANCE}
        if full and shape == FULL_GATE_SHAPE:
            out[f"packed_speedup_{name}"] = {
                "value": round(speedup, 4), "threshold": FULL_SPEEDUP_GATE,
                "bound": "min", "met": speedup >= FULL_SPEEDUP_GATE}
    return out


def bench_fleet_shapes(shapes, iters, device):
    """Each kernel at its fleet shape against its plain version on the
    same inputs: rows with graph and eager ms (kernel), the plain
    version's ms, and equality."""
    rng = np.random.default_rng(1)
    rows = []
    print("kernel,shape,graph_ms,eager_ms,plain_ms,equal")
    for name, shape in shapes.items():
        if name == "select":
            k, m, b, out_cap = shape
            # A sparse mask with about out_cap survivors per partition,
            # spread over every row (the selection's worst case).
            gen = torch.Generator(device=device).manual_seed(1)
            mask = torch.rand((k, m, b), generator=gen,
                              device=device) < out_cap / (m * b)
            from repro_torch.kernels import ref
            bits = ref.pack_bits(mask)
            counts = mask.sum(dim=-1, dtype=torch.int32)
            del mask
            args = (bits, counts, b, out_cap)
            fn = kops.select_survivors
            cells = m * b
        else:
            k, c, m, b = shape
            L, R, op, th, mv, bv = _on(device, *_case(rng, c, m, b, k))
            cells = m * b
            if name == "packed":
                args = (L, R, op.to(torch.int8), th, mv, bv)
                fn = kops.window_join_packed_bits
            else:
                args = (L, R, op, th)
                fn = {"rowcount": kops.window_join_rowcount,
                      "join": kops.window_join_bits,
                      "count": kops.window_join_count}[name]
        got = fn(*args)
        want = fn(*args, backend="ref")
        same = (all(torch.equal(g, w) for g, w in zip(got, want))
                if isinstance(got, tuple) else torch.equal(got, want))
        if not same:
            raise AssertionError(f"{KERNEL_OF[name]} != plain at {shape}")
        t = timed(lambda: fn(*args), iters, device)
        t_ref = eager_ms(lambda: fn(*args, backend="ref"),
                         max(1, iters // 10), reps=3, device=device)
        rows.append(_row(shape, KERNEL_OF[name], _ms(t), cells,
                         _cuda(device), plain_ms=t_ref, equal=True, **t))
        print(f"{KERNEL_OF[name]},{shape},{t['graph_ms']},"
              f"{t['eager_ms']:.4f},{t_ref:.4f},{same}", flush=True)
        del got, want, args
    return rows


def bench_scanned(s_values=(4, 8, 16), k=4, n_windows=3, device="cuda",
                  iters=20):
    """The superchunk window over an S sweep, and the kernel fraction: the
    K-batched join step (packed kernel + selection at the engine shape)
    times n - 1 steps per chunk over the best chunk time."""
    from repro_torch.core.engine import Chunk, EngineConfig, packed_row_count
    from repro_torch.core.fleet import FleetEngine
    from repro_torch.core.patterns import chain_predicates, seq_pattern
    from repro_torch.core.scan import stack_window, static_control

    pat = seq_pattern([0, 1, 2], 10.0,
                      chain_predicates([0, 1, 2], theta=0.4))
    cap, b_cap, m_cap = 48, 128, 256
    rng = np.random.default_rng(7)
    fleet = FleetEngine("order", pat, k,
                        EngineConfig(b_cap=b_cap, m_cap=m_cap,
                                     device=device))
    rows_arr = np.tile(np.arange(3, dtype=np.int32), (k, 1))

    def window(s, t_base):
        chunks, t0s, t1s = [], [], []
        for i in range(s):
            t0, t1 = t_base + 2.0 * i, t_base + 2.0 * (i + 1)
            tid = rng.integers(0, 3, (k, cap)).astype(np.int32)
            ts = np.sort(rng.uniform(t0, t1, (k, cap)),
                         axis=1).astype(np.float32)
            attr = rng.normal(size=(k, cap, 1)).astype(np.float32)
            chunks.append(Chunk(tid, ts, attr, np.ones((k, cap), bool)))
            t0s.append(t0)
            t1s.append(t1)
        return stack_window(chunks, t0s, t1s, static_control(k, s), s)

    scan = fleet.superchunk_scan(monitored=False)

    def time_scan(s):
        xs = [window(s, 100.0 * w) for w in range(n_windows)]
        state = fleet.init_state()
        scan(state, None, rows_arr, rows_arr, None, xs[0])  # warm/capture
        sync(device)
        t0 = time.perf_counter()
        for x in xs:
            state, _, _ = scan(state, None, rows_arr, rows_arr, None, x)
        sync(device)
        return (time.perf_counter() - t0) / n_windows

    out_rows = []
    best = None
    print("scan_s,chunks,seconds,chunks_per_s")
    for s in s_values:
        sec = time_scan(s)
        per_chunk = sec / s
        out_rows.append({"shape": f"scan_k{k}_S{s}", "config": "scanned",
                         "seconds": round(sec, 6), "cells": s * k,
                         "cells_per_s": round(s * k / max(sec, 1e-12), 1)})
        print(f"{s},{s * k},{sec:.4f},{s * k / max(sec, 1e-12):.1f}",
              flush=True)
        if best is None or per_chunk < best[1]:
            best = (s, per_chunk)
    s_best, per_chunk_best = best

    # The join step's floor at the engine shape, K-batched.
    spec = fleet.base.spec
    C = packed_row_count(spec)
    rk = np.random.default_rng(1)
    Lk, Rk = _on(device, rk.normal(size=(k, C, m_cap)).astype(np.float32),
                 rk.normal(size=(k, C, b_cap)).astype(np.float32))
    opk = torch.as_tensor(rk.integers(1, 4, size=(k, C)), dtype=torch.int8,
                          device=device)
    thk = torch.full((C,), 0.4, dtype=torch.float32, device=device)
    mvk = torch.ones((k, m_cap), dtype=torch.int8, device=device)
    bvk = torch.ones((k, b_cap), dtype=torch.int8, device=device)

    def join_step():
        bits, counts = kops.window_join_packed_bits(Lk, Rk, opk, thk, mvk,
                                                    bvk)
        return kops.select_survivors(bits, counts, b_cap, m_cap)

    t_join = timed(join_step, iters, device)
    joins_per_chunk = spec.n - 1
    join_fraction = (joins_per_chunk * _ms(t_join) / 1e3) / max(
        per_chunk_best, 1e-12)
    print(f"join_fraction at S={s_best}: {join_fraction:.3f} "
          f"({joins_per_chunk} K-batched join steps x "
          f"{_ms(t_join) * 1e3:.1f}us / {per_chunk_best * 1e6:.0f}us chunk)",
          flush=True)
    summary = {"best_s": s_best,
               "per_chunk_s": round(per_chunk_best, 6),
               "join_step_s": round(_ms(t_join) / 1e3, 9),
               "join_step_eager_s": round(t_join["eager_ms"] / 1e3, 9),
               "joins_per_chunk": joins_per_chunk,
               "join_fraction": round(join_fraction, 4),
               "strips_inbody": "not carried: the port's window has no "
                                "in-body strip variant"}
    return out_rows, summary


def main(argv=None, quick: bool = False) -> int:
    ap = argparse.ArgumentParser(
        epilog="No --sweep: " + SWEEP + " (the reference's block-size "
               "autotune has no counterpart in the port).")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--json", default="BENCH_torch_kernel.json",
                    help="machine-readable output path ('' disables)")
    ap.add_argument("--iters", type=int, default=None,
                    help="launches per timed graph / eager run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default=None,
                    help="';'-separated C,M,B shapes of the packed-vs-"
                         "baseline section (default: per mode)")
    ap.add_argument("--fleet-scale", type=int, default=1,
                    help="divide the fleet shapes' M and B by this")
    ap.add_argument("--windows", type=int, default=None,
                    help="windows per S of the scanned section")
    ap.add_argument("--no-gate", action="store_true",
                    help="record the throughput gates but never fail on "
                         "them")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    quick = (quick or args.quick) and not args.full
    full = not quick
    shapes = ([tuple(int(x) for x in s.split(","))
               for s in args.shapes.split(";")] if args.shapes else
              SHAPES if full else SHAPES[:2])
    iters = args.iters or (20 if quick else 30)
    f = args.fleet_scale
    fleet_shapes = {n: ((s[0], s[1], s[2] // f, s[3] // f) if n != "select"
                        else (s[0], s[1] // f, s[2] // f, s[3] // f))
                    for n, s in FLEET_SHAPES.items()}

    rows, gates, packed_s = bench_shapes(shapes, iters, device)
    rows.extend(bench_fleet_shapes(fleet_shapes, iters, device))
    scan_rows, scan_summary = bench_scanned(
        s_values=(4, 8) if quick else (4, 8, 16),
        n_windows=args.windows or (2 if quick else 3), device=device,
        iters=iters)
    rows.extend(scan_rows)

    roofline = [join_roofline(C, M, B, sec=packed_s[(C, M, B)])
                for (C, M, B) in shapes]
    for rec in roofline:
        print(f"roofline {rec['shape']}: {rec['achieved_gbytes_s']:.2f} "
              f"GB/s achieved vs {rec['peak_gbytes_s']:.0f} peak "
              f"({rec['fraction_of_roof']:.4f} of roof, "
              f"{rec['dominant']}-bound)", flush=True)

    gate_recs = check_gates(gates, full)
    for name, g in gate_recs.items():
        print(f"gate {name}: {g['value']:.4f} ({g['bound']} "
              f"{g['threshold']}) {'met' if g['met'] else 'NOT MET'}")
    if args.json:
        write_json(args.json, {
            "schema": "kernel_bench/v1",
            "quick": quick,
            "backend": kops.get_backend(torch.empty(0, device=device)),
            "platform": "h100" if _cuda(device) else "cpu",
            "device": device_block(device),
            "timing": ("graph_ms: CUDA events around one CUDA-graph replay "
                       "of iters launches; eager_ms: CUDA events around "
                       "iters wrapper calls" if _cuda(device) else
                       "host clock over the plain versions"),
            "iters": iters,
            "rows": rows,
            "scanned": scan_summary,
            "roofline": roofline,
            "sweep": SWEEP,
            "gates": gate_recs,
        })
        print(f"wrote {args.json}")
    missed = [name for name, g in gate_recs.items() if not g["met"]]
    if missed and not args.no_gate:
        raise AssertionError(f"throughput gates not met: {missed}")
    return 0


if __name__ == "__main__":
    main()
