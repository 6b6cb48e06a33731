#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the CEP runtime on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

1. device   — torch's device name, and nvidia-smi's name and power limit;
2. build    — nvcc builds the CUDA kernels from ``src/repro_torch``;
3. kernels  — each kernel against its plain PyTorch version on the card,
              bit for bit, at the main path's shapes, at ragged shapes and
              over every op code with ties; median times (CUDA events);
4. main     — ``repro_torch.cep.open(...).run(...)`` on the K=16 FlowSense
              alert rule at full width, with the launch counters zeroed
              just before and read just after; then the same stream again
              with ``backend="ref"`` (plain versions, on the card), which
              must give equal integer telemetry;
5. oracle   — a narrow K=4 stream on the card against the brute-force
              ``RefEngine``;
6. profile  — the first chunks of the main path under ``torch.profiler``:
              device-busy share and the ops with the most device time.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits with code 1 and prints no result.
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

SOURCE = "src/repro_torch/kernels/csrc/window_join.cu"
REPLACES = {
    "window_join_packed": "src/repro/kernels/window_join.py:295",
    "window_join_rowcount": "src/repro/kernels/window_join.py:383",
}
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


def packed_bound(L, R, ops8, th, mv, bv):
    """Least time for the packed join on these inputs: each input read
    once and the byte mask written once, against 3 f32 operations (shift,
    compare, AND) per active constraint row of each valid cell."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel()) + ops8.numel() \
        + mv.numel() + bv.numel() + k * m * b
    cells = (mv.sum(1).double() * bv.sum(1).double())
    active = (ops8 != 0).sum(1).double()
    ops = float((cells * (3 * active + 1)).sum())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def rowcount_bound(L, R, ops, th):
    """Least time for the row count: inputs read once, counts written
    once, against 3 f32 operations per active row of every (m, b) cell
    plus one add per cell."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel() + ops.numel() + k * m)
    active = ((ops >= 1) & (ops <= 3)).sum(1).double()
    ops_n = float((m * b * (3 * active + 1)).sum())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_n / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_kernels(device, c_packed, c_rowcount):
    """Both kernels vs their plain versions at the main path's shapes and
    at ragged / extreme shapes; returns the timing records."""
    import torch

    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    shapes = [(K_MAIN, c_packed, M_CAP, B_CAP), (3, 5, 1000, 333),
              (2, 32, 257, 129), (1, 1, 1, 1), (4, 64, 37, 1030)]
    for (k, c, m, b) in shapes:
        args = packed_inputs(gen, k, c, m, b, device)
        got = kops.window_join_packed(*args)
        want = kops.window_join_packed(*args, backend="ref")
        if not torch.equal(got, want):
            raise AssertionError(f"packed kernel != plain at {(k, c, m, b)}")
        none = (args[0], args[1], torch.zeros_like(args[2]), *args[3:])
        if not torch.equal(kops.window_join_packed(*none),
                           kops.window_join_packed(*none, backend="ref")):
            raise AssertionError(f"packed all-none ops at {(k, c, m, b)}")
    for (k, c, m, b) in [(K_MAIN, c_rowcount, M_CAP, B_CAP)] + shapes[1:]:
        args = rowcount_inputs(gen, k, c, m, b, device)
        got = kops.window_join_rowcount(*args)
        want = kops.window_join_rowcount(*args, backend="ref")
        if not torch.equal(got, want):
            raise AssertionError(
                f"rowcount kernel != plain at {(k, c, m, b)}")
    print(f"   bit-identical to the plain versions at {len(shapes)} packed "
          f"and {len(shapes)} rowcount shapes (all op codes, ties, "
          "all-none stacks)")

    records = {}
    p_args = packed_inputs(gen, K_MAIN, c_packed, M_CAP, B_CAP, device)
    r_args = rowcount_inputs(gen, K_MAIN, c_rowcount, M_CAP, B_CAP, device)
    for name, fn, args, bound in (
            ("window_join_packed", kops.window_join_packed, p_args,
             packed_bound),
            ("window_join_rowcount", kops.window_join_rowcount, r_args,
             rowcount_bound)):
        got = fn(*args)
        want = fn(*args, backend="ref")
        err = float((got.to(torch.int64) - want.to(torch.int64))
                    .abs().max())
        ms = cuda_ms(lambda: fn(*args))
        plain_ms = cuda_ms(lambda: fn(*args, backend="ref"), reps=5,
                           inner=2)
        bound_ms, bound_by = bound(*args)
        shape = tuple(args[0].shape) + (args[1].shape[2],)
        print(f"   {name} (K, C, M, B)={shape}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max_abs_err {err}")
        records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    return records


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def run_main(device, backend=None):
    import torch

    from repro_torch import cep
    from repro_torch.cep import RuntimeConfig

    cfg = RuntimeConfig(buffer_capacity=B_CAP, match_capacity=M_CAP,
                        chunk_capacity=CHUNK_CAP, device=device,
                        backend=backend)
    sess = cep.open(flowsense_rule(), partitions=K_MAIN, plan="order",
                    monitor=True, config=cfg)
    data = streams(K_MAIN, CHUNKS_MAIN, BASE_RATE, CHUNK_CAP)
    torch.cuda.synchronize()
    t = time.perf_counter()
    tel = sess.run(data)
    torch.cuda.synchronize()
    return tel, time.perf_counter() - t


def profile_main(n_chunks=16, top=12):
    """Where the main path's time goes: the first ``n_chunks`` chunks
    under ``torch.profiler``; prints the device-busy share of the wall
    time and the ops with the most device self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import cep
    from repro_torch.cep import RuntimeConfig

    cfg = RuntimeConfig(buffer_capacity=B_CAP, match_capacity=M_CAP,
                        chunk_capacity=CHUNK_CAP, device="cuda")
    sess = cep.open(flowsense_rule(), partitions=K_MAIN, plan="order",
                    monitor=True, config=cfg)
    data = streams(K_MAIN, n_chunks, BASE_RATE, CHUNK_CAP)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t = time.perf_counter()
        sess.run(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # Device-side rows only (kernels, copies): the op-level rows repeat
    # their kernels' device time.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    print(f"   profiled {n_chunks} chunks: wall {wall:.3f} s, device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f}% of wall)")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:top]:
        print(f"   device {e.self_device_time_total / 1e3:10.2f} ms  "
              f"calls {e.count:6d}  {e.key[:70]}")


def check_oracle(device):
    """K=4 narrow stream on the card vs the brute-force oracle."""
    from repro_torch import cep
    from repro_torch.cep import RefEngine, RuntimeConfig

    k, n_chunks, rate, cap = 4, 24, 12.0, 64
    cfg = RuntimeConfig(buffer_capacity=64, match_capacity=1024,
                        chunk_capacity=cap, device=device)
    pattern = flowsense_rule()
    tel = cep.open(pattern, partitions=k, plan="order", monitor=True,
                   config=cfg).run(streams(k, n_chunks, rate, cap, seed=100))
    want = [RefEngine(pattern.build()).run(s)
            for s in streams(k, n_chunks, rate, cap, seed=100)]
    got = tel.per_partition_matches.tolist()
    if got != [r.full_matches for r in want]:
        raise AssertionError(f"oracle mismatch: {got} vs "
                             f"{[r.full_matches for r in want]}")
    if tel.neg_rejected != sum(r.neg_rejected for r in want):
        raise AssertionError("oracle neg_rejected mismatch")
    print(f"   K={k} b_cap=64: matches {got} == oracle, neg_rejected "
          f"{tel.neg_rejected} == oracle, replans {tel.replans}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.engine import make_spec, packed_row_count
    from repro_torch.kernels import ops as kops
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

    t = phase("kernels")
    pattern = flowsense_rule().build()
    c_packed = packed_row_count(make_spec(pattern))
    # Negation veto rows: 2 validity + 2 window + 2 order anchors.
    c_rowcount = 6
    records = check_kernels("cuda", c_packed, c_rowcount)
    done("kernels", t)

    t = phase("main path")
    kops.reset_launch_counts()
    tel, secs = run_main("cuda")
    launches = dict(kops.LAUNCHES)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
    print(f"   K={K_MAIN} FlowSense rule, base_rate={BASE_RATE}, "
          f"b_cap={B_CAP}, m_cap={M_CAP}: {tel.events} events in "
          f"{secs:.3f} s = {tel.events / secs:.1f} events/s")
    print("   " + ", ".join(f"{f}={getattr(tel, f)}" for f in INT_FIELDS))
    print(f"   kernel launches on the main path: {launches}")
    kops.reset_launch_counts()
    ref_tel, ref_secs = run_main("cuda", backend="ref")
    if any(kops.LAUNCHES.values()):
        raise AssertionError("backend='ref' launched a kernel")
    for f in INT_FIELDS:
        if getattr(tel, f) != getattr(ref_tel, f):
            raise AssertionError(f"{f}: kernels {getattr(tel, f)} != "
                                 f"plain {getattr(ref_tel, f)}")
    if tel.per_partition_matches.tolist() != \
            ref_tel.per_partition_matches.tolist():
        raise AssertionError("per-partition matches differ from plain run")
    print(f"   plain-version rerun on the card: equal integer telemetry "
          f"({ref_secs:.3f} s = {ref_tel.events / ref_secs:.1f} events/s)")
    done("main path", t)

    t = phase("oracle")
    check_oracle("cuda")
    done("oracle", t)

    t = phase("profile")
    profile_main()
    done("profile", t)

    print(f"   total seconds: {time.perf_counter() - t_all:.3f}")
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    library_ms=None, **records[name])
               for name in ("window_join_packed", "window_join_rowcount")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
