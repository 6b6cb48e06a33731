"""Fleet executor benchmark on the PyTorch/CUDA port: one K-batched fleet
step vs a Python loop of engines, plus the cost of the ``repro_torch.cep``
facade, of device-resident invariant monitoring, and the superchunk and
meshed configurations.

The twin of ``benchmarks/fleet_bench.py``.  End-to-end chunk-tick
throughput for K independent stream partitions, executed as:

(a) ``loop``   — a host loop over K single-partition ``OrderEngine``
    steps (K launches of each kernel and K counter reads per chunk; the
    chunks are sliced onto the device outside the timed window);
(b) ``fleet``  — the raw data plane: ONE ``FleetEngine.process_chunk``
    per chunk over the stacked partition axis;
(c) ``facade`` — the same ticks through ``cep.open(...).step``;
(d) ``mon``    — a monitored facade session (statistics rings and the
    lowered invariants fused into the step, violation → replan loop).

Match counts must be equal across all four (a correctness gate).  (c)/(b)
is the facade overhead, gated at < 5%, and (d)/(c) the monitoring
overhead, gated at < 10% (each with the reference's 0.1 s of absolute
slack).  The superchunk section, in the dispatch-bound regime of tiny
chunks:

(e) ``scan``  — the monitored session with ``superchunk=8`` (each chunk
    of a window one CUDA-graph replay on the card), gated at ≥ 2× the
    per-chunk throughput at K=16 (+0.15 s of slack);
(f) ``shard`` — (e) with K split over ``gcd(K, devices)`` devices of the
    run's type (D = 1 on one card or the CPU), reported and not gated.

Scanned and meshed counts and violations must equal per-chunk stepping.
Throughput gates are recorded in ``BENCH_torch_fleet.json`` with both
sweeps' seconds and the slack beside the value, so ``met`` can be read
off the record; as in the reference a miss fails the run, after the JSON
is written, unless ``--no-gate``.  Correctness gates always fail the run.
The JSON also holds the K list and chunk counts the run used, and
``cut``: what it left out of its mode's grid (``full`` is false then).

``bench_windows`` is the per-chunk-vs-window turn bench of
``chip_smoke.py --bench N``.

    PYTHONPATH=src python -m benchmarks.torch_fleet_bench [--full] \\
        [--json BENCH_torch_fleet.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import statistics
import time

import numpy as np
import torch

from repro_torch import cep
from repro_torch.cep import OrderPlan, RuntimeConfig
from repro_torch.core import fleet as _fleet
from repro_torch.core import scan
from repro_torch.core.engine import (NEG_INF, POS_INF, Chunk, EngineConfig,
                                     OrderEngine)
from repro_torch.core.fleet import FleetEngine, stacked_streams
from repro_torch.data.cep_streams import StreamConfig, make_stream
from repro_torch.distributed import local_devices

from .torch_common import (check_device, device_block, seconds_gate, sync,
                           write_json)

HEADER = ("k,events,loop_s,fleet_s,facade_s,mon_s,loop_ev_s,fleet_ev_s,"
          "facade_ev_s,mon_ev_s,speedup,facade_ovh,mon_ovh,violations")

# Every integer field of a session's Telemetry.
INT_FIELDS = ("chunks", "events", "matches", "replans", "deployments",
              "violations", "host_syncs", "overflow", "dropped",
              "neg_rejected", "closure_expansions", "escalations",
              "migration_partition_chunks")


def same_telemetry(tel, want, what):
    """Every integer telemetry field and the per-partition matches."""
    for f in INT_FIELDS:
        if getattr(tel, f) != getattr(want, f):
            raise AssertionError(f"{what}: {f} {getattr(tel, f)} != "
                                 f"{getattr(want, f)}")
    if tel.per_partition_matches.tolist() != \
            want.per_partition_matches.tolist():
        raise AssertionError(f"{what}: per-partition matches differ")


def _records(k: int, n_chunks: int, chunk_cap: int, seed: int = 3):
    scfg = StreamConfig(n_types=3, n_chunks=n_chunks, chunk_cap=chunk_cap,
                        base_rate=10.0, seed=seed)
    streams = [make_stream("traffic", dataclasses.replace(scfg,
                                                          seed=seed + p))
               for p in range(k)]
    return list(stacked_streams(streams))


def _pattern():
    from repro_torch.cep import P

    return (P.seq(0, 1, 2)
            .where(P.attr(0) < P.attr(1) - 0.3,
                   P.attr(1) < P.attr(2) - 0.3)
            .within(4.0))


def _session_pass(sess, recs, k, device, reps: int = 3):
    """Best-of-``reps`` timed sweep of one facade session over ``recs``."""
    sess.step(recs[0].chunk, -1e9, -1e9 + 1)  # warm (kernel build)
    best = float("inf")
    for _ in range(reps):
        sess.reset()
        sync(device)
        t0 = time.perf_counter()
        counts = np.zeros(k, np.int64)
        for fc in recs:
            # step() reads this tick's counts back to the host, so the
            # sweep is end-to-end: nothing is left in flight at the stop.
            counts += sess.step(fc.chunk, fc.t0, fc.t1)
        best = min(best, time.perf_counter() - t0)
    return best, counts


def bench_k(k: int, n_chunks: int = 30, chunk_cap: int = 64,
            device: str = "cuda"):
    """The four configurations at one K: (CSV line, rows, gates)."""
    pat = _pattern()
    # Truncation-free capacity: overflow would make match counts depend on
    # the join order, so the cross-pass assertions would compare noise.
    cfg = EngineConfig(b_cap=32, m_cap=256, device=device)
    rcfg = RuntimeConfig(buffer_capacity=32, match_capacity=256,
                         policy=None, device=device)
    plans = [OrderPlan(((2, 1, 0), (0, 1, 2), (1, 0, 2))[p % 3])
             for p in range(k)]
    recs = _records(k, n_chunks, chunk_cap)
    events = int(sum(np.asarray(fc.chunk.valid).sum() for fc in recs))

    # -- host loop over K single-partition engines.  Chunks, clocks and
    # plan operands are on the device before the clock starts: the loop
    # is charged its K steps and K counter reads per chunk only.
    eng = OrderEngine(pat.build(), cfg)
    dev = eng.device
    split = [[Chunk(*(torch.as_tensor(np.asarray(x)[p:p + 1], device=dev)
                      for x in fc.chunk)) for p in range(k)] for fc in recs]
    clocks = [tuple(torch.as_tensor(np.asarray(
        [[fc.t0], [fc.t1], [NEG_INF], [POS_INF]], np.float32), device=dev))
        for fc in recs]
    ops = [eng.plan_operands(eng.plan_row(p)) for p in plans]
    states = [eng.init_state() for _ in range(k)]
    for p in range(k):  # warm (kernel build)
        eng.process(eng.init_state(), split[0][p], ops[p], *clocks[0])
    sync(device)
    t0 = time.perf_counter()
    loop_counts = np.zeros(k, np.int64)
    for ci in range(len(recs)):
        for p in range(k):
            states[p], res = eng.process(states[p], split[ci][p], ops[p],
                                         *clocks[ci])
            loop_counts[p] += int(res.full_matches[0])
    loop_s = time.perf_counter() - t0

    # -- raw fleet: one K-batched step per chunk, best of 3 ---------------
    fleet = FleetEngine("order", pat.build(), k, cfg)
    rows = fleet.plans_to_array(plans)
    fleet.process_chunk(fleet.init_state(), recs[0].chunk, rows,
                        -1e9, -1e9 + 1)  # warm
    fleet_s = float("inf")
    for _ in range(3):
        state = fleet.init_state()
        sync(device)
        t0 = time.perf_counter()
        fleet_counts = np.zeros(k, np.int64)
        for fc in recs:
            state, res = fleet.process_chunk(state, fc.chunk, rows,
                                             fc.t0, fc.t1)
            fleet_counts += res.full_matches.cpu().numpy().astype(np.int64)
        fleet_s = min(fleet_s, time.perf_counter() - t0)
    if fleet_counts.tolist() != loop_counts.tolist():
        raise AssertionError("fleet/loop disagree — semantics bug")

    # -- the public facade driving the same ticks -------------------------
    sess = cep.open(pat, partitions=k, plan="order", config=rcfg)
    for p, plan in enumerate(plans):
        sess.deploy(p, plan)
    facade_s, facade_counts = _session_pass(sess, recs, k, device)
    if facade_counts.tolist() != fleet_counts.tolist():
        raise AssertionError("facade/fleet disagree — semantics bug")
    if sess.telemetry().overflow != 0:
        raise AssertionError(
            "match-set truncation at bench scale; raise match_capacity so "
            "cross-pass count assertions stay meaningful")

    # -- monitored facade: rings + invariant checks + replan loop ---------
    # d = 0.5: flags still fire on real drift but replans stay rare, so
    # the gate measures the verification overhead (as the reference).
    mon_sess = cep.open(pat, partitions=k, plan="order", monitor=True,
                        config=dataclasses.replace(
                            rcfg, policy="invariant",
                            policy_kw={"k": 1, "d": 0.5}))
    for p, plan in enumerate(plans):
        mon_sess.deploy(p, plan)
    mon_s, mon_counts = _session_pass(mon_sess, recs, k, device)
    violations = mon_sess.telemetry().violations
    if mon_counts.tolist() != fleet_counts.tolist():
        raise AssertionError("monitored/plain facade disagree — semantics "
                             "bug")

    gates = {
        # The facade is bookkeeping around the same step: < 5% (plus the
        # reference's absolute slack for scheduler noise).
        f"facade_overhead_k{k}": seconds_gate(facade_s, fleet_s, 0.05, 0.1,
                                              "max"),
        # §3.3-§3.5: monitoring must cost < 10% of the data plane.
        f"monitoring_overhead_k{k}": seconds_gate(mon_s, facade_s, 0.10,
                                                  0.1, "max"),
    }
    line = (f"{k},{events},{loop_s:.3f},{fleet_s:.3f},{facade_s:.3f},"
            f"{mon_s:.3f},"
            f"{events / max(loop_s, 1e-9):.0f},"
            f"{events / max(fleet_s, 1e-9):.0f},"
            f"{events / max(facade_s, 1e-9):.0f},"
            f"{events / max(mon_s, 1e-9):.0f},"
            f"{loop_s / max(fleet_s, 1e-9):.2f},"
            f"{(facade_s - fleet_s) / max(fleet_s, 1e-9):+.1%},"
            f"{(mon_s - facade_s) / max(facade_s, 1e-9):+.1%},"
            f"{violations}")
    counts = fleet_counts.tolist()
    rows = [
        {"k": k, "config": name, "seconds": round(sec, 4), "events": events,
         "events_per_s": round(events / max(sec, 1e-9), 1),
         "matches": counts}
        for name, sec in (("baseline", loop_s), ("vmapped", fleet_s),
                          ("facade", facade_s), ("monitored", mon_s))
    ]
    rows[-1]["violations"] = int(violations)
    return line, rows, gates


# ---------------------------------------------------------------------------
# Superchunk / meshed section (the dispatch-bound regime)
# ---------------------------------------------------------------------------


def bench_superchunk(k: int = 16, superchunk: int = 8, n_chunks: int = 260,
                     warm: int = 60, device: str = "cuda"):
    """Scanned and meshed throughput in the dispatch-bound regime: tiny
    chunks (8 events per partition), minimal rings, a statistically
    stable stream (balanced rates, a 64-bucket estimator, d = 2) so the
    steady state is violation-free.  The warm prefix (builds, captures,
    ring fill, first adaptation) is outside the timed window; all three
    variants must agree on every match count and on the timed
    violations.  Returns (rows, summary, gates)."""
    scfg = StreamConfig(n_types=3, n_chunks=n_chunks, chunk_cap=8,
                        base_rate=1.5, seed=3, shift_every=1e9, zipf_s=0.1)
    recs = list(stacked_streams(
        [make_stream("traffic", dataclasses.replace(scfg, seed=3 + p))
         for p in range(k)]))
    chunks = [fc.chunk for fc in recs]
    edges = [(fc.t0, fc.t1) for fc in recs]
    events = int(sum(np.asarray(fc.chunk.valid).sum()
                     for fc in recs[warm:]))
    rcfg = RuntimeConfig(buffer_capacity=8, match_capacity=16,
                         estimator_buckets=64, max_invariants=8,
                         max_terms=16, policy="invariant",
                         policy_kw={"k": 1, "d": 2.0}, device=device)

    def sweep(s, mesh=None):
        sess = cep.open(_pattern(), partitions=k, plan="order",
                        monitor=True, config=rcfg, superchunk=s, mesh=mesh)
        if s == 1:
            for ch, (u, v) in zip(chunks[:warm], edges[:warm]):
                sess.step(ch, u, v)
            v0 = sess.telemetry().violations
            sync(device)
            t0 = time.perf_counter()
            counts = np.zeros(k, np.int64)
            for ch, (u, v) in zip(chunks[warm:], edges[warm:]):
                counts += sess.step(ch, u, v)
            dt = time.perf_counter() - t0
        else:
            sess.step_superchunk(chunks[:warm], edges[:warm])
            v0 = sess.telemetry().violations
            sync(device)
            t0 = time.perf_counter()
            counts = sess.step_superchunk(chunks[warm:],
                                          edges[warm:]).sum(axis=0)
            dt = time.perf_counter() - t0
        return dt, counts, sess.telemetry().violations - v0

    per_chunk_s, c1, v1 = sweep(1)
    scan_s, c8, v8 = sweep(superchunk)
    # Largest device count that divides K (an uneven split is rejected by
    # design); on one device this is the D=1 blocked code path.
    devices = math.gcd(k, len(local_devices(device)))
    shard_s, cs, vs = sweep(superchunk, mesh=devices)

    if not c1.tolist() == c8.tolist() == cs.tolist():
        raise AssertionError("scanned/meshed match counts diverge from "
                             "per-chunk stepping — semantics bug")
    if not v1 == v8 == vs:
        raise AssertionError("scanned/meshed violation flags diverge from "
                             "per-chunk stepping")
    # Rolling S chunks per window must at least double dispatch-bound
    # throughput at K=16 (the reference's bar and slack).
    gates = {f"superchunk_speedup_k{k}": seconds_gate(
        scan_s, per_chunk_s, 2.0, 0.15, "min")}

    print("superchunk section (dispatch-bound regime)")
    print("k,events,per_chunk_s,scan_s,shard_s,scan_speedup,shard_speedup,"
          "devices,timed_violations")
    print(f"{k},{events},{per_chunk_s:.3f},{scan_s:.3f},{shard_s:.3f},"
          f"{per_chunk_s / max(scan_s, 1e-9):.2f},"
          f"{per_chunk_s / max(shard_s, 1e-9):.2f},"
          f"{devices},{v1}", flush=True)
    rows = [
        {"k": k, "config": name, "seconds": round(sec, 4),
         "events": events,
         "events_per_s": round(events / max(sec, 1e-9), 1),
         "matches": c1.tolist()}
        for name, sec in (("per_chunk_monitored", per_chunk_s),
                          ("scanned", scan_s), ("sharded", shard_s))
    ]
    summary = {
        "k": k, "superchunk": superchunk, "devices": devices,
        "events": events, "timed_violations": int(v1),
        "per_chunk_s": round(per_chunk_s, 4),
        "scanned_s": round(scan_s, 4),
        "sharded_s": round(shard_s, 4),
        "speedup_scanned": round(per_chunk_s / max(scan_s, 1e-9), 3),
        "speedup_sharded": round(per_chunk_s / max(shard_s, 1e-9), 3),
        "matches": c1.tolist(),
    }
    return rows, summary, gates


# ---------------------------------------------------------------------------
# Per-chunk vs window turns (chip_smoke.py --bench N)
# ---------------------------------------------------------------------------


def timed_split_run(sess, chunks, split, serving, superchunk, device):
    """One run of a fresh session over the stacked ``chunks``: the first
    ``split`` chunks (in which a window session captures its graphs) and
    the rest, timed apart, through ``Session.run`` or, for ``serving``,
    ``step`` (``superchunk`` 1) or ``step_superchunk``.  Returns the two
    segments' seconds and the per-chunk matches (serving; else None)."""
    secs, got = [], []
    for seg in (chunks[:split], chunks[split:]):
        sync(device)
        t = time.perf_counter()
        if not serving:
            sess.run(seg, resume=bool(secs))
        elif superchunk == 1:
            got.append(np.stack([sess.step(fc.chunk, fc.t0, fc.t1)
                                 for fc in seg]))
        else:
            got.append(sess.step_superchunk(
                [fc.chunk for fc in seg], [(fc.t0, fc.t1) for fc in seg]))
        sync(device)
        secs.append(time.perf_counter() - t)
    return secs, (np.concatenate(got) if got else None)


def bench_windows(open_session, chunks, n_runs, superchunk=8, split=8,
                  paths=("order", "tree", "serving"), device="cuda"):
    """Per path, ``n_runs`` per-chunk and ``n_runs`` window runs in turns
    (per-chunk, window, window, per-chunk, ...), each from an empty memo
    (a window run captures its graphs in its first chunks) and each held
    to the first run's telemetry; prints events/s per run over all chunks
    and over those after the first ``split``, with medians and ranges,
    peak device memory, and the last window run's windows, captures,
    replays and in-window events.  ``open_session(path, superchunk)``
    opens a fresh session; a path other than "serving" runs through
    ``Session.run``.  Returns {(path, superchunk, "all" | "late"):
    [events/s, ...]}."""
    cuda = torch.device(device).type == "cuda"
    turns = ([1, superchunk, superchunk, 1] * n_runs)[:2 * n_runs]
    n_events = int(sum(np.asarray(fc.chunk.valid).sum() for fc in chunks))
    n_late = int(sum(np.asarray(fc.chunk.valid).sum()
                     for fc in chunks[split:]))
    out = {}
    for path in paths:
        serving = path == "serving"
        rates = {(s, w): [] for s in (1, superchunk) for w in ("all", "late")}
        peaks = {1: 0, superchunk: 0}
        want = None  # the first run's telemetry and per-chunk matches
        for s in turns:
            _fleet.clear_trace_memo()
            scan.reset_counts()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sess = open_session(path, s)
            secs, got = timed_split_run(sess, chunks, split, serving, s,
                                        device)
            tel = sess.telemetry()
            want = want or (tel, got)
            same_telemetry(tel, want[0], f"bench {path} S={s}")
            if got is not None and got.tolist() != want[1].tolist():
                raise AssertionError(f"bench {path} S={s}: per-chunk "
                                     "matches differ")
            rates[s, "all"].append(n_events / sum(secs))
            rates[s, "late"].append(n_late / secs[1])
            if cuda:
                peaks[s] = max(peaks[s], torch.cuda.max_memory_allocated())
            if s > 1:
                runner = sess._serving if serving else sess._runner
                cut, counts = runner.in_window_events, dict(scan.COUNTS)
        for (s, which), r in rates.items():
            span = ("all chunks" if which == "all" else
                    f"chunks {split}-{len(chunks) - 1}")
            print(f"   bench {path} superchunk={s}, {span}: "
                  f"events/s {[round(x, 1) for x in r]}, median "
                  f"{statistics.median(r):.1f} (range {min(r):.1f}-"
                  f"{max(r):.1f})")
            out[path, s, which] = r
        print(f"   bench {path}: peak device memory per-chunk "
              f"{peaks[1] / 2 ** 30:.3f} GiB, window "
              f"{peaks[superchunk] / 2 ** 30:.3f} GiB; the last window "
              f"run's windows {counts['windows']}, graph captures "
              f"{counts['captures']}, replays {counts['replays']}, "
              f"in-window events {cut}")
    return out


def main(argv=None, quick: bool = True) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="bounded scale (the default)")
    ap.add_argument("--json", default="BENCH_torch_fleet.json",
                    help="machine-readable output path ('' disables)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ks", default=None,
                    help="comma list of K (default: per mode)")
    ap.add_argument("--chunks", type=int, default=None,
                    help="chunks per K sweep (default: per mode)")
    ap.add_argument("--superchunk-chunks", type=int, default=None,
                    help="chunks of the superchunk section, the first 60 "
                         "warm (default: per mode)")
    ap.add_argument("--no-gate", action="store_true",
                    help="record the throughput gates but never fail on "
                         "them")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    if args.full:
        quick = False
    grid = {"ks": [4, 16] if quick else [1, 4, 16, 64],
            "n_chunks": 30 if quick else 80,
            "superchunk_chunks": 260 if quick else 400}
    ran = {"ks": ([int(x) for x in args.ks.split(",")] if args.ks
                  else grid["ks"]),
           "n_chunks": args.chunks or grid["n_chunks"],
           "superchunk_chunks": args.superchunk_chunks
           or grid["superchunk_chunks"]}
    # What a run left out of its mode's grid: a cut run is not that mode.
    cut = [f"{key} {ran[key]} of {grid[key]}" for key in grid
           if ran[key] != grid[key]]
    ks, n_chunks, sc_chunks = (ran["ks"], ran["n_chunks"],
                               ran["superchunk_chunks"])
    all_rows, gates = [], {}
    print(HEADER)
    for k in ks:
        line, rows, g = bench_k(k, n_chunks=n_chunks, device=device)
        all_rows.extend(rows)
        gates.update(g)
        print(line, flush=True)
    sc_rows, sc_summary, g = bench_superchunk(
        n_chunks=sc_chunks, warm=min(60, sc_chunks // 2), device=device)
    all_rows.extend(sc_rows)
    gates.update(g)
    for name, g in gates.items():
        print(f"gate {name}: {g['value']:+.4f} ({g['bound']} "
              f"{g['threshold']}; {g['seconds']:.4f} s vs "
              f"{g['base_s']:.4f} s, {g['slack_s']} s slack) "
              f"{'met' if g['met'] else 'NOT MET'}")
    if args.json:
        write_json(args.json, {
            "schema": "fleet_bench/v1",
            "quick": quick,
            "full": not quick and not cut,
            "cut": cut,
            **ran,
            "device": device_block(device),
            "rows": all_rows,
            "superchunk": sc_summary,
            "gates": gates,
        })
        print(f"wrote {args.json}")
    missed = [name for name, g in gates.items() if not g["met"]]
    if missed and not args.no_gate:
        raise AssertionError(f"throughput gates not met: {missed}")
    return 0


if __name__ == "__main__":
    main()
