"""Rulebook bench on the PyTorch/CUDA port: one data plane for Q rules vs
Q independent Sessions.

The twin of ``benchmarks/rulebook_bench.py``, with its five gates:

  1. Throughput — at Q=32 the rulebook must clear >= 2x the wall-clock
     throughput of stepping Q monitored Sessions over the same chunks.
  2. Equivalence — per-rule match counts *bit-identical* to the Q
     independent Sessions, with zero overflow on both sides.
  3. Hot add — adding a rule into a spare slot builds no new window
     shape and captures no CUDA graph (``trace_count()`` and the window
     captures, across the add *and* the next step of the per-chunk
     rulebook and the next window of the superchunk one: the port's
     counterpart of the reference's retrace probe), and lands far under
     a cold rulebook open + first step (< 1/5).
  4. Superchunk — at Q=32, ``superchunk = 8`` chunks per window must
     clear >= 1.5x the per-chunk rulebook on the same stream (+0.2 s of
     slack), with per-rule counts, overflow and violations identical.
  5. Lattice — ``sharing_ratio()`` under ``sharing="lattice"`` strictly
     above ``sharing="prefix"`` on the mixed-prefix suite.

Correctness gates (2, 3's probe, 4's identity, 5 and the grouping of the
shared-prefix families) always fail the run; throughput gates (1, 3's
latency, 4's speedup) are recorded with value and ``met`` in
``BENCH_torch_rulebook.json`` and fail the run after it is written unless
``--no-gate``.  Wall times end in a device sync.

    PYTHONPATH=src python -m benchmarks.torch_rulebook_bench [--full] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import cep
from repro_torch.cep import RuntimeConfig, open_rulebook
from repro_torch.core import scan
from repro_torch.core.engine import Chunk

from .torch_common import (check_device, device_block, seconds_gate, sync,
                           write_json)

HEADER = "q,k,config,seconds,events,events_per_s,speedup"

_A = 2          # attribute width shared by every generated rule
_N_TYPES = 5
_CAP = 32       # event slots per chunk per partition


def make_rules(q: int):
    """Deterministic mixed rulebook: shared-prefix SEQ families, AND
    triples, bare pairs, plus NEG and Kleene representatives (the
    reference's, rule for rule)."""
    from repro_torch.cep import P

    rng = np.random.default_rng(11)
    rules = []
    for p0, p1 in ((0, 1), (2, 3), (1, 4), (3, 0)):
        th = round(float(rng.uniform(0.2, 0.6)), 3)
        for x in range(_N_TYPES):
            if x in (p0, p1):
                continue
            rules.append(P.seq(p0, p1, x)
                         .where(P.attr(0, 0) < P.attr(1, 0) + th)
                         .within(2.0).attrs(_A))
    rules.append(P.seq(0, P.neg(3), 1, 2)
                 .where(P.attr(0, 0) < P.attr(1, 0) + 0.3)
                 .within(3.0).attrs(_A))
    rules.append(P.seq(2, P.neg(0), 4, 1)
                 .where(P.attr(0, 1) < P.attr(1, 0) + 0.2)
                 .within(3.0).attrs(_A))
    rules.append(P.seq(3, P.kleene(4, 2), 1).within(2.5).attrs(_A))
    rules.append(P.seq(1, P.kleene(0, 2), 2).within(2.5).attrs(_A))
    # Two 4-arity families agreeing on their first three positions: only
    # the full lattice shares the 3-position sub-join (gate 5).
    for p0, p1, p2 in ((0, 1, 2), (3, 4, 0)):
        th = round(float(rng.uniform(0.1, 0.4)), 3)
        for x in range(_N_TYPES):
            if x in (p0, p1, p2):
                continue
            rules.append(P.seq(p0, p1, p2, x)
                         .where(P.attr(0, 0) < P.attr(1, 0) + th,
                                P.attr(1, 1) < P.attr(2, 0) + th)
                         .within(3.0).attrs(_A))
    while len(rules) < q:
        kind = len(rules) % 3
        types = rng.choice(_N_TYPES, size=3, replace=False).tolist()
        th = round(float(rng.uniform(-0.2, 0.5)), 3)
        if kind == 0:
            rules.append(P.seq(*types)
                         .where(P.attr(0, 0) < P.attr(1, 1) + th)
                         .within(2.0).attrs(_A))
        elif kind == 1:
            rules.append(P.and_(*types)
                         .where(P.attr(0, 1) > P.attr(2, 0) - th)
                         .within(1.5).attrs(_A))
        else:
            rules.append(P.seq(types[0], types[1])
                         .within(1.5).attrs(_A))
    return rules[:q]


def make_chunks(n_chunks: int, k: int, seed: int = 7, cap: int = _CAP,
                lo: int = 4, hi: int = 10):
    """Pre-generated stacked (K-axis) host chunks, identical for both
    sides (the reference's draws, in its order)."""
    rng = np.random.default_rng(seed)
    out, events = [], 0

    def one(t0, t1):
        nonlocal events
        n = int(rng.integers(lo, hi))
        events += n
        tid = rng.integers(0, _N_TYPES, size=n).astype(np.int32)
        ts = np.sort(rng.uniform(t0, t1, size=n)).astype(np.float32)
        attr = rng.normal(size=(n, _A)).astype(np.float32)
        pad = cap - n
        return Chunk(
            type_id=np.pad(tid, (0, pad), constant_values=-1),
            ts=np.pad(ts, (0, pad)),
            attr=np.pad(attr, ((0, pad), (0, 0))),
            valid=np.arange(cap) < n)

    for step in range(n_chunks):
        t0, t1 = float(step), float(step + 1)
        parts = [one(t0, t1) for _ in range(k)]
        out.append((Chunk(*(np.stack(xs) for xs in zip(*parts))), t0, t1))
    return out, events


def _gate(value, threshold, met, kind="min"):
    return {"value": round(value, 4), "threshold": threshold,
            "bound": kind, "met": bool(met)}


def bench_q(q: int, k: int, n_chunks: int, device: str = "cuda"):
    # match_capacity is sized so overflow stays 0 — the equivalence
    # gate is only meaningful without truncation.
    cfg = RuntimeConfig(buffer_capacity=32, match_capacity=128,
                        estimator_buckets=8, device=device)
    rules = make_rules(q)
    chunks, events = make_chunks(n_chunks, k)

    sync(device)
    t = time.perf_counter()
    rb = open_rulebook(rules, partitions=k, monitor=True, config=cfg,
                       spare_slots=1)
    rb.step(*chunks[0])
    sync(device)
    cold_s = time.perf_counter() - t

    sessions = [cep.open(r, partitions=k, monitor=True, config=cfg)
                for r in rules]
    sess_counts = np.zeros((q, k), np.int64)
    for i, s in enumerate(sessions):
        sess_counts[i] += np.asarray(s.step(*chunks[0]))

    # timed region: identical chunk stream through both fronts (every
    # step reads its counts back, so nothing is left in flight)
    t = time.perf_counter()
    for chunk, t0, t1 in chunks[1:]:
        rb.step(chunk, t0, t1)
    rb_s = time.perf_counter() - t

    t = time.perf_counter()
    for chunk, t0, t1 in chunks[1:]:
        for i, s in enumerate(sessions):
            sess_counts[i] += np.asarray(s.step(chunk, t0, t1))
    loop_s = time.perf_counter() - t

    tel = rb.telemetry()
    if tel.overflow != 0:
        raise AssertionError(
            f"rulebook overflow {tel.overflow} — counts are plan-dependent "
            "under truncation; raise match_capacity")
    for s in sessions:
        if s.telemetry().overflow != 0:
            raise AssertionError("session side overflowed")
    if not np.array_equal(rb.match_counts, sess_counts):
        raise AssertionError(
            "per-rule counts diverge from Q independent Sessions:\n"
            f"{rb.match_counts}\nvs\n{sess_counts}")

    # Opening a prefix-mode rulebook is host work (planning + layout, no
    # step), so reading its sharing_ratio() costs no kernel.
    prefix_ratio = open_rulebook(
        rules, partitions=k, monitor=False,
        config=RuntimeConfig(buffer_capacity=32, match_capacity=128,
                             estimator_buckets=8, sharing="prefix",
                             device=device),
        spare_slots=1).sharing_ratio()

    ev = events * 1  # per-partition streams are independent draws
    speedup = loop_s / max(rb_s, 1e-9)
    rows = [
        {"q": q, "k": k, "config": "rulebook", "seconds": round(rb_s, 4),
         "events": ev, "events_per_s": round(ev / max(rb_s, 1e-9), 1)},
        {"q": q, "k": k, "config": "session_loop",
         "seconds": round(loop_s, 4),
         "events": ev, "events_per_s": round(ev / max(loop_s, 1e-9), 1)},
    ]
    print(f"{q},{k},rulebook,{rb_s:.3f},{ev},{ev / max(rb_s, 1e-9):.1f},"
          f"{speedup:.2f}", flush=True)
    print(f"{q},{k},session_loop,{loop_s:.3f},{ev},"
          f"{ev / max(loop_s, 1e-9):.1f},1.00", flush=True)
    return rb, chunks, rows, {
        "q": q, "k": k, "events": ev, "rulebook_s": round(rb_s, 4),
        "session_loop_s": round(loop_s, 4), "speedup": round(speedup, 3),
        "cold_compile_s": round(cold_s, 4),
        "sharing_ratio": round(rb.sharing_ratio(), 3),
        "prefix_sharing_ratio": round(prefix_ratio, 3),
        "n_buckets": rb.n_buckets,
        "replans": tel.replans, "violations": tel.violations,
        "match_counts": rb.match_counts.tolist(),
    }


def superchunk_rulebooks(q: int, k: int, s_cap: int, device: str):
    """The per-chunk and the S-chunk-window rulebooks of the superchunk
    gate.  A 128-cell plane needs more per-cell distance slack than one
    session for the same plane-level flag rate (any of K*Q cells splits
    the window), hence d = 5 (the reference's)."""
    cfg_kw = dict(buffer_capacity=8, match_capacity=16,
                  estimator_buckets=32, policy_kw={"k": 1, "d": 5.0},
                  device=device)
    rules = make_rules(q)
    rb_pc = open_rulebook(rules, partitions=k, monitor=True,
                          config=RuntimeConfig(**cfg_kw), spare_slots=1)
    rb_sc = open_rulebook(rules, partitions=k, monitor=True,
                          config=RuntimeConfig(superchunk=s_cap, **cfg_kw),
                          spare_slots=1)
    return rb_pc, rb_sc


def bench_superchunk(q: int, k: int, s_cap: int, warm: int, tail: int,
                     device: str = "cuda"):
    """S chunks per window vs per-chunk stepping over the SAME stream and
    config in the dispatch-bound regime (8-event chunks, minimal rings,
    d = 5 so steady-state flags are rare): the timed tail's speedup, and
    per-rule counts, overflow and violation flags identical over the
    whole stream.  Returns (summary, the window rulebook, its chunks)."""
    chunks, _ = make_chunks(warm + tail, k, seed=9, cap=8, lo=3, hi=8)
    cs = [c for c, _, _ in chunks]
    edges = [(t0, t1) for _, t0, t1 in chunks]
    rb_pc, rb_sc = superchunk_rulebooks(q, k, s_cap, device)
    # Pass 1 (untimed): the full cold trajectory on both sides — warm
    # region flags, replans and all.  This is the bit-identity evidence.
    for c, t0, t1 in chunks:
        rb_pc.step(c, t0, t1)
    rb_sc.step_superchunk(cs, edges)
    tel_pc, tel_sc = rb_pc.telemetry(), rb_sc.telemetry()

    def time_pc():
        rb_pc.reset()
        for c, t0, t1 in chunks[:warm]:
            rb_pc.step(c, t0, t1)
        t = time.perf_counter()
        for c, t0, t1 in chunks[warm:]:
            rb_pc.step(c, t0, t1)
        return time.perf_counter() - t

    def time_sc():
        rb_sc.reset()
        rb_sc.step_superchunk(cs[:warm], edges[:warm])
        t = time.perf_counter()
        rb_sc.step_superchunk(cs[warm:], edges[warm:])
        return time.perf_counter() - t

    # Two alternating timed replays per side over the adapted plans
    # (reset clears stream state, keeps deployments), min-time ratio.
    pc_s = min(time_pc(), time_pc())
    sc_s = min(time_sc(), time_sc())
    # Bit identity over the FULL stream, counters and flags alike.
    if not np.array_equal(rb_sc.match_counts, rb_pc.match_counts):
        raise AssertionError(
            "superchunk counts diverge from per-chunk stepping:\n"
            f"{rb_sc.match_counts}\nvs\n{rb_pc.match_counts}")
    if tel_sc.overflow != tel_pc.overflow:
        raise AssertionError(
            f"overflow diverges: {tel_sc.overflow} vs {tel_pc.overflow}")
    if tel_sc.violations != tel_pc.violations:
        raise AssertionError(
            f"violation flags diverge: {tel_sc.violations} "
            f"vs {tel_pc.violations}")
    speedup = pc_s / max(sc_s, 1e-9)
    print(f"superchunk,s={s_cap},{sc_s:.3f}s,per_chunk,{pc_s:.3f}s,"
          f"speedup,{speedup:.2f},host_syncs,{tel_sc.host_syncs}vs"
          f"{tel_pc.host_syncs},replans,{tel_sc.replans}", flush=True)
    return {"superchunk": s_cap, "superchunk_s": round(sc_s, 4),
            "superchunk_per_chunk_s": round(pc_s, 4),
            "superchunk_speedup": round(speedup, 3),
            "superchunk_host_syncs": tel_sc.host_syncs,
            "per_chunk_host_syncs": tel_pc.host_syncs,
            "superchunk_replans": tel_sc.replans,
            "superchunk_violations": tel_sc.violations,
            "superchunk_overflow": tel_sc.overflow,
            "superchunk_match_counts": rb_sc.match_counts.tolist()}, \
        rb_sc, chunks


def hot_added_rule():
    from repro_torch.cep import P

    return (P.seq(4, 2, 0)
            .where(P.attr(0, 1) < P.attr(1, 0) + 0.5)
            .within(1.5).attrs(_A))


def bench_hot_add(rb, chunks, cold_s: float, device: str = "cuda",
                  window_rb=None, window_chunks=None):
    """Hot add into a spare slot of ``rb`` and the next per-chunk step
    (timed), and, if given, into ``window_rb`` and its next window over
    ``window_chunks``: no new window shape and no graph capture across
    either; returns the record."""
    probes = [rb] + ([window_rb] if window_rb is not None else [])
    pre = sum(b.trace_count() for b in probes)
    captures = scan.COUNTS["captures"]
    chunk, t0, t1 = chunks[-1]
    sync(device)
    t = time.perf_counter()
    rid = rb.add_rule(hot_added_rule())
    rb.step(chunk, t0 + 1.0, t1 + 1.0)
    sync(device)
    hot_s = time.perf_counter() - t
    if window_rb is not None:
        window_rb.add_rule(hot_added_rule())
        last = window_chunks[-1][2]
        window_rb.step_superchunk(
            [c for c, _, _ in window_chunks[:8]],
            [(a + last, b + last) for _, a, b in window_chunks[:8]])
    retraces = sum(b.trace_count() for b in probes) - pre
    new_captures = scan.COUNTS["captures"] - captures
    if retraces != 0 or new_captures != 0:
        raise AssertionError(
            f"hot add entered {retraces} new window shape(s) and captured "
            f"{new_captures} graph(s) — spare-slot writes must not change "
            "any shape")
    if rid not in rb.rules:
        raise AssertionError("hot-added rule missing")
    print(f"hot_add,{hot_s:.4f}s,cold_compile,{cold_s:.3f}s,"
          f"retraces,{retraces},captures,{new_captures}", flush=True)
    return {"hot_add_s": round(hot_s, 4), "cold_compile_s": round(cold_s, 4),
            "retraces": retraces, "captures": new_captures}


def main(argv=None, quick: bool = True) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="bounded scale (the default); explicit flag for CI")
    ap.add_argument("--json", default="BENCH_torch_rulebook.json",
                    help="machine-readable output path ('' disables)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--qs", default=None,
                    help="comma list of Q (default 8,32; the gates are "
                         "read at the largest)")
    ap.add_argument("--chunks", type=int, default=None,
                    help="chunks of the Q sweep (default: per mode)")
    ap.add_argument("--warm", type=int, default=None)
    ap.add_argument("--tail", type=int, default=None)
    ap.add_argument("--no-gate", action="store_true",
                    help="record the throughput gates but never fail on "
                         "them")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    if args.full:
        quick = False
    k = 4
    qs = tuple(int(x) for x in args.qs.split(",")) if args.qs else (8, 32)
    n_chunks = args.chunks or (12 if quick else 30)
    warm = args.warm or (40 if quick else 60)
    tail = args.tail or (120 if quick else 240)

    all_rows, summaries, gates = [], [], {}
    print(HEADER)
    hot = None
    for q in qs:
        rb, chunks, rows, summary = bench_q(q, k, n_chunks, device)
        all_rows.extend(rows)
        if q == max(qs):
            sc, rb_sc, sc_chunks = bench_superchunk(q, k, 8, warm, tail,
                                                    device)
            summary.update(sc)
            hot = bench_hot_add(rb, chunks, summary["cold_compile_s"],
                                device, rb_sc, sc_chunks)
            if not summary["sharing_ratio"] > 1.0:
                raise AssertionError("shared-prefix families failed to "
                                     "group")
            if not summary["sharing_ratio"] > summary["prefix_sharing_ratio"]:
                raise AssertionError(
                    "lattice sharing no better than opening-prefix sharing "
                    f"on the mixed-prefix suite: {summary['sharing_ratio']} "
                    f"vs {summary['prefix_sharing_ratio']}")
            # The headline gate: Q rules in per-bucket steps must at least
            # double throughput at the largest Q.
            gates[f"rulebook_speedup_q{q}"] = _gate(
                summary["speedup"], 2.0, summary["speedup"] >= 2.0)
            gates[f"superchunk_speedup_q{q}"] = seconds_gate(
                summary["superchunk_s"], summary["superchunk_per_chunk_s"],
                1.5, 0.2, "min")
            gates["hot_add_latency"] = _gate(
                hot["hot_add_s"] / max(hot["cold_compile_s"], 1e-9), 0.2,
                hot["hot_add_s"] < hot["cold_compile_s"] / 5.0, kind="max")
        summaries.append(summary)
    for name, g in gates.items():
        print(f"gate {name}: {g['value']:.4f} ({g['bound']} "
              f"{g['threshold']}) {'met' if g['met'] else 'NOT MET'}")

    if args.json:
        write_json(args.json, {
            "schema": "rulebook_bench/v1",
            "quick": quick,
            "device": device_block(device),
            "rows": all_rows,
            "summaries": summaries,
            "hot_add": hot,
            "gates": gates,
        })
        print(f"wrote {args.json}")
    missed = [name for name, g in gates.items() if not g["met"]]
    if missed and not args.no_gate:
        raise AssertionError(f"throughput gates not met: {missed}")
    return 0


if __name__ == "__main__":
    main()
