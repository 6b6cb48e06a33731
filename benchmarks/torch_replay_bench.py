"""High-rate replay harness over the real-workload scenario suite, on the
PyTorch/CUDA port.

The twin of ``benchmarks/replay_bench.py``.  Streams every bundled
scenario (``repro_torch.data.scenarios``) through ``cep.open(...)``
segment by segment — warmup, stationary control, drift — under four
runtime configurations:

* ``adaptive``     — device-monitored invariant policy (the paper's loop);
* ``adaptive_s8``  — the same, in 8-chunk superchunk windows (CUDA-graph
  replays on the card);
* ``static``       — no monitor, cold plan pinned, capacity escalation on
  overflow (the honest do-nothing baseline);
* ``pinned``       — cold plan *and* capacities pinned (no escalation):
  the lossy baseline, reported as recall.

Every configuration is replayed once warm (kernel build, graph captures,
the process-wide memo), then ``--passes`` timed times (2, as the
reference) whose telemetry must agree; each segment keeps the lowest
wall.  Wall times end in a device sync.

Self-gates (a failed correctness gate always exits 1; ``--no-gate``
records a missed throughput gate without failing):

* correctness — ``zero_control_replans`` (zero replans and violations on
  every stationary control segment), ``detection_invariance`` (adaptive
  and static match counts equal per segment), ``expected_deployments``
  (drift deployments >= the scenario's ``min_drift_deployments``),
  ``pinned_loses_matches`` (the pinned baseline's drift recall < 1) and
  ``superchunk_control_silent``;
* throughput — ``adaptive_ge_static_tput`` (adaptive >= static on every
  drifting segment); its value (the smallest adaptive / static ratio)
  and its ``met`` flag are in ``throughput_gates``.

Results land in ``BENCH_torch_scenarios.json`` (schema ``scenarios/v1``,
plus the ``device`` block).

    PYTHONPATH=src python -m benchmarks.torch_replay_bench --quick
    PYTHONPATH=src python -m benchmarks.torch_replay_bench --full
    PYTHONPATH=src python -m benchmarks.torch_replay_bench --scenario fraud \\
        --chunks-scale 4 --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch import cep
from repro_torch.cep import RuntimeConfig
from repro_torch.data import scenarios

from .torch_common import check_device, device_block, sync, write_json

SCHEMA = "scenarios/v1"

CONFIGS = ("adaptive", "adaptive_s8", "static", "pinned")
SUPERCHUNK = 8
THROUGHPUT_GATES = ("adaptive_ge_static_tput",)


def session(sc, config: str, device: str = "cuda"):
    """A fresh Session for one named runtime configuration."""
    rt = dict(sc.runtime, device=device)
    monitor, superchunk = False, 1
    if config.startswith("adaptive"):
        monitor = True
        if config == "adaptive_s8":
            superchunk = SUPERCHUNK
    else:
        rt["policy"] = None
        rt.pop("policy_kw", None)
        rt["escalate_on_overflow"] = config != "pinned"
    return cep.open(sc.pattern, partitions=sc.partitions, monitor=monitor,
                    superchunk=superchunk, config=RuntimeConfig(**rt))


def replay(sc, segs, config: str, device: str = "cuda"):
    """One full replay through one resumable session: per segment
    ``(segment, wall_s, Telemetry)``."""
    s = session(sc, config, device)
    rows = []
    for i, (seg, parts) in enumerate(segs):
        sync(device)
        t0 = time.perf_counter()
        tel = s.run(parts, resume=(i > 0))
        sync(device)
        rows.append((seg, time.perf_counter() - t0, tel))
    return rows


def _tel_row(seg, wall, tel) -> dict:
    return {
        "segment": seg.name, "gate": seg.gate,
        "events": int(tel.events), "matches": int(tel.matches),
        "wall_s": round(wall, 4),
        "tput_evps": round(tel.events / wall, 1) if wall > 0 else None,
        "replans": int(tel.replans), "deployments": int(tel.deployments),
        "violations": int(tel.violations), "overflow": int(tel.overflow),
        "escalations": int(tel.escalations),
    }


def by_gate(rows, gate):
    return [r for r in rows if r[0].gate == gate]


def scenario_gates(sc, runs) -> dict:
    """The self-gates over one scenario's replays (``runs``: config ->
    per-segment rows).  Returns the gates, the throughput gates' values
    and the pinned baseline's drift recall."""
    gates, tput = {}, {}
    drift_a = by_gate(runs["adaptive"], "drift")
    drift_s = by_gate(runs["static"], "drift")
    drift_p = by_gate(runs["pinned"], "drift")
    ctrl_a = by_gate(runs["adaptive"], "control")

    ratios = [(ta.events / wa) / (ts.events / ws)
              for (_, wa, ta), (_, ws, ts) in zip(drift_a, drift_s)]
    gates["adaptive_ge_static_tput"] = all(r >= 1.0 for r in ratios)
    tput["adaptive_ge_static_tput"] = {
        "value": round(min(ratios), 4) if ratios else None,
        "threshold": 1.0, "bound": "min",
        "met": gates["adaptive_ge_static_tput"]}
    gates["zero_control_replans"] = all(
        t.replans == 0 and t.violations == 0 for _, _, t in ctrl_a)
    gates["detection_invariance"] = all(
        ta.matches == ts.matches
        for (_, _, ta), (_, _, ts) in zip(runs["adaptive"], runs["static"]))
    gates["expected_deployments"] = (
        sum(t.deployments for _, _, t in drift_a)
        >= int(sc.expected.get("min_drift_deployments", 1)))
    m_static = sum(t.matches for _, _, t in drift_s)
    m_pinned = sum(t.matches for _, _, t in drift_p)
    gates["pinned_loses_matches"] = m_pinned < m_static
    if "adaptive_s8" in runs:
        ctrl_s8 = by_gate(runs["adaptive_s8"], "control")
        gates["superchunk_control_silent"] = all(
            t.replans == 0 and t.violations == 0 for _, _, t in ctrl_s8)
    return gates, tput, round(m_pinned / max(1, m_static), 4)


def run_scenario(sc, *, seed: int, rate: float, chunks_scale: float,
                 superchunk: bool, device: str = "cuda",
                 runs: dict = None, passes: int = 2) -> dict:
    """Replays one scenario under every configuration, a warm pass then
    ``passes`` timed ones; ``runs``, if given, receives the
    per-configuration rows ``(segment, wall_s, Telemetry)``."""
    segs = sc.segment_streams(seed=seed, rate_scale=rate,
                              chunks_scale=chunks_scale)
    configs = [c for c in CONFIGS if superchunk or c != "adaptive_s8"]
    runs = {} if runs is None else runs
    for config in configs:
        replay(sc, segs, config, device)            # warm pass
        timed = [replay(sc, segs, config, device) for _ in range(passes)]
        # Replays are deterministic, so telemetry is identical across
        # passes; keep the per-segment best wall.
        runs[config] = []
        for rows in zip(*timed):
            seg, _, tel = rows[0]
            if any(t.matches != tel.matches for _, _, t in rows):
                raise AssertionError(f"non-deterministic replay: {config} "
                                     f"diverged on segment {seg.name}")
            runs[config].append((seg, min(w for _, w, _ in rows), tel))

    gates, tput, recall = scenario_gates(sc, runs)
    return {
        "description": sc.description,
        "partitions": sc.partitions,
        "rate_scale": sc.rate_scale * rate,
        "chunks_scale": chunks_scale,
        "events": int(sum(t.events for _, _, t in runs["adaptive"])),
        "expected": dict(sc.expected),
        "segments": {c: [_tel_row(*row) for row in rows]
                     for c, rows in runs.items()},
        "drift_recall_pinned": recall,
        "gates": gates,
        "gates_pass": all(gates.values()),
        "correctness_pass": all(v for k, v in gates.items()
                                if k not in THROUGHPUT_GATES),
        "throughput_gates": tput,
    }


def main(argv=None, runs: dict = None) -> int:
    """``runs``, if given, receives each scenario's per-configuration rows
    (name -> config -> rows)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--quick", action="store_true",
                      help="CI smoke: nominal segment lengths (default)")
    mode.add_argument("--full", action="store_true",
                      help="production-length replay (x25 segments)")
    ap.add_argument("--scenario", choices=scenarios.names(),
                    help="run one scenario only")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="extra event-volume multiplier on the nominal")
    ap.add_argument("--chunks-scale", type=float, default=None,
                    help="segment-length multiplier (overrides mode)")
    ap.add_argument("--no-superchunk", action="store_true",
                    help="skip the adaptive superchunk=8 sweep point")
    ap.add_argument("--passes", type=int, default=2,
                    help="timed passes after the warm one (best wall kept)")
    ap.add_argument("--no-gate", action="store_true",
                    help="record a missed throughput gate without failing "
                         "(a correctness gate always fails)")
    ap.add_argument("--json", default="BENCH_torch_scenarios.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    chunks_scale = args.chunks_scale
    if chunks_scale is None:
        chunks_scale = 25.0 if args.full else 1.0

    names = [args.scenario] if args.scenario else scenarios.names()
    payload = {
        "schema": SCHEMA,
        "mode": "full" if args.full else "quick",
        "seed": args.seed, "rate": args.rate, "chunks_scale": chunks_scale,
        "passes": args.passes,
        "device": device_block(device),
        "scenarios": {},
    }
    for name in names:
        sc = scenarios.get(name)
        print(f"== {name} (K={sc.partitions}, nominal rate "
              f"{sc.rate_scale}x, chunks x{chunks_scale:g})", flush=True)
        res = run_scenario(sc, seed=args.seed, rate=args.rate,
                           chunks_scale=chunks_scale,
                           superchunk=not args.no_superchunk, device=device,
                           passes=args.passes,
                           runs=None if runs is None
                           else runs.setdefault(name, {}))
        payload["scenarios"][name] = res
        for config, rows in res["segments"].items():
            for r in rows:
                if r["gate"] == "drift":
                    print(f"   {config:12s} {r['segment']:9s} "
                          f"ev={r['events']:7d} m={r['matches']:6d} "
                          f"rp={r['replans']:2d} wall={r['wall_s']:8.2f}s "
                          f"tput={r['tput_evps']:9.1f} ev/s", flush=True)
        verdict = "PASS" if res["gates_pass"] else "FAIL"
        print(f"   gates: {verdict}  "
              + " ".join(f"{k}={'Y' if v else 'N'}"
                         for k, v in res["gates"].items()),
              flush=True)

    payload["events_total"] = sum(
        r["events"] for r in payload["scenarios"].values())
    payload["all_gates_pass"] = all(
        r["gates_pass"] for r in payload["scenarios"].values())
    payload["all_correctness_pass"] = all(
        r["correctness_pass"] for r in payload["scenarios"].values())
    write_json(args.json, payload)
    print(f"wrote {args.json}: {payload['events_total']} events/replay, "
          f"gates {'PASS' if payload['all_gates_pass'] else 'FAIL'}")
    if not payload["all_correctness_pass"]:
        return 1
    if not payload["all_gates_pass"] and not args.no_gate:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
