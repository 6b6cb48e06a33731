"""Benchmark aggregator of the PyTorch/CUDA port: one twin per paper
table/figure + the framework-level benchmarks.

The twin of ``benchmarks/run.py``.  Default mode is ``--quick`` scale;
``--full`` runs the complete grids.  ``--device`` (default ``cuda``;
``cpu`` runs the plain kernel versions) is passed to every twin,
``--no-gate`` to the twins with throughput gates (kernel, fleet,
rulebook): they then record a missed gate without failing, while a
correctness gate still fails its section.  ``--out-dir`` puts every
twin's JSON in one directory (fig69 and table1 then read fig5's d_opt
from there).  ``--only`` takes the keys below; an unknown key raises
instead of running nothing.

  PYTHONPATH=src python -m benchmarks.torch_run [--full] [--only fig5,...]
      [--device cuda|cpu] [--no-gate] [--out-dir DIR]
  PYTHONPATH=src python -m benchmarks.torch_run --summary
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

KEYS = ("fig5", "table1", "fig69", "kernel", "fleet", "rulebook", "moe",
        "roofline")


def _headline_rows(d) -> list:
    """Headline ``(metric, display, numeric|None)`` rows for one artifact
    (every access defensive: a partial document still renders)."""
    rows = []
    if not isinstance(d, dict):
        return [("(malformed artifact)", "-", None)]
    schema = str(d.get("schema", "?"))
    if schema.startswith("kernel_bench"):
        best = {}
        for r in d.get("rows", []) or []:
            s = r.get("speedup_vs_baseline") if isinstance(r, dict) else None
            if isinstance(s, (int, float)):
                cfg = r.get("config", "?")
                best[cfg] = max(best.get(cfg, 0.0), float(s))
        for cfg, s in sorted(best.items()):
            rows.append((f"{cfg} speedup vs baseline", f"{s:.2f}x", s))
        for r in d.get("rows", []) or []:
            if isinstance(r, dict) and r.get("graph_ms") is not None \
                    and str(r.get("shape", "")).startswith("K"):
                ms = float(r["graph_ms"])
                rows.append((f"{r.get('config')} graph ms", f"{ms:.4f}",
                             ms))
    elif schema.startswith("fleet_bench"):
        by_k = {}
        for r in d.get("rows", []) or []:
            if isinstance(r, dict) and "k" in r:
                by_k.setdefault(r["k"], {})[r.get("config")] = r
        for k, cfgs in sorted(by_k.items()):
            base = cfgs.get("baseline")
            vm = cfgs.get("vmapped")
            if base and vm and "seconds" in base and "seconds" in vm:
                s = base["seconds"] / max(vm["seconds"], 1e-9)
                rows.append((f"k={k} batched speedup", f"{s:.2f}x", s))
        sc = d.get("superchunk") or {}
        if sc:
            for key, label in (("speedup_scanned", "superchunk"),
                               ("speedup_sharded", "meshed")):
                s = sc.get(key)
                if isinstance(s, (int, float)):
                    rows.append((f"k={sc.get('k')} {label} speedup",
                                 f"{s:.2f}x", float(s)))
    elif schema.startswith("scenarios"):
        for name, s in sorted((d.get("scenarios") or {}).items()):
            ev = s.get("events", "?") if isinstance(s, dict) else "?"
            num = float(ev) if isinstance(ev, (int, float)) else None
            rows.append((f"{name} events", str(ev), num))
        rows.append(("all gates pass", str(d.get("all_gates_pass")), None))
    elif schema.startswith("rulebook_bench"):
        for s in d.get("summaries", []) or []:
            if not isinstance(s, dict) or "q" not in s:
                continue
            q = s["q"]
            sp = s.get("speedup")
            if isinstance(sp, (int, float)):
                rows.append((f"q={q} rulebook vs session loop",
                             f"{sp:.2f}x", float(sp)))
            sc = s.get("superchunk_speedup")
            if isinstance(sc, (int, float)):
                rows.append((f"q={q} superchunk vs per-chunk",
                             f"{sc:.2f}x", float(sc)))
            sh = s.get("sharing_ratio")
            if isinstance(sh, (int, float)):
                rows.append((f"q={q} sharing ratio", f"{sh:.2f}", float(sh)))
        hot = d.get("hot_add") or {}
        if ("hot_add_s" in hot) and ("cold_compile_s" in hot):
            rows.append(("hot-add latency / cold open",
                         f"{hot['hot_add_s']:.2f}s/"
                         f"{hot['cold_compile_s']:.1f}s", None))
        if "captures" in hot:
            rows.append(("hot-add captures", str(hot["captures"]), None))
    else:
        rows.append((f"(unrecognized schema {schema})", "-", None))
    gates = d.get("gates") if schema != "scenarios/v1" else None
    if isinstance(gates, dict):
        for name, g in sorted(gates.items()):
            if isinstance(g, dict) and "met" in g:
                rows.append((f"gate {name}",
                             "met" if g["met"] else "NOT MET", None))
    return rows


def _committed_artifact(fname: str, root: str):
    """The HEAD-committed version of a BENCH file, or None if unreadable."""
    try:
        blob = subprocess.run(
            ["git", "show", f"HEAD:{fname}"], cwd=root,
            capture_output=True, timeout=30)
        if blob.returncode != 0:
            return None
        return json.loads(blob.stdout.decode("utf-8"))
    except Exception:  # noqa: BLE001 - deltas are best-effort decoration
        return None


def summarize(root: str = ".") -> None:
    """One trajectory table over every BENCH_torch_*.json, with the
    movement against the HEAD-committed version of each."""
    files = sorted(f for f in os.listdir(root)
                   if f.startswith("BENCH_torch_") and f.endswith(".json"))
    if not files:
        print("no BENCH_torch_*.json artifacts found")
        return
    print(f"{'artifact':<22} {'metric':<38} {'value':>12} {'vs HEAD':>10}")
    print("-" * 85)

    def row(art, metric, value, delta=""):
        print(f"{art:<22} {metric:<38} {value:>12} {delta:>10}")

    for fname in files:
        art = fname[len("BENCH_torch_"):-len(".json")]
        try:
            with open(os.path.join(root, fname)) as fh:
                d = json.load(fh)
        except Exception as e:  # noqa: BLE001 - keep the table rendering
            row(art, f"(unreadable: {type(e).__name__})", "-")
            continue
        prev = _committed_artifact(fname, root)
        prev_num = {m: n for m, _, n in _headline_rows(prev)
                    if n is not None} if prev is not None else {}
        headline = _headline_rows(d) or [("(no headline metrics)", "-", None)]
        for metric, display, num in headline:
            delta = ""
            if num is not None and metric in prev_num:
                diff = num - prev_num[metric]
                if abs(diff) >= 0.005:
                    delta = f"{diff:+.2f}"
            row(art, metric, display, delta)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    scale = ap.add_mutually_exclusive_group()
    scale.add_argument("--full", action="store_true")
    scale.add_argument("--quick", action="store_true",
                       help="bounded scale — the default; conflicts with "
                            "--full")
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(KEYS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-gate", action="store_true",
                    help="record missed throughput gates without failing")
    ap.add_argument("--out-dir", default=None,
                    help="write every twin's JSON into this directory "
                         "(default: each twin's own path)")
    ap.add_argument("--summary", action="store_true",
                    help="print one trajectory table aggregated from the "
                         "BENCH_torch_*.json artifacts and exit")
    args = ap.parse_args(argv)
    if args.summary:
        summarize()
        return 0
    quick = not args.full
    only = set(args.only.split(",")) if args.only else None
    unknown = sorted((only or set()) - set(KEYS))
    if unknown:
        raise ValueError(f"--only: unknown key(s) {unknown}; the keys are "
                         f"{','.join(KEYS)}")

    from . import (torch_adaptive_moe, torch_fig5_distance,
                   torch_fig69_methods, torch_fleet_bench,
                   torch_kernel_bench, torch_roofline, torch_rulebook_bench,
                   torch_table1_davg)
    from .torch_common import check_device

    check_device(args.device)
    dev = ["--device", args.device]
    gated = dev + (["--no-gate"] if args.no_gate else [])
    scale_flag = [] if quick else ["--full"]

    def out(flag, name):
        if args.out_dir is None:
            return []
        return [flag, os.path.join(args.out_dir, name)]

    d_opt = out("--d-opt", "torch_fig5.json")
    sections = [
        ("fig5", "Figure 5 — throughput vs invariant distance d",
         lambda: torch_fig5_distance.main(
             dev + out("--out", "torch_fig5.json"), quick=quick)),
        ("table1", "Table 1 — d_avg estimate quality",
         lambda: torch_table1_davg.main(
             dev + d_opt + out("--out", "torch_table1.json"), quick=quick)),
        ("fig69", "Figures 6-9 — adaptation method comparison",
         lambda: torch_fig69_methods.main(
             dev + d_opt + out("--out", "torch_fig69.json"), quick=quick)),
        ("kernel", "join kernel microbenchmark (device-timed)",
         lambda: torch_kernel_bench.main(
             gated + scale_flag + out("--json", "BENCH_torch_kernel.json"),
             quick=quick)),
        ("fleet", "fleet executor — K-batched step vs per-partition loop",
         lambda: torch_fleet_bench.main(
             gated + scale_flag + out("--json", "BENCH_torch_fleet.json"),
             quick=quick)),
        ("rulebook", "rulebook — Q patterns on one data plane",
         lambda: torch_rulebook_bench.main(
             gated + scale_flag + out("--json", "BENCH_torch_rulebook.json"),
             quick=quick)),
        ("moe", "adaptive MoE expert placement",
         lambda: torch_adaptive_moe.main(
             dev + out("--out", "torch_adaptive_moe.json"), quick=quick)),
        ("roofline", "roofline table from the port's dry-run records",
         lambda: torch_roofline.main([])),
    ]
    failed = []
    for key, title, fn in sections:
        if only and key not in only:
            continue
        print(f"\n===== {title} =====", flush=True)
        t0 = time.time()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - keep the suite running
            failed.append(key)
            print(f"!! {key} failed: {type(e).__name__}: {e}")
            traceback.print_exc(file=sys.stdout)
        print(f"===== {key} done in {time.time() - t0:.1f}s =====",
              flush=True)
    if failed:
        # Every selected section ran, but a red section fails the run.
        print(f"\n!! failed sections: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
