"""Figures 6-9 (+ Appendix A) on the PyTorch/CUDA port: the four
adaptation methods compared per (dataset × algorithm × pattern set ×
size): throughput, gain over static, number of reoptimizations,
computational overhead, false positives.

The twin of ``benchmarks/fig69_methods.py``.  The invariant method runs
at the d_opt of ``torch_fig5_distance.py``'s output (``--d-opt``), 0.2
where it has none.

    PYTHONPATH=src python -m benchmarks.torch_fig69_methods [--quick] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from .torch_common import (HEADER, PATTERN_SETS, check_device, device_block,
                           run_one, warm_up, write_json)

METHODS = ("static", "unconditional", "threshold", "invariant")
COMBOS = [(ds, al) for ds in ("traffic", "stocks")
          for al in ("greedy", "zstream")]
QUICK_COMBOS = [("traffic", "greedy"), ("stocks", "greedy")]


def compare(combos, sets, sizes, n_chunks, d_opt, device):
    """Every (combo, set, method, size) run, as ``BenchResult`` rows."""
    rows = []
    for dataset, algo in combos:
        for set_name in sets:
            for policy in METHODS:
                for size in sizes:
                    d = d_opt.get(f"{dataset}/{algo}/{size}", 0.2)
                    r = run_one(dataset, algo, set_name, size, policy,
                                d=d, n_chunks=n_chunks, device=device)
                    rows.append(r)
                    print(r.row(), flush=True)
    return rows


def gains(rows):
    """Throughput over static per (dataset, algo, set, size) and method."""
    by = {}
    for r in rows:
        by.setdefault((r.dataset, r.algo, r.pattern_set, r.size), {})[
            r.policy] = r
    out = {}
    for key, d_ in sorted(by.items()):
        if "static" not in d_:
            continue
        s = d_["static"].throughput
        out[key] = {p: (d_[p].throughput / s if p in d_ else float("nan"))
                    for p in METHODS[1:]}
    return out


def main(argv=None, quick: bool = False):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sets", default=None,
                    help="comma list of pattern sets (default: per mode)")
    ap.add_argument("--d-opt", default="results/torch_fig5.json")
    ap.add_argument("--out", default="results/torch_fig69.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=None,
                    help="comma list of sizes (default: per mode)")
    ap.add_argument("--chunks", type=int, default=None,
                    help="chunks per run (default: per mode)")
    args = ap.parse_args(argv)
    quick = quick or args.quick
    device = check_device(args.device)

    d_opt = {}
    if os.path.exists(args.d_opt):
        with open(args.d_opt) as f:
            d_opt = json.load(f)

    sets = (args.sets.split(",") if args.sets else
            (["seq"] if quick else PATTERN_SETS))
    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes else
             [4] if quick else [3, 4, 6, 8])
    combos = QUICK_COMBOS if quick else COMBOS
    n_chunks = args.chunks or (60 if quick else 120)

    warm_up(device)
    print(HEADER)
    rows = compare(combos, sets, sizes, n_chunks, d_opt, device)

    # relative gains summary (Figures 6b-9b)
    g = gains(rows)
    print("# gain-over-static (dataset, algo, set, size): "
          "unconditional / threshold / invariant")
    for key, by_method in g.items():
        print(f"# {key}: " + " / ".join(f"{x:.2f}x"
                                        for x in by_method.values()))
    write_json(args.out, {
        "device": device_block(device), "n_chunks": n_chunks,
        "rows": [r.__dict__ for r in rows],
        "gain_over_static": [{"dataset": k[0], "algo": k[1], "set": k[2],
                              "size": k[3], **v} for k, v in g.items()]})
    return rows


if __name__ == "__main__":
    main()
