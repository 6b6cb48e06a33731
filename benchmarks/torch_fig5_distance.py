"""Figure 5 on the PyTorch/CUDA port: throughput of the invariant method
vs the distance ``d``.

The twin of ``benchmarks/fig5_distance.py``.  For each (dataset ×
algorithm) it sweeps d in [0, 0.5] over the sequence pattern set and
locates the d with the highest throughput, d_opt, per size.  Output: CSV
rows, and a JSON of the located d_opt per "dataset/algo/size" (read by
``torch_fig69_methods.py`` and ``torch_table1_davg.py``) with the rows and
the ``device`` block beside it.

    PYTHONPATH=src python -m benchmarks.torch_fig5_distance [--quick] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from .torch_common import (HEADER, check_device, device_block, run_one,
                           warm_up, write_json)

D_GRID = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5]
COMBOS = [(ds, al) for ds in ("traffic", "stocks")
          for al in ("greedy", "zstream")]
QUICK_COMBOS = [("traffic", "greedy"), ("stocks", "greedy")]


def sweep(combos, sizes, grid, n_chunks, device):
    """Every (combo, size, d) run; returns (rows, d_opt)."""
    rows, d_opt = [], {}
    for dataset, algo in combos:
        best = {}
        for size in sizes:
            for d in grid:
                r = run_one(dataset, algo, "seq", size, "invariant", d=d,
                            n_chunks=n_chunks, device=device)
                rows.append(r)
                print(r.row(), flush=True)
                key = (dataset, algo, size)
                if key not in best or r.throughput > best[key][1]:
                    best[key] = (d, r.throughput)
        for (ds, al, size), (d, _) in best.items():
            d_opt[f"{ds}/{al}/{size}"] = d
    return rows, d_opt


def main(argv=None, quick: bool = False):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="results/torch_fig5.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=None,
                    help="comma list of sizes (default: per mode)")
    ap.add_argument("--chunks", type=int, default=None,
                    help="chunks per run (default: per mode)")
    args = ap.parse_args(argv)
    quick = quick or args.quick
    device = check_device(args.device)

    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes else
             [4] if quick else [3, 4, 5, 6, 7, 8])
    grid = D_GRID if not quick else [0.0, 0.2, 0.4]
    n_chunks = args.chunks or (60 if quick else 120)
    combos = QUICK_COMBOS if quick else COMBOS

    warm_up(device)
    print(HEADER)
    rows, d_opt = sweep(combos, sizes, grid, n_chunks, device)
    write_json(args.out, {**d_opt, "device": device_block(device),
                          "n_chunks": n_chunks,
                          "rows": [r.__dict__ for r in rows]})
    print("# d_opt:", d_opt)
    return d_opt


if __name__ == "__main__":
    main()
