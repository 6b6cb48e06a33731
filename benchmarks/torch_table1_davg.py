"""Table 1 on the PyTorch/CUDA port: quality of the average-relative-
difference estimate d_avg (§3.4 approach 2) vs the empirically optimal
d_opt from the Figure-5 sweep: min(d_avg/d_opt, d_opt/d_avg) per
(dataset × algo × size).

The twin of ``benchmarks/table1_davg.py``; reads d_opt from
``torch_fig5_distance.py``'s output (``--d-opt``, 0.2 where it has none)
and writes the table with the ``device`` block to ``--out``.

    PYTHONPATH=src python -m benchmarks.torch_table1_davg [--quick] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.core import AdaptiveRunner, EngineConfig
from repro_torch.core.decision import InvariantPolicy
from repro_torch.data.cep_streams import StreamConfig, make_stream

from .torch_common import (B_CAP, CHUNK_CAP, M_CAP, build_pattern,
                           check_device, device_block, sync, write_json)

COMBOS = [(ds, al) for ds in ("traffic", "stocks")
          for al in ("greedy", "zstream")]


def measure_d_avg(dataset: str, algo: str, size: int,
                  n_chunks: int = 60, device: str = "cuda") -> float:
    pat = build_pattern("seq", size)
    pol = InvariantPolicy(k=1, d_mode="avg")
    runner = AdaptiveRunner(
        pat, planner=algo, policy=pol,
        engine_cfg=EngineConfig(b_cap=B_CAP, m_cap=M_CAP, device=device),
        adaptive_caps=True)
    scfg = StreamConfig(n_types=size, n_attrs=1, n_chunks=n_chunks,
                        chunk_cap=CHUNK_CAP, base_rate=15.0, seed=3)
    runner.run(make_stream(dataset, scfg))
    sync(device)
    return float(getattr(pol, "d_estimated", 0.0))


def quality(d_avg: float, d_opt: float) -> float:
    if d_avg <= 0 or d_opt <= 0:
        return 0.0
    return min(d_avg / d_opt, d_opt / d_avg)


def main(argv=None, quick: bool = False):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--d-opt", default="results/torch_fig5.json")
    ap.add_argument("--out", default="results/torch_table1.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=None,
                    help="comma list of sizes (default: per mode)")
    ap.add_argument("--chunks", type=int, default=60,
                    help="chunks per d_avg run")
    args = ap.parse_args(argv)
    quick = quick or args.quick
    device = check_device(args.device)

    d_opt = {}
    if os.path.exists(args.d_opt):
        with open(args.d_opt) as f:
            d_opt = json.load(f)

    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes else
             [4] if quick else [4, 5, 6, 7, 8])
    combos = [("traffic", "greedy")] if quick else COMBOS
    print("dataset,algo,size,d_avg,d_opt,quality")
    rows = []
    for dataset, algo in combos:
        for size in sizes:
            davg = measure_d_avg(dataset, algo, size, args.chunks, device)
            dopt = d_opt.get(f"{dataset}/{algo}/{size}", 0.2)
            q = quality(davg, dopt)
            rows.append({"dataset": dataset, "algo": algo, "size": size,
                         "d_avg": davg, "d_opt": dopt, "quality": q})
            print(f"{dataset},{algo},{size},{davg:.4f},{dopt:.4f},{q:.3f}",
                  flush=True)
    write_json(args.out, {"device": device_block(device),
                          "n_chunks": args.chunks, "rows": rows})
    return rows


if __name__ == "__main__":
    main()
