"""Roofline table of the PyTorch/CUDA port: aggregate the port's dry-run
records (``python -m repro_torch.launch.dryrun --out ...``) into the
per-cell three-term analysis under H100 terms.

The twin of ``benchmarks/roofline.py``.  Reads
``<dir>/torch_dryrun_single_*.json`` (and ``torch_dryrun_multi_*`` for
the multi-pod pass's status) and prints a markdown table: per (arch x
shape) the compute / memory / collective seconds, the dominant term,
MODEL_FLOPS over the counted FLOPs, per-rank memory, whether it fits one
H100's 80 GB, and what would move the dominant term.  The records are
analytic: counts of the step on ``meta`` tensors, not timings.

    PYTHONPATH=src python -m benchmarks.torch_roofline --dir results
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS_F32

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def join_roofline(C: int, M: int, B: int, sec: float) -> dict:
    """Three-term (compute / memory / collective) model of one packed
    windowed cross-join, as the reference's: reads ``C(M+B)`` f32 operand
    strips, ``C`` int8 ops + ``C`` f32 thetas + ``M+B`` int8 validity,
    writes the ``MB`` int8 mask; ~5 ops per (c, m, b) cell; no collective
    bytes (partitions are independent).  The peaks are the H100's HBM
    rate and f32 rate of ``repro_torch.launch.dryrun``."""
    bytes_moved = 4 * C * (M + B) + C + 4 * C + (M + B) + M * B
    flops = 5 * C * M * B
    compute_s = flops / PEAK_FLOPS_F32
    memory_s = bytes_moved / HBM_BW
    collective_s = 0.0
    dominant = "compute" if compute_s >= memory_s else "memory"
    roof_s = max(compute_s, memory_s)
    return {
        "shape": f"C{C}_M{M}_B{B}",
        "platform": "h100",
        "bytes": bytes_moved,
        "flops": flops,
        "intensity_flops_per_byte": round(flops / bytes_moved, 2),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "achieved_gbytes_s": bytes_moved / max(sec, 1e-12) / 1e9,
        "achieved_gflops_s": flops / max(sec, 1e-12) / 1e9,
        "peak_gbytes_s": HBM_BW / 1e9,
        "peak_gflops_s": PEAK_FLOPS_F32 / 1e9,
        "fraction_of_roof": round(roof_s / max(sec, 1e-12), 4),
        "seconds": sec,
    }


def load(pattern: str) -> List[dict]:
    out = []
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            out.extend(json.load(f))
    return out


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def note_for(rec: dict) -> str:
    dom = rec["dominant"]
    if dom == "compute":
        return ("raise tensor-core utilization: larger GEMMs per rank / "
                "reduce remat recompute")
    if dom == "memory":
        return ("cut HBM traffic: fuse the eager elementwise chains, "
                "reuse activations")
    return ("cut collective bytes: reshard to reduce all-gathers / "
            "overlap with compute / compress")


def gib(rec: dict) -> float:
    mem = rec.get("memory", {})
    return (mem.get("argument_size_in_bytes", 0)
            + mem.get("temp_size_in_bytes", 0)
            - mem.get("alias_size_in_bytes", 0)) / 2**30


def table(records: List[dict], multi: Dict[str, str]) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL/FLOPs | GiB/rank | fits | multi-pod | what would move the "
        "dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in records:
        if rec["status"] == "skipped":
            lines.append(
                f"| {rec['arch']} | {rec['shape']} | — | — | — | — | — "
                f"| — | — | — | SKIP: {rec['reason'][:60]}… |")
            continue
        if rec["status"] == "error":
            lines.append(
                f"| {rec['arch']} | {rec['shape']} | ERR | | | | | | | | "
                f"{rec['error'][:80]} |")
            continue
        mp = multi.get(f"{rec['arch']}/{rec['shape']}", "?")
        if rec.get("rolled"):
            lines.append(
                f"| {rec['arch']} | {rec['shape']} | — | — | — | — | — "
                f"| {gib(rec):.1f} | {rec['fits']} | {mp} | rolled record |")
            continue
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | "
            f"{fmt_s(rec['compute_s'])} | {fmt_s(rec['memory_s'])} | "
            f"{fmt_s(rec['collective_s'])} | **{rec['dominant']}** | "
            f"{rec['useful_flops_ratio']:.2f} | {gib(rec):.1f} | "
            f"{rec['fits']} | {mp} | {note_for(rec)} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results")
    args = ap.parse_args(argv)

    single = load(os.path.join(args.dir, "torch_dryrun_single_*.json"))
    multi_recs = load(os.path.join(args.dir, "torch_dryrun_multi_*.json"))
    multi = {}
    for r in multi_recs:
        key = f"{r['arch']}/{r['shape']}"
        multi[key] = ("ok" if r["status"] == "ok" else
                      "skip" if r["status"] == "skipped" else "ERR")

    order = {(a, s): (i, SHAPE_ORDER.index(s) if s in SHAPE_ORDER else 9)
             for i, a in enumerate(sorted({r["arch"] for r in single}))
             for s in SHAPE_ORDER}
    single.sort(key=lambda r: order.get((r["arch"], r["shape"]),
                                        (99, 99)))
    print(table(single, multi))
    ok = [r for r in single if r["status"] == "ok" and not r.get("rolled")]
    if ok:
        print(f"\n# cells ok={len(ok)} "
              f"skipped={sum(r['status'] == 'skipped' for r in single)} "
              f"error={sum(r['status'] == 'error' for r in single)} "
              f"fit={sum(r['fits'] for r in ok)}")
        worst = sorted(
            ok, key=lambda r: r["model_flops"]
            / max(r["hlo_flops"] * r["n_chips"], 1)
        )[:3]
        print("# worst useful-flops cells:",
              [(r["arch"], r["shape"],
                round(r["useful_flops_ratio"], 3)) for r in worst])
        collbound = [r for r in ok if r["dominant"] == "collective"]
        print("# collective-bound cells:",
              [(r["arch"], r["shape"]) for r in collbound])


if __name__ == "__main__":
    main()
