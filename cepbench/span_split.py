"""Where the device waits on the host, one level below the per-layer
readers: one traced stretch of a cell, its idle device time split by the
program span the host was in (the innermost one), and the idle time under
each top-level host operation split the same way.

    python3 -m cepbench.span_split --workload <name> --seed <n> \
        [--out build/span_split]

from the root of the repository, on a CUDA card.  The cell runs as
``cepbench.run --trace 1`` runs it (its readers install the program's
recorder, ``cepbench/spans.py``); the script writes
``<out>/span_split_<cell>_<seed>.json`` and prints the result line and
the two splits.  ``outside`` is time in no program span (the harness's
own loop); a span's own time is its time less its children's.
"""

import argparse
import json
import os
import sys
from bisect import bisect_right
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUTSIDE = "outside"


def leaf_segments(spans, t0_ns: int, start_us: float, end_us: float):
    """``[start_us, end_us]`` cut into ``(a, b, name)`` pieces, each
    labelled by the innermost span open over it (``OUTSIDE`` where none
    is); spans go onto the profile's microseconds through ``t0_ns``, the
    profile's ``trace_start_ns``."""
    marks = []
    for i, s in enumerate(spans):
        marks.append(((s.start_ns - t0_ns) / 1e3, 1, i))
        marks.append(((s.end_ns - t0_ns) / 1e3, 0, i))
    marks.sort()
    stack, segs, last = [], [], start_us
    for t, opens, i in marks:
        t = min(max(t, start_us), end_us)
        if t > last:
            segs.append((last, t, spans[stack[-1]].name if stack
                         else OUTSIDE))
            last = t
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    if end_us > last:
        segs.append((last, end_us, OUTSIDE))
    return segs


def idle_gaps(busy, start_us: float, end_us: float):
    """The complement of the merged ``busy`` intervals in the stretch."""
    gaps, t = [], start_us
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if end_us > t:
        gaps.append((t, end_us))
    return gaps


def _label_at(segs, starts, t: float) -> str:
    k = bisect_right(starts, t) - 1
    return segs[k][2] if k >= 0 and t < segs[k][1] else OUTSIDE


def split(spans, t0_ns: int, trace) -> dict:
    """Seconds of the traced stretch by innermost span (``wall_s``), of
    its idle device time by innermost span (``idle_s``), and of the idle
    time under each top-level host op by op and span (``op_idle_s``, rows
    ``[op, span, s]``), largest first.  ``trace`` gives ``start_us``,
    ``end_us``, ``busy_intervals()`` and ``_host`` (the top-level host
    ops, as ``(name, start_us, end_us)``), as ``cepbench.trace.Trace``."""
    w0, w1 = trace.start_us, trace.end_us
    segs = leaf_segments(spans, t0_ns, w0, w1)
    starts = [a for a, _, _ in segs]
    gaps = idle_gaps(trace.busy_intervals(), w0, w1)
    wall, idle = defaultdict(float), defaultdict(float)
    for a, b, name in segs:
        wall[name] += (b - a) / 1e6
    k = 0
    for g0, g1 in gaps:
        while k < len(segs) and segs[k][1] <= g0:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < g1:
            a, b, name = segs[j]
            idle[name] += (min(b, g1) - max(a, g0)) / 1e6
            j += 1
    op_idle = defaultdict(float)
    host = sorted(trace._host, key=lambda h: h[1])
    first = 0
    for g0, g1 in gaps:
        while first < len(host) and host[first][2] <= g0:
            first += 1
        for name, a, b in host[first:]:
            if a >= g1:
                break
            lo, hi = max(a, g0), min(b, g1)
            if hi > lo:
                op_idle[(name, _label_at(segs, starts, (lo + hi) / 2))] += \
                    (hi - lo) / 1e6

    def ranked(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))
    return {"wall_s": ranked(wall), "idle_s": ranked(idle),
            "op_idle_s": sorted(([op, sp, s] for (op, sp), s in
                                 op_idle.items()), key=lambda r: -r[2])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="build/span_split")
    args = ap.parse_args(argv)

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from cepbench import harness
    from cepbench.spans import KEY

    if not torch.cuda.is_available():
        print("cepbench.span_split: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    kept = {}
    inner = harness._traced_stretch

    def keep(cell, drv, session, cuda):
        kept["run"], kept["wall"] = inner(cell, drv, session, cuda)
        return kept["run"], kept["wall"]

    harness._traced_stretch = keep
    try:
        bench = harness.load_json(ROOT / "BENCHMARK.json")
        res = harness.run_cell(harness.find_cell(bench, args.workload),
                               seed=args.seed, seconds=1.0, trace=True)
    finally:
        harness._traced_stretch = inner
    run = kept["run"]
    st = run.hooks.get(KEY)
    if not st or not st["spans"] or st["trace_start_ns"] is None:
        print("cepbench.span_split: the program recorded no span",
              file=sys.stderr)
        return 3
    out = {"cell": args.workload, "seed": args.seed, "chunks": run.chunks,
           "traced_s": kept["wall"], "window_s": run.trace.window_s,
           "busy_s": run.trace.busy_s, "spans": len(st["spans"]),
           "dropped_spans": st["dropped"], "line": res["line"],
           **split(st["spans"], st["trace_start_ns"], run.trace)}
    path = Path(args.out) / f"span_split_{args.workload}_{args.seed}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(res["line"]))
    print("idle s by span", json.dumps(out["idle_s"]))
    print("idle s by op and span", json.dumps(out["op_idle_s"][:20]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
