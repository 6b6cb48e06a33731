"""The control of the output check: the reference computed in bfloat16, in
the program's place, must come out as not correct.

    python3 -m cepbench.control --workload <name> --seeds 1 2 3 \
        [--steps N] [--device cuda]

For each seed it draws the cell's pool, computes the answers of the first
``N`` replay steps (by default two pool cycles) with the exact reference
and with the reference in bfloat16 (timestamps, attributes and every
comparison; the nearest precision below the configuration's float32), and
prints how many chunks the bfloat16 answers get wrong: the number the
run's ``mismatched_chunks`` check compares, whose limit is 0.  The
benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_readings(cell, seeds, steps=None, device="cuda"):
    """``[{seed, steps, mismatched_chunks, mismatched_counts}]``."""
    from cepbench.harness import compare, expected_answers
    from cepbench.pool import make_pool

    plain = cell.plain_pattern()
    out = []
    for seed in seeds:
        pool = make_pool(cell.config, int(cell.traffic["pool_chunks"]), seed)
        n = steps or 2 * pool.chunks
        exact = expected_answers(cell, plain, pool, n, device)
        low = expected_answers(cell, plain, pool, n, device, "bfloat16")
        out.append({"seed": seed, "steps": n,
                    "mismatched_chunks": int(compare(low, exact).sum()),
                    "mismatched_counts": int((low != exact).sum()),
                    "matches": int(exact.sum())})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from cepbench.harness import find_cell, load_json

    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    t = time.perf_counter()
    for r in control_readings(cell, args.seeds, args.steps, args.device):
        print(json.dumps({"workload": args.workload, **r}))
    print(f"control seconds {time.perf_counter() - t:.3f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
