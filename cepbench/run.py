"""Run one benchmark cell once and print its result as the last line.

    python3 -m cepbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of the repository.  ``--trace 0`` measures the cell's
end-to-end metrics over ``--seconds``; ``--trace 1`` runs the cell's
traced stretch under the profiler and reports its per-layer metrics.
Both check every answer against the plain reference.  The run needs a
CUDA card and fails without one; it drives ``repro_torch`` (from
``src/``) and fails if the JAX package, JAX or the JAX-side benchmarks
were loaded in its process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import repro_torch  # noqa: F401  (the system under test: fail early)
    import torch

    from cepbench.harness import find_cell, load_json, run_cell

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cepbench: needs {chips} CUDA device(s), torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    res = run_cell(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"cepbench: the run loaded {bad}", file=sys.stderr)
        return 3
    line = res["line"]
    print(json.dumps({"diagnostics": res["diag"]}), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
