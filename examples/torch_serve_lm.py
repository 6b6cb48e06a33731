"""Batched LM serving on the PyTorch/CUDA port with the invariant-governed
adaptive batch planner: requests in three prompt-length classes,
continuous batching over a fixed slot pool, prefill bucketing.

The twin of ``examples/serve_lm.py`` through
``repro_torch.launch.serve.main``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch.serve import main as serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve(["--arch", "olmo-1b", "--smoke", "--requests", "16",
                  "--slots", "4", "--cache-len", "256", "--max-new", "12",
                  "--device", args.device])


if __name__ == "__main__":
    main()
