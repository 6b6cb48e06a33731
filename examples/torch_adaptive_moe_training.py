"""The paper's technique as a framework feature, on the PyTorch/CUDA
port: train a (reduced) DeepSeekMoE model with the invariant-governed
expert-placement governor watching per-expert routing loads —
re-placement triggers only on invariant violation.

The twin of ``examples/adaptive_moe_training.py`` through
``repro_torch.launch.train.main``.

    PYTHONPATH=src python examples/torch_adaptive_moe_training.py [--device cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch.train import main as train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    return train([
        "--arch", "deepseek-moe-16b", "--smoke",
        "--steps", str(args.steps), "--batch", "8", "--seq", "64",
        "--adaptive-placement", "--log-every", "10",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
