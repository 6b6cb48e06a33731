"""End-to-end LM training on the PyTorch/CUDA port: a ~4M-parameter
OLMo-family model for a few hundred steps, with checkpoints and
deterministic resume.  The same code path drives the full configs: drop
--smoke and point --arch at any of the ten assigned architectures.

The twin of ``examples/train_lm.py`` through
``repro_torch.launch.train.main``.  Checkpoints go under ``CKPT_DIR``,
inside the checkout.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, "src")

from repro_torch.launch.train import main as train

CKPT_DIR = os.path.join("build", "examples", "train_lm_ckpt")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    return train([
        "--arch", "olmo-1b", "--smoke",
        "--steps", str(args.steps), "--batch", "8", "--seq", "64",
        "--lr", "3e-3", "--ckpt-dir", CKPT_DIR,
        "--ckpt-every", "100", "--log-every", "20",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
