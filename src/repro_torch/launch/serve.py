"""Serving launcher: batched prefill/decode with the adaptive scheduler.

The port of ``repro.launch.serve``: the same arguments and printed line,
plus ``--device`` (``cuda`` unless asked; without a GPU it raises).
Weights are random, drawn from ``--seed`` on the device's generator.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --smoke --device cpu --requests 24 --slots 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke
from ..core.engine import resolve_device
from ..models.model import Model
from ..serving.engine import ServingEngine
from ..serving.scheduler import Request, Scheduler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (get_smoke(args.arch) if args.smoke else get_config(args.arch))
    device = resolve_device(args.device)
    model = Model(cfg, device).init(
        torch.Generator(device=device).manual_seed(args.seed))
    engine = ServingEngine(cfg, model, batch_slots=args.slots,
                           cache_len=args.cache_len, device=device)
    classes = [16, 32, 64]
    sched = Scheduler(engine, classes)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.choice(classes, p=[0.6, 0.3, 0.1]))
        prompt = rng.integers(0, cfg.vocab, plen).astype(np.int32)
        sched.submit(Request(rid=rid, prompt=prompt,
                             max_new=args.max_new))

    t0 = time.time()
    ticks = 0
    while sched.pending or any(s is not None for s in sched.slots):
        sched.tick()
        ticks += 1
        if ticks > 10000:
            raise RuntimeError("scheduler did not drain")
    dt = time.time() - t0
    toks = sum(len(r.out) for r in sched.completed)
    print(f"served {len(sched.completed)} requests, {toks} tokens in "
          f"{dt:.1f}s ({toks/dt:.1f} tok/s); "
          f"batch replans={sched.planner.replans} "
          f"deployments={sched.planner.deployments}")
    return sched


if __name__ == "__main__":
    main()
