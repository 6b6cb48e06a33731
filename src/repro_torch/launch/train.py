"""Training launcher.

The port of ``repro.launch.train``: the same arguments, printed lines and
``"done"``, plus ``--device`` (``cuda`` unless asked; without a GPU it
raises).  Weights are random, drawn from ``--seed`` on the device's
generator; ``main`` returns ``(model, opt_state)``.  Features:

* deterministic restart: data is a pure function of (seed, step); resuming
  from a checkpoint replays the exact same batch sequence;
* fault tolerance: atomic async checkpoints every ``--ckpt-every`` steps,
  ``--resume`` restores params + optimizer state and continues from its
  step;
* adaptive MoE expert placement: for MoE archs the invariant governor
  watches per-expert loads and triggers weight re-permutation only on
  invariant violation (the paper's technique in the training loop); the
  optimizer's moments (and master copy) move with their weights.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 20 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b \\
      --smoke --device cpu --steps 50 --ckpt-dir build/ck --resume \\
      --adaptive-placement
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..adaptive.placement import (ExpertPlacementGovernor,
                                  permute_expert_params, relocation)
from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke
from ..core.engine import resolve_device
from ..data.lm_data import DataConfig, make_batch
from ..models.model import Model
from ..train.optimizer import AdamWConfig, init_state
from ..train.train_step import batch_to, make_train_step

MOVED = ("w_gate", "w_up", "w_down", "router")


def relocate_experts(model: Model, opt_state, rel) -> None:
    """Move every MoE layer's experts (weights, router columns, and their
    optimizer moments and master copy) by the relocation ``rel``, in
    place."""
    for i, layer in enumerate(model.layers):
        permute_expert_params(layer.moe, rel)
        for tree in (opt_state.m, opt_state.v, opt_state.master):
            if tree != ():
                permute_expert_params(
                    {k: tree[f"layers.{i}.moe.{k}"] for k in MOVED}, rel)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--adaptive-placement", action="store_true",
                    help="invariant-governed MoE expert re-placement")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (get_smoke(args.arch) if args.smoke else get_config(args.arch))
    if cfg.ssm_chunk > args.seq:
        cfg = cfg.with_(ssm_chunk=max(8, args.seq // 4))
    device = resolve_device(args.device)
    model = Model(cfg, device, remat=args.remat).init(
        torch.Generator(device=device).manual_seed(args.seed))
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    dcfg = DataConfig(batch=args.batch, seq=args.seq, seed=args.seed)

    params = dict(model.named_parameters())
    opt_state = init_state(opt_cfg, params)
    start = 0

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        saved, opt_state = ckpt.restore((params, opt_state), device=device)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(saved[name])
        start = int(opt_state.step)
        print(f"resumed from step {start}")

    step_fn = make_train_step(model, opt_cfg)

    governor = None
    cur_perm = np.arange(cfg.n_experts) if cfg.family == "moe" else None
    if args.adaptive_placement and cfg.family == "moe":
        n_groups = max(torch.cuda.device_count()
                       if device.type == "cuda" else 1, 2)
        while cfg.n_experts % n_groups:
            n_groups -= 1
        governor = ExpertPlacementGovernor(cfg.n_experts,
                                           n_groups=n_groups)

    t0 = time.time()
    for step in range(start, args.steps):
        batch = batch_to(make_batch(cfg, dcfg, step), device)
        model, opt_state, metrics = step_fn(model, opt_state, batch)

        if governor is not None and "expert_load" in metrics:
            phys_loads = metrics["expert_load"].cpu().numpy().sum(axis=0)
            # Governor reasons about *logical* experts; loads arrive per
            # physical slot: logical e currently lives at cur_perm[e].
            logical_loads = phys_loads[cur_perm]
            new_placement = governor.observe(logical_loads)
            if new_placement is not None and step > start:
                # Deployment: physically relocate expert weights (+router
                # columns); optimizer moments travel with their weights.
                relocate_experts(model, opt_state,
                                 relocation(cur_perm, new_placement.perm))
                cur_perm = np.asarray(new_placement.perm)
                print(f"step {step}: expert re-placement deployed "
                      f"(replans={governor.replans})")

        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['ce']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0):.1f}s)")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, (params, opt_state))
    if ckpt:
        ckpt.wait()
        ckpt.save(args.steps, (params, opt_state))
    print("done")
    return model, opt_state


if __name__ == "__main__":
    main()
