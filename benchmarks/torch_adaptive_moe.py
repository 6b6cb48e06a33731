"""Framework-level benchmark on the PyTorch port: invariant-governed MoE
expert placement vs unconditional / threshold re-placement under
drifting routing loads.

The twin of ``benchmarks/adaptive_moe.py`` over
``repro_torch.adaptive.placement``: the same loads (numpy, seed 0), the
same three policies and the same output.  The governor is host code, so
``--device`` only names the ``device`` block of the JSON (and "cuda"
without a GPU raises, as the package does).

    PYTHONPATH=src python -m benchmarks.torch_adaptive_moe [--quick] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.adaptive.placement import (ExpertPlacementGovernor,
                                            imbalance, lpt_placement)

from .torch_common import check_device, device_block, write_json

POLICIES = ("unconditional", "threshold", "invariant")


def drifting_loads(rng, e, steps, regime="traffic"):
    """Synthetic per-expert token loads with the two regimes of §5.1."""
    base = rng.uniform(1, 10, e)
    for t in range(steps):
        if regime == "traffic":
            if rng.random() < 0.02:  # rare large shift
                i, j = rng.choice(e, 2, replace=False)
                base[i], base[j] = base[j] * 4, base[i] / 4
            yield base * rng.uniform(0.95, 1.05, e)
        else:  # stocks: frequent small drift
            base *= np.exp(rng.normal(0, 0.02, e))
            yield base.copy()


def run_policy(policy: str, loads_seq, e, groups, d=0.1):
    """(replans, deployments, mean imbalance, final placement groups)."""
    replans = deploys = 0
    total_imb = 0.0
    n = 0
    if policy == "invariant":
        gov = ExpertPlacementGovernor(e, groups, d=d, ema=0.7)
        for loads in loads_seq:
            gov.observe(loads)
            total_imb += imbalance(gov._loads, gov.placement)
            n += 1
        return (gov.replans, gov.deployments, total_imb / n,
                gov.placement.groups)
    placement = None
    ref = None
    for loads in loads_seq:
        fire = False
        if policy == "unconditional" or placement is None:
            fire = True
        elif policy == "threshold":
            dev = np.abs(loads - ref) / np.maximum(np.abs(ref), 1e-9)
            fire = bool((dev >= 0.4).any())
        if fire:
            replans += 1
            new_p, _ = lpt_placement(loads, groups)
            ref = loads.copy()
            if placement is None or new_p.groups != placement.groups:
                placement = new_p
                deploys += 1
        total_imb += imbalance(loads, placement)
        n += 1
    return replans, deploys, total_imb / n, placement.groups


def main(argv=None, quick: bool = False):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--experts", type=int, default=64)
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/torch_adaptive_moe.json")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    steps = 150 if (quick or args.quick) else args.steps

    print("regime,policy,replans,deployments,avg_imbalance")
    rows = []
    for regime in ("traffic", "stocks"):
        for policy in POLICIES:
            rng = np.random.default_rng(0)
            seq = list(drifting_loads(rng, args.experts, steps, regime))
            r, dep, imb, groups = run_policy(policy, seq, args.experts,
                                             args.groups)
            rows.append({"regime": regime, "policy": policy, "replans": r,
                         "deployments": dep, "avg_imbalance": imb,
                         "groups": [list(g) for g in groups]})
            print(f"{regime},{policy},{r},{dep},{imb:.4f}", flush=True)
    write_json(args.out, {"device": device_block(device), "steps": steps,
                          "experts": args.experts, "groups": args.groups,
                          "rows": rows})
    return rows


if __name__ == "__main__":
    main()
