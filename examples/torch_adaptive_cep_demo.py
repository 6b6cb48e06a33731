"""Adaptive CEP in depth on the PyTorch/CUDA port: all four decision
policies × both data regimes, with the distance-d knob and the d_avg
estimator (paper §3.4, §5).

The twin of ``examples/adaptive_cep_demo.py`` through ``repro_torch.core``.

    PYTHONPATH=src python examples/torch_adaptive_cep_demo.py [--device cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.core import AdaptiveRunner, EngineConfig, make_policy
from repro_torch.core.decision import InvariantPolicy
from repro_torch.core.patterns import chain_predicates, seq_pattern
from repro_torch.data.cep_streams import StreamConfig, make_stream

PATTERN = seq_pattern([0, 1, 2, 3], window=4.0,
                      predicates=chain_predicates([0, 1, 2, 3],
                                                  theta=-0.3))
POLICIES = [("static", {}), ("unconditional", {}),
            ("threshold", {"t": 0.4}),
            ("invariant", {"k": 1, "d": 0.0}),
            ("invariant", {"k": 1, "d": 0.3})]


def run(kind, policy, n_chunks, device):
    cfg = StreamConfig(n_types=4, n_chunks=n_chunks, chunk_cap=512,
                       base_rate=15.0, seed=3)
    r = AdaptiveRunner(PATTERN, planner="greedy", policy=policy,
                       engine_cfg=EngineConfig(b_cap=128, m_cap=2048,
                                               device=device),
                       adaptive_caps=True)
    return r.run(make_stream(kind, cfg)), r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunks", type=int, default=120)
    args = ap.parse_args(argv)

    out = {}
    print("== policy comparison (per data regime) ==")
    print(f"{'regime':8s} {'policy':16s} {'matches':>7s} {'pm':>8s} "
          f"{'replans':>7s} {'deploys':>7s} {'fp':>3s} {'D+A ms':>8s}")
    for kind in ("traffic", "stocks"):
        for pname, kw in POLICIES:
            m, _ = run(kind, make_policy(pname, **kw), args.chunks,
                       args.device)
            tag = pname + (f"(d={kw['d']})" if pname == "invariant" else "")
            out[(kind, tag)] = m
            print(f"{kind:8s} {tag:16s} {m.full_matches:7d} "
                  f"{m.pm_created:8d} {m.replans:7d} {m.deployments:7d} "
                  f"{m.false_positives:3d} "
                  f"{(m.decision_time_s + m.plan_time_s) * 1e3:8.1f}")

    print("\n== d_avg estimator (§3.4 approach 2) ==")
    pol = InvariantPolicy(k=1, d_mode="avg")
    m, r = run("traffic", pol, args.chunks, args.device)
    out[("traffic", "d_avg")] = m
    print(f"estimated d_avg = {getattr(pol, 'd_estimated', 0.0):.4f} "
          f"(replans={m.replans}, deployments={m.deployments})")
    return out


if __name__ == "__main__":
    main()
