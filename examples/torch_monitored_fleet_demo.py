"""Device-monitored fleet demo on the PyTorch/CUDA port:
violation-triggered replans end to end.

The twin of ``examples/monitored_fleet_demo.py`` through
``repro_torch.cep``.  K tenants share ONE K-batched data plane that — in
the same step — joins each chunk, updates per-partition statistics rings,
and verifies each tenant's lowered invariant set (paper §3.3-§3.5).  The
host reads back a single (K,) violation-flag vector per tick; it syncs
statistics and re-runs the planner ONLY for tenants whose flag fired.
Match counts are cross-checked against the brute-force oracle.

    PYTHONPATH=src python examples/torch_monitored_fleet_demo.py [--device cpu]
"""

import argparse
import dataclasses
import sys

sys.path.insert(0, "src")

from repro_torch import cep
from repro_torch.cep import P, RefEngine, RuntimeConfig
from repro_torch.data.cep_streams import StreamConfig, make_stream

PATTERN = (P.seq(0, 1, 2)
           .where(P.attr(0) < P.attr(1) - 0.3,
                  P.attr(1) < P.attr(2) - 0.3)
           .within(4.0))


def tenant_streams(k, scfg):
    # Alternate regimes: even tenants see skewed traffic with rare shocks,
    # odd tenants see near-uniform drifting stocks — so different tenants
    # violate their invariants at different times.
    return [
        make_stream("traffic" if p % 2 == 0 else "stocks",
                    dataclasses.replace(scfg, seed=17 + p))
        for p in range(k)
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunks", type=int, default=60)
    args = ap.parse_args(argv)
    k = 8
    scfg = StreamConfig(n_types=3, n_chunks=args.chunks, chunk_cap=256,
                        base_rate=12.0, seed=17)

    session = cep.open(
        PATTERN, partitions=k, plan="order", monitor=True,
        config=RuntimeConfig(buffer_capacity=128, match_capacity=1024,
                             policy="invariant",
                             policy_kw={"k": 1, "d": 0.0},
                             device=args.device))
    tel = session.run(tenant_streams(k, scfg))

    print(f"== device-monitored fleet of {k} tenants, {tel.chunks} chunks, "
          f"{tel.events} events ==")
    print(f"matches={tel.matches}  violations={tel.violations}  "
          f"replans={tel.replans}  deployments={tel.deployments}")
    print(f"host statistic syncs: {tel.host_syncs} "
          f"(vs {tel.chunks * k} for host-side monitoring = K x chunks)")
    print(f"last drift per tenant: "
          f"{[f'{d:+.2f}' for d in tel.last_drift]}")

    print("\ntenant  matches")
    for p in range(k):
        print(f"{p:6d}  {tel.per_partition_matches[p]:7d}")

    oracle = [RefEngine(PATTERN.build()).run(s).full_matches
              for s in tenant_streams(k, scfg)]
    assert tel.per_partition_matches.tolist() == oracle, (
        "fleet disagrees with the brute-force oracle")
    print("\noracle cross-check: OK "
          "(per-tenant match counts == brute force, replans and all)")
    return tel


if __name__ == "__main__":
    main()
