"""Partitioned fleet demo on the PyTorch/CUDA port: K tenants, one data
plane, one facade.

The twin of ``examples/fleet_demo.py`` through ``repro_torch.cep``.  Each
tenant (stream partition) has its own statistical regime, its own
invariant monitor and its own evaluation plan; all K advance through ONE
K-batched ``process_chunk`` per tick (on the GPU: the hand-written
packed join and survivor selection kernels).  Every partition's match count is
cross-checked against the brute-force oracle.

    PYTHONPATH=src python examples/torch_fleet_demo.py [--device cpu]
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
    # odd tenants see near-uniform drifting stocks.
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
        PATTERN, partitions=k, plan="order",
        config=RuntimeConfig(buffer_capacity=128, match_capacity=1024,
                             policy="invariant",
                             policy_kw={"k": 1, "d": 0.0},
                             device=args.device))
    tel = session.run(tenant_streams(k, scfg))

    print(f"== fleet of {k} tenants, {tel.chunks} chunks, "
          f"{tel.events} events ==")
    print(f"matches={tel.matches}  replans={tel.replans}  "
          f"deployments={tel.deployments}  "
          f"migrating-partition-chunks={tel.migration_partition_chunks}")
    print(f"engine {tel.engine_time_s * 1e3:.0f} ms, "
          f"control {tel.control_time_s * 1e3:.0f} ms")

    print(f"\n{'tenant':>6s} {'regime':>8s} {'matches':>8s} {'oracle':>8s}")
    oracle = [RefEngine(PATTERN.build()).run(s).full_matches
              for s in tenant_streams(k, scfg)]
    for p in range(k):
        got = int(tel.per_partition_matches[p])
        mark = "ok" if got == oracle[p] else "MISMATCH"
        print(f"{p:6d} {'traffic' if p % 2 == 0 else 'stocks':>8s} "
              f"{got:8d} {oracle[p]:8d}  {mark}")
    assert tel.per_partition_matches.tolist() == oracle
    print("\nfleet == oracle on every partition")
    return tel


if __name__ == "__main__":
    main()
