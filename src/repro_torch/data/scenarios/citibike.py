"""CitiBike-style hot-path chains: Kleene ride sequences with a rush surge.

Models the CS-E4780 course workload: detect an *unlock* of a promoted
bike class, followed by a bounded run of *ride* telemetry pings (Kleene
closure), closed by a *dock* — all within a short trip window.  Partitions
are station groups (K = 2).

Statistical design (shared across the suite, see ``base``): off-peak the
promoted unlocks are rare and docks dominate, which keeps the cold-start
plan — seed on the unlock, the rarest type — optimal, so a sound invariant
policy stays silent (zero-replan control gate).  The evening rush ramps
unlocks and ride pings up ~8x while dock events thin out (bikes pile up
downtown): the rate order inverts, the pinned cold plan now seeds on the
most frequent type and its Kleene join overflows the match set, while an
adaptive session flags the inversion during the ramp and re-seeds on the
now-rare dock events.
"""

from __future__ import annotations

import numpy as np

from ...cep.dsl import P
from .base import Scenario, Segment

__all__ = ["make"]

UNLOCK, RIDE, DOCK = 0, 1, 2

_CONTROL_RATES = np.array([0.5, 1.8, 4.5])
_RUSH_RATES = np.array([4.5, 3.5, 0.5])
# Stationary attribute regime: trip attributes (e.g. battery level along
# the hot path) descend, so the ascending chain predicate keeps matches
# rare — the rush drifts *rates*, which is what inverts the plan space.
_ATTR_MEAN = np.array([[0.6], [0.0], [-0.6]])
_RAMP = 6  # chunks of linear ramp into the rush regime


def _pattern():
    return (P.seq(UNLOCK, P.kleene(RIDE, bound=3), DOCK)
            .where(P.attr(0) < P.attr(1) + 0.4,
                   P.attr(1) < P.attr(2) + 0.4)
            .within(3.0))


def _trajectory(partition: int, seed: int, sc: Scenario):
    # Station groups differ in volume, not in rate *order* — the plan
    # space is shared, the statistics are per-partition.
    vol = 1.0 + 0.15 * partition
    warm, control, rush = sc.segments
    for _ in range(warm.n_chunks + control.n_chunks):
        yield _CONTROL_RATES * vol, _ATTR_MEAN
    for i in range(rush.n_chunks):
        f = min(1.0, (i + 1) / _RAMP)
        yield ((1 - f) * _CONTROL_RATES + f * _RUSH_RATES) * vol, _ATTR_MEAN


def make() -> Scenario:
    return Scenario(
        name="citibike",
        description="Kleene hot-path trip chains with an evening rush "
                    "surge inverting the unlock/dock rate order",
        pattern_factory=_pattern,
        partitions=2,
        n_types=3,
        segments=(Segment("warmup", 8, "none"),
                  Segment("offpeak", 24, "control"),
                  Segment("rush", 48, "drift")),
        trajectory_factory=_trajectory,
        runtime=dict(buffer_capacity=64, match_capacity=128,
                     estimator_buckets=8,
                     policy="invariant", policy_kw={"k": 1, "d": 0.1}),
        expected=dict(control_replans=0, min_drift_deployments=2,
                      drift_kind="ramp"),
        chunk_duration=1.0,
        chunk_cap=256,
        rate_scale=1.5,
    )
