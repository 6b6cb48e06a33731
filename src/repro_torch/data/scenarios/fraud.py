"""Fraud-style card-transaction sequences with abrupt regime shifts.

The paper's credit-card domain: an authorization probe, an escalating
purchase, then a large cross-border transfer within a short window, with
strictly increasing amounts (the classic card-testing ladder).  One global
stream (K = 1) — the adaptivity story here is purely temporal.

Statistical design: baseline traffic has probes rare and transfers as
routine bulk (settlement chatter), keeping the cold-start plan optimal
through the stationary control segment.  A fraud campaign then lands as
*abrupt* shocks (the traffic-regime shape from the paper's Aarhus data:
rare but extreme): probe volume explodes ~12x while legitimate transfer
chatter collapses, and a second mid-campaign shock pushes amounts (and so
predicate selectivities) up as the fraudsters scale.  The pinned plan
seeds on the probe flood and overflows; an adaptive session replans at
the first shock.
"""

from __future__ import annotations

import numpy as np

from ...cep.dsl import P
from .base import Scenario, Segment

__all__ = ["make"]

AUTH, PURCHASE, XFER = 0, 1, 2

_CONTROL_RATES = np.array([0.5, 1.6, 4.5])
_SHOCK1_RATES = np.array([4.5, 3.2, 0.35])
_SHOCK2_RATES = np.array([5.5, 4.0, 0.25])
# Baseline amounts drift *down* the ladder (escalation is rare); campaign
# amounts escalate, so the chain predicates open up exactly when the rate
# order inverts — selectivity and rate drift together, like the paper's
# real regimes.
_ATTR_MEAN = np.array([[0.0], [-0.4], [-0.8]])
_SHOCK1_ATTR = np.array([[0.2], [0.7], [1.2]])
_SHOCK2_ATTR = np.array([[0.4], [1.0], [1.6]])


def _pattern():
    return (P.seq(AUTH, PURCHASE, XFER)
            .where(P.attr(0) < P.attr(1) - 0.4,
                   P.attr(1) < P.attr(2) - 0.4)
            .within(4.0))


def _trajectory(partition: int, seed: int, sc: Scenario):
    warm, control, campaign = sc.segments
    for _ in range(warm.n_chunks + control.n_chunks):
        yield _CONTROL_RATES, _ATTR_MEAN
    second = campaign.n_chunks // 2
    for i in range(campaign.n_chunks):
        if i >= second:
            yield _SHOCK2_RATES, _SHOCK2_ATTR
        else:
            yield _SHOCK1_RATES, _ATTR_MEAN


def make() -> Scenario:
    return Scenario(
        name="fraud",
        description="card-testing ladder sequences; a fraud campaign "
                    "lands as two abrupt shocks inverting probe/transfer "
                    "rates and shifting amount selectivities",
        pattern_factory=_pattern,
        partitions=1,
        n_types=3,
        segments=(Segment("warmup", 8, "none"),
                  Segment("baseline", 24, "control"),
                  Segment("campaign", 48, "drift")),
        trajectory_factory=_trajectory,
        runtime=dict(buffer_capacity=64, match_capacity=128,
                     estimator_buckets=8,
                     policy="invariant", policy_kw={"k": 1, "d": 0.1}),
        expected=dict(control_replans=0, min_drift_deployments=1,
                      drift_kind="shock"),
        chunk_duration=1.0,
        chunk_cap=256,
        rate_scale=3.0,
    )
