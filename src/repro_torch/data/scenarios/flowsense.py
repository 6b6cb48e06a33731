"""FlowSense-style multi-tenant IoT telemetry with per-tenant alert rules.

Models FlowSense's rule table: each tenant (partition, K = 4) watches for
an unacknowledged environmental alert chain — a temperature spike, *no*
operator acknowledgement, then a humidity drop followed by a gas alarm,
inside one reporting window.  The acknowledgement is the pattern's negated
element: its presence vetoes the alert.

Statistical design: in steady state spikes are rare, routine gas-sensor
chatter dominates, and acks are plentiful — the cold-start plan (seed on
the rare spike) stays optimal and the control gate demands silence.  A
staggered firmware rollout then degrades tenants one by one (tenant ``p``
regresses ``p`` stagger-steps into the drift segment): spike rates jump
~9x, chatter thins, and acks nearly vanish.  Each tenant's invariant row
must fire at *its own* rollout step — per-partition adaptation, not a
global replan — and the pinned plan, still seeding on now-dominant spikes,
overflows its match set.
"""

from __future__ import annotations

import numpy as np

from ...cep.dsl import P
from .base import Scenario, Segment

__all__ = ["make", "rulebook_patterns"]

TEMP, HUMID, GAS, ACK = 0, 1, 2, 3

_CONTROL_RATES = np.array([0.5, 1.6, 4.5, 2.0])
_ROLLOUT_RATES = np.array([4.5, 3.2, 0.45, 0.15])
# In steady state the readings sit in the "calm" order (spike mild,
# humidity nominal, gas low) so the ascending alert chain rarely closes;
# the rollout regression pushes the faulty fleet's readings up together.
_ATTR_MEAN = np.array([[0.4], [0.0], [-0.5], [0.0]])
_ROLLOUT_ATTR = np.array([[0.2], [0.4], [0.6], [0.0]])


def _pattern():
    return (P.seq(TEMP, P.neg(ACK), HUMID, GAS)
            .where(P.attr(0) < P.attr(1) + 0.3,
                   P.attr(1) < P.attr(2) + 0.3)
            .within(3.0))


def _ack_pattern():
    # The benign counterpart of the alert: a spike the operator
    # acknowledged inside the reporting window.  Seeds on the rare spike,
    # so the cold plan stays optimal through the control segment.
    return P.seq(TEMP, ACK).within(3.0)


def _combo_pattern():
    # Fraud-style combo: humidity drop and gas alarm co-occurring (either
    # order) with ascending readings — the cross-sensor correlation rule
    # a tenant layers on top of the alert chain.
    return (P.and_(HUMID, GAS)
            .where(P.attr(0) < P.attr(1) + 0.3)
            .within(2.0))


def rulebook_patterns():
    """The 3-rule tenant rulebook (alert + ack + fraud-combo) used by the
    rulebook replay tie-in; rule 0 is the scenario's gated alert chain."""
    return [_pattern(), _ack_pattern(), _combo_pattern()]


def _trajectory(partition: int, seed: int, sc: Scenario):
    # Tenants carry Zipf-ish volume skew; the rollout reaches tenant p
    # after p stagger-steps so flags must fire per-partition.
    vol = 1.0 / (1.0 + 0.2 * partition)
    warm, control, rollout = sc.segments
    stagger = max(1, rollout.n_chunks // 8)
    onset = partition * stagger
    for _ in range(warm.n_chunks + control.n_chunks):
        yield _CONTROL_RATES * vol, _ATTR_MEAN
    for i in range(rollout.n_chunks):
        if i >= onset:
            yield _ROLLOUT_RATES * vol, _ROLLOUT_ATTR
        else:
            yield _CONTROL_RATES * vol, _ATTR_MEAN


def make() -> Scenario:
    return Scenario(
        name="flowsense",
        description="multi-tenant IoT alert rules (negated ack) under a "
                    "staggered firmware rollout that inverts per-tenant "
                    "sensor statistics",
        pattern_factory=_pattern,
        partitions=4,
        n_types=4,
        segments=(Segment("warmup", 8, "none"),
                  Segment("steady", 24, "control"),
                  Segment("rollout", 48, "drift")),
        trajectory_factory=_trajectory,
        runtime=dict(buffer_capacity=64, match_capacity=128,
                     estimator_buckets=8,
                     policy="invariant", policy_kw={"k": 1, "d": 0.1}),
        expected=dict(control_replans=0, min_drift_deployments=4,
                      drift_kind="staggered-step"),
        chunk_duration=1.0,
        chunk_cap=256,
        rate_scale=1.5,
    )
