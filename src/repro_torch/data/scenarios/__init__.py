"""Real-workload scenario adapters (distribution-matched, deterministic).

A copy of the JAX package's ``repro.data.scenarios``: the same seed gives
the same arrays.

Three workloads shaped after real deployments — CitiBike hot-path Kleene
chains, FlowSense multi-tenant IoT alert rules, and the paper's fraud
sequence domain — each a :class:`~repro_torch.data.scenarios.base.Scenario`
record: pattern(s) in ``P`` DSL form, per-partition padded chunk streams,
ground-truth drift trajectories, segment structure, and the expected-
adaptivity metadata that the replay gates (``chip_smoke.py``'s scenarios
phase) check.
"""

from .base import Scenario, Segment
from . import citibike, flowsense, fraud

__all__ = ["Scenario", "Segment", "SCENARIOS", "get", "names"]

_FACTORIES = {
    "citibike": citibike.make,
    "flowsense": flowsense.make,
    "fraud": fraud.make,
}


def names():
    return list(_FACTORIES)


def get(name: str) -> Scenario:
    try:
        return _FACTORIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; available: {sorted(_FACTORIES)}"
        ) from None


SCENARIOS = tuple(_FACTORIES)
