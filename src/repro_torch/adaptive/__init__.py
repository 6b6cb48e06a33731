"""The paper's invariant-based reoptimization as a *framework* feature.

A large training/serving system has exactly the paper's problem shape: an
expensive deterministic plan generator (expert placement + weight
relocation / batch-plan rebuild) driven by drifting runtime statistics
(expert routing loads, request-class arrival rates).  These governors
port the paper's decision machinery verbatim — greedy plan generation
with block-building comparison capture, tightest-condition invariants,
distance-d damping — so Theorem 1's no-false-positive guarantee applies
to re-planning decisions.
"""

from .placement import ExpertPlacementGovernor  # noqa: F401
from .batching import AdaptiveBatchPlanner  # noqa: F401
