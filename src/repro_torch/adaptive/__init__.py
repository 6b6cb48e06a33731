"""The paper's invariant-based reoptimization as a *framework* feature.

A serving system has exactly the paper's problem shape: an expensive
deterministic plan generator (a batch-plan rebuild) driven by drifting
runtime statistics (request-class arrival rates).  The governor ports the
paper's decision machinery verbatim — greedy plan generation with
block-building comparison capture, tightest-condition invariants,
distance-d damping — so Theorem 1's no-false-positive guarantee applies to
re-planning decisions.  The reference's expert-placement governor
(``repro.adaptive.placement``) comes with the training slice.
"""

from .batching import AdaptiveBatchPlanner  # noqa: F401
