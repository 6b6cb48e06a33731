"""Plan-generation algorithm ``A`` by name (paper Algorithm 1, §2.2).

The instrumented planners — greedy order plans and ZStream trees — return
the plan together with the deciding-condition sets the invariant policies
consume.  The single-stream ``AdaptiveRunner`` of the JAX package comes in
a later slice of the port; the fleet runners and the session need only
``make_planner``.
"""

from __future__ import annotations

from typing import Callable, Tuple

from .greedy import greedy_order_plan
from .invariants import DCSList
from .patterns import Pattern
from .stats import Stat
from .zstream import zstream_tree_plan


def make_planner(kind: str) -> Callable[[Pattern, Stat], Tuple[object, DCSList]]:
    if kind == "greedy":
        return greedy_order_plan
    if kind == "zstream":
        return zstream_tree_plan
    raise ValueError(f"unknown planner {kind!r}")
