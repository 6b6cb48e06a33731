"""The adaptive CEP runtime's core, ported to PyTorch.

The public runtime surface is the ``repro_torch.cep`` facade (pattern DSL
+ ``Session`` + ``RuntimeConfig``); the legacy control-plane entry points
here (``make_engine``, ``MonitoredEngine``, ``fleet.FleetRunner``, …)
emit ``DeprecationWarning``s pointing at it.

Control plane (host, numpy; copies of the JAX package's modules):
instrumented plan generators (``greedy``, ``zstream``), invariant machinery
(``invariants``), decision policies (``decision``), statistics estimation
(``stats``), the single-stream detection-adaptation loop (``adaptation``).
Data plane (torch): the order- and tree-plan engines (``engine``) backed
by the ``repro_torch.kernels`` CUDA join kernels, batched over K stream
partitions by ``fleet``.  ``ref_engine`` is the brute-force ground-truth
oracle and ``convert`` carries state over from the JAX package.
"""

from .adaptation import AdaptiveRunner, RunMetrics  # noqa: F401
from .decision import make_policy  # noqa: F401
from .engine import EngineConfig, OrderEngine, TreeEngine  # noqa: F401
from .engine import MonitoredEngine  # noqa: F401
from .fleet import (  # noqa: F401
    FleetEngine,
    FleetEstimator,
    FleetMetrics,
    FleetRunner,
    MonitoredFleetRunner,
    route_events,
    stack_chunks,
    stacked_streams,
)
from .invariants import (  # noqa: F401
    InvariantSet,
    LoweredInvariants,
    StackedLowered,
    d_avg_estimate,
    lower_invariants,
    stack_lowered,
    write_lowered_row,
)
from .ref_engine import RefEngine, brute_force_matches  # noqa: F401
from .greedy import greedy_order_plan  # noqa: F401
from .patterns import (  # noqa: F401
    CompositePattern,
    Pattern,
    Predicate,
    and_pattern,
    kleene_pattern,
    neg_pattern,
    seq_pattern,
)
from .plans import OrderPlan, TreePlan, plan_cost  # noqa: F401
from .stats import SlidingWindowEstimator, Stat  # noqa: F401
from .zstream import zstream_tree_plan  # noqa: F401
