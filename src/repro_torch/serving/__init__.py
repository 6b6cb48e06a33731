"""Serving substrate of the port: the keyed-stream router and the CEP
fleet serving fronts (plain or with device-resident invariant
monitoring)."""

from .engine import (  # noqa: F401
    CEPFleetServingEngine,
    MonitoredCEPFleetServingEngine,
)
from .scheduler import CEPStreamRouter  # noqa: F401
