"""Serving substrate of the port: the LM prefill/decode engine and its
adaptive batch scheduler, the keyed-stream router and the CEP fleet
serving fronts (plain or with device-resident invariant monitoring)."""

from .engine import (  # noqa: F401
    CEPFleetServingEngine,
    MonitoredCEPFleetServingEngine,
    ServingEngine,
)
from .scheduler import CEPStreamRouter, Request, Scheduler  # noqa: F401
