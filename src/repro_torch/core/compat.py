"""Deprecation plumbing for the pre-``repro_torch.cep`` class ladder.

The ladder's public surface (``make_engine``/``MonitoredEngine``/
``FleetRunner``/``MonitoredFleetRunner``/``CEPFleetServingEngine``/
``MonitoredCEPFleetServingEngine``) is superseded by the
``repro_torch.cep`` facade, where plan family, monitoring, and fleet size
are configuration.  The ladder classes remain the implementation — the
facade composes them — but *direct* construction warns so downstream code
migrates.

``legacy_ok()`` is how the facade (and tests that intentionally exercise
the shims) constructs ladder objects without surfacing the warning to the
end user.
"""

from __future__ import annotations

import contextlib
import warnings

_MSG = ("{name} is a legacy entry point; use the repro_torch.cep facade "
        "instead: cep.open(pattern, partitions=K, "
        "plan='order'|'tree'|'auto', monitor=True|False, "
        "config=RuntimeConfig(...))")


def warn_legacy(name: str) -> None:
    """Emit the ladder deprecation warning, attributed to the caller's
    caller (the user code constructing the legacy object)."""
    warnings.warn(_MSG.format(name=name), DeprecationWarning, stacklevel=3)


@contextlib.contextmanager
def legacy_ok():
    """Suppress ladder deprecation warnings for internal construction."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield
