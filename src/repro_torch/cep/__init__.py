"""``repro_torch.cep`` — the public CEP runtime surface of the port.

    from repro_torch import cep
    from repro_torch.cep import P, RuntimeConfig

    pattern = (P.seq(0, 1, 2)
               .where(P.attr(0) < P.attr(1) - 0.3,
                      P.attr(1) < P.attr(2) - 0.3)
               .within(4.0))

    session = cep.open(pattern, partitions=8, plan="order", monitor=True,
                       config=RuntimeConfig(match_capacity=1024))
    telemetry = session.run(streams)   # on the CUDA device by default

    book = cep.open_rulebook([pattern, other], partitions=8)
    book.run(streams)                  # per-rule counters: book.match_counts

``RefEngine`` is exported so a session can be cross-checked against the
brute-force oracle.  ``spans`` (``from repro_torch.cep import spans``;
outside ``__all__``, which stays the reference package's surface) is the
port's tracing: ``spans.enable()``, ``spans.disable()``, ``spans.drain()``
for spans at the serving path's layer boundaries, off by default.
"""

from ..core.patterns import CompositePattern, Pattern  # noqa: F401
from ..core.plans import OrderPlan, TreePlan  # noqa: F401
from ..core.ref_engine import RefEngine  # noqa: F401
from ..core import spans  # noqa: F401
from .config import RuntimeConfig  # noqa: F401
from .dsl import P  # noqa: F401
from .rulebook import Rulebook, open_rulebook  # noqa: F401
from .session import Session, Telemetry, open  # noqa: F401

__all__ = [
    "P",
    "open",
    "open_rulebook",
    "Session",
    "Rulebook",
    "Telemetry",
    "RuntimeConfig",
    "Pattern",
    "CompositePattern",
    "OrderPlan",
    "TreePlan",
    "RefEngine",
]
