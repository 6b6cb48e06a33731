"""Consolidated runtime configuration for the CEP facade.

Before the facade, capacity/bucket/laplace/escalation knobs were scattered
as constructor kwargs across ``core/engine.py`` (``EngineConfig``,
``MonitoredEngine``), ``core/fleet.py`` (``FleetRunner`` /
``MonitoredFleetRunner``) and ``serving/engine.py`` (the serving fronts).
``RuntimeConfig`` is the single source of truth: every knob any of the
eight legacy configurations accepted, with one name and one default, and
adapters (``engine()``, ``policy_factory()``) that translate back to the
internal structures.

The port's copy adds ``device`` (default ``"cuda"``; asking for CUDA
without a GPU raises when a session opens).  ``mesh`` is resolved against
``partitions`` and ``device`` when a session or rulebook opens
(``distributed.sharding.resolve_cep_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from ..core.decision import DecisionPolicy, make_policy
from ..core.engine import EngineConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """All tunables of a CEP session, in one place.

    Data plane
    ----------
    buffer_capacity: per-type ring-buffer rows (events of recent history).
    match_capacity:  match-set rows; overflow beyond this triggers the
                     escalation recount (``escalate_on_overflow``).
    backend:         kernel backend override (None = by device: the CUDA
                     kernels for CUDA tensors, the plain PyTorch versions
                     on the CPU; "ref" = the plain versions everywhere).
    device:          torch device of the data plane ("cuda" or "cpu").
    chunk_capacity:  per-partition padded chunk rows for keyed-batch
                     routing (``Session.process``); overflow is counted as
                     back-pressure, never silently dropped.

    Scale-out
    ---------
    superchunk: chunks per window (``core.scan``: on CUDA one captured
                graph replay per chunk, no host sync inside the window);
                the host syncs/replans only at window boundaries (or at an
                invariant flag), with results bit-identical to per-chunk
                stepping.  The batch plane needs ``monitor=True`` for it.
    mesh:       shard the K-partition axis across devices — ``None`` (no
                sharding), ``"auto"`` (every device of ``device``'s type),
                an int device count, or a ``distributed.CepMesh`` with a
                ``"cep"`` axis.  K must divide by the device count, and
                the mesh must lie on ``device``; a D=1 mesh runs the
                sharded code path on one device.  D > 1 raises
                ``NotImplementedError`` until the multi-GPU split lands
                (ROADMAP.md).

    Statistics
    ----------
    estimator_buckets: sliding-window length in chunks (host estimator and
                       device monitor rings alike).
    laplace:           additive smoothing for selectivity estimates (host
                       estimator and device monitor snapshots alike).
    sel_samples:       Monte-Carlo pairs sampled per chunk by the *host*
                       estimator (device monitoring observes exhaustively).

    Adaptation
    ----------
    policy:    reoptimizing decision function ``D`` — "invariant",
               "threshold", "unconditional", "static", or None (plan once
               from the uniform prior, never adapt).  Monitored sessions
               require "invariant" (the only policy with a device
               lowering).
    policy_kw: kwargs for the policy (e.g. ``{"k": 1, "d": 0.0}``).
    escalate_on_overflow / max_escalations: re-evaluate a chunk at the
               next pow2 match capacity when a join truncated.
    max_invariants / max_terms: static caps for the stacked lowered
               invariant tensors (monitored sessions).  None = the
               cold-start set's exact sizes — exact for the greedy/order
               planner; pass explicit worst-case caps for tree plans.
    seed:      RNG seed for the host estimator's selectivity sampling.

    Rulebook
    --------
    sharing:       multi-query join sharing across a bucket's rules —
                   "lattice" (full interior sub-join sharing, arXiv
                   1801.09413), "prefix" (opening two-position joins only,
                   the PR 8 behavior) or "none".  Pure work elimination:
                   counters are bit-identical across all three.
    bucket_fusion: fuse same-arity buckets whose shapes differ only in
                   negation/Kleene post-blocks into one superset bucket
                   (fewer dispatches per tick; rules gate the blocks they
                   do not use, so counters are unchanged).
    """

    # data plane
    buffer_capacity: int = 128
    match_capacity: int = 256
    backend: Optional[str] = None
    chunk_capacity: int = 512
    device: str = "cuda"
    # scale-out
    superchunk: int = 1
    mesh: Optional[Any] = None
    # statistics
    estimator_buckets: int = 16
    laplace: float = 1.0
    sel_samples: int = 64
    # adaptation
    policy: Optional[str] = "invariant"
    policy_kw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    escalate_on_overflow: bool = True
    max_escalations: int = 4
    max_invariants: Optional[int] = None
    max_terms: Optional[int] = None
    seed: int = 0
    # rulebook
    sharing: str = "lattice"
    bucket_fusion: bool = True

    def __post_init__(self):
        if self.match_capacity < self.buffer_capacity:
            raise ValueError("match_capacity must be >= buffer_capacity")
        if self.superchunk < 1:
            raise ValueError("superchunk must be >= 1")
        if self.backend not in (None, "ref", "cuda"):
            raise ValueError(f"unknown kernel backend {self.backend!r}")
        if self.policy not in (None, "static", "unconditional", "threshold",
                               "invariant"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.sharing not in ("lattice", "prefix", "none"):
            raise ValueError(f"unknown sharing mode {self.sharing!r}")

    # -- cross-field validation (one checkpoint for every runtime front) ----

    def validate(self, *, monitor: bool, partitions: int) -> None:
        """Checks that need context beyond the config's own fields.

        ``Session`` calls this once at open time; keep any new front's
        checks here so error messages stay uniform.
        """
        from ..distributed.sharding import resolve_cep_mesh

        if partitions < 1:
            raise ValueError("partitions must be >= 1")
        resolve_device(self.device)
        resolve_cep_mesh(self.mesh, partitions, self.device)
        if monitor and self.policy != "invariant":
            raise ValueError(
                "monitored runtimes verify invariants on device; "
                f"config.policy must be 'invariant' (got {self.policy!r})")

    def require_device_control(self, monitor: bool) -> None:
        """Superchunk windows keep control on the device between host
        syncs; a host-side decision policy would need the per-chunk
        statistics sync that the window exists to remove."""
        if self.superchunk > 1 and not monitor:
            raise ValueError(
                "superchunk > 1 requires monitor=True: host decision "
                "policies sync statistics every chunk, which defeats the "
                "windowed plane (set monitor=True or superchunk=1)")

    # -- adapters to the internal structures --------------------------------

    def engine(self) -> EngineConfig:
        return EngineConfig(b_cap=self.buffer_capacity,
                            m_cap=self.match_capacity,
                            backend=self.backend, device=self.device)

    def policy_factory(self) -> Optional[Callable[[], DecisionPolicy]]:
        if self.policy is None:
            return None
        return lambda: make_policy(self.policy, **self.policy_kw)
