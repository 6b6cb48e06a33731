"""Logical-axis sharding rules, and the CEP fleet's device mesh.

The port of ``repro.distributed.sharding``, in two halves.

**Logical-axis rules** (the LM stack).  Model code names tensor dims by
*logical* axes ("batch", "heads", "ff", "experts", ...).  A ``MeshRules``
table maps logical names to physical mesh axes; ``resolve`` checks
divisibility and falls back to replication on any axis that does not
divide evenly, recording each fallback (the reference's strings, letter
for letter).  ``DEFAULT_RULES`` is the reference's production layout.
A mesh is anything with a ``shape`` mapping of axis name -> size: the
port's ``launch.mesh.HostMesh``, or a stand-in in tests.

Decision: the port runs per-rank local tensors with explicit collectives
(``distributed/collectives.py``, the expert-parallel MoE), the
reference's ``shard_map`` style.  ``sharding`` / ``logical_sharding``
turn a resolved spec into DTensor placements (``Shard(i)`` or
``Replicate()`` per mesh dim, in the mesh's axis order) for callers that
want them; ``logical_constraint`` returns ``x`` unchanged, as the
reference does without rules: eager code has no compiler to constrain.

**The CEP fleet's mesh.**  Every leaf of the CEP data plane leads with
the K-partition axis (stacked ring buffers, statistics rings, plan rows,
lowered invariants, per-partition counters), and partitions are
independent streams, so the fleet maps onto a 1-D device mesh with ONE
rule: split K over the ``cep`` axis into D contiguous blocks, replicate
the rest (the shared chunk clock, a rulebook's rule rows and lattice
routing), run the step once per block and concatenate the K-led outputs.
No collective is needed.

``shard_map`` is that rule for a torch function: its specs give, per
argument, ``fleet_pspec()`` (split the leading axis; a NamedTuple
argument may give one spec per field) or None (replicated).  At D = 1 the
single block is a view of the whole argument and the output is the
block's own, so a D = 1 mesh runs the sharded code path with no copy.

D > 1 waits for a host with more than one GPU (ROADMAP.md, Queue 1):
``resolve_cep_mesh`` raises ``NotImplementedError`` for it, after the
device-count check, since no run here can check a multi-GPU split (the
blocks would also have to be placed on, and gathered from, the mesh's
devices).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.engine import canonical_device

AxisVal = Union[None, str, Tuple[str, ...]]


DEFAULT_RULES: Dict[str, AxisVal] = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "embed": "data",        # FSDP shard of parameter d_model dims
    "opt_embed": "data",    # ZeRO-1: optimizer-state d_model dims
    "heads": "model",
    "kv_heads": "model",
    "qkv_dim": None,
    "ff": "model",
    "experts": "model",
    "expert_cap": None,
    "vocab": "model",
    "cache_seq": "model",   # decode KV caches: split-T (flash-decoding)
    "layers": None,
    "conv": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "frontend": None,
    # CEP fleet: the leading K-partition axis of every data-plane tensor.
    "cep_partitions": "cep",
}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (replicated) -- ``jax.sharding.PartitionSpec`` without jax."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass
class MeshRules:
    mesh: object            # anything with ``shape``: {axis name: size}
    rules: Dict[str, AxisVal]
    fallbacks: List[str] = dataclasses.field(default_factory=list)

    def axis_size(self, phys: AxisVal) -> int:
        if phys is None or self.mesh is None:
            return 1
        if isinstance(phys, str):
            phys = (phys,)
        size = 1
        for a in phys:
            size *= self.mesh.shape.get(a, 1)
        return size

    def resolve(self, shape: Sequence[int],
                logical: Sequence[Optional[str]],
                tag: str = "") -> PartitionSpec:
        """Logical names -> PartitionSpec with divisibility fallback."""
        if len(shape) != len(logical):
            raise ValueError(f"{tag}: shape {tuple(shape)} has "
                             f"{len(shape)} dims, axes {tuple(logical)}")
        out = []
        used: set = set()
        for dim, name in zip(shape, logical):
            if name is None:
                out.append(None)
                continue
            phys = self.rules.get(name)
            if phys is None:
                out.append(None)
                continue
            phys_t = (phys,) if isinstance(phys, str) else tuple(phys)
            # Drop mesh axes missing from the mesh (e.g. "pod" on the
            # single-pod mesh) and axes already used by an earlier dim of
            # this tensor (a mesh axis may appear only once per spec).
            dropped_dup = [a for a in phys_t
                           if self.mesh is not None
                           and a in self.mesh.shape and a in used]
            phys_t = tuple(a for a in phys_t
                           if (self.mesh is None or a in self.mesh.shape)
                           and a not in used)
            if dropped_dup:
                self.fallbacks.append(
                    f"{tag}: dim {dim} ({name}) axis {dropped_dup} already "
                    "used by an earlier dim -> replicated")
            size = self.axis_size(phys_t)
            if size <= 1:
                out.append(None)
            elif dim % size == 0:
                used.update(phys_t)
                out.append(phys_t[0] if len(phys_t) == 1 else phys_t)
            else:
                self.fallbacks.append(
                    f"{tag}: dim {dim} ({name}) not divisible by "
                    f"{phys_t} ({size}) -> replicated")
                out.append(None)
        return PartitionSpec(*out)

    def sharding(self, shape, logical, tag: str = "") -> tuple:
        """The resolved spec as DTensor placements, one per mesh axis in
        the mesh's order: ``Shard(i)`` where tensor dim i is split over
        that axis, else ``Replicate()``."""
        if self.mesh is None:
            raise ValueError("sharding requires an active mesh")
        return placements(self.mesh, self.resolve(shape, logical, tag))


def placements(mesh, spec: PartitionSpec) -> tuple:
    """``spec`` over ``mesh`` as DTensor placements (one per mesh axis)."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for i, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else (part or ())):
            dim_of[a] = i
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.shape)


_local = threading.local()


def current_rules() -> Optional[MeshRules]:
    return getattr(_local, "rules", None)


def set_rules(rules: Optional[MeshRules]) -> None:
    _local.rules = rules


@contextlib.contextmanager
def use_rules(mesh, overrides: Optional[Dict[str, AxisVal]] = None):
    """Activate a mesh + logical-rule table for this thread."""
    table = dict(DEFAULT_RULES)
    if overrides:
        table.update(overrides)
    prev = current_rules()
    set_rules(MeshRules(mesh=mesh, rules=table))
    try:
        yield current_rules()
    finally:
        set_rules(prev)


def logical_constraint(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical names: eager
    tensors are already laid out per rank, so ``x`` comes back as it is."""
    return x


def logical_sharding(shape, logical, tag: str = "") -> Optional[tuple]:
    """DTensor placements of a tensor under the active rules, or None
    without a mesh."""
    r = current_rules()
    if r is None or r.mesh is None:
        return None
    return r.sharding(shape, logical, tag)


# ---------------------------------------------------------------------------
# CEP fleet mesh layer
# ---------------------------------------------------------------------------

CEP_AXIS = "cep"


@dataclasses.dataclass(frozen=True)
class CepMesh:
    """A 1-D device mesh: a tuple of ``torch.device``s and the name of its
    one axis (``shape[name]`` is the device count D, as on a jax
    ``Mesh``)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (CEP_AXIS,)

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"a CepMesh has one axis; got {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def local_devices(device="cuda") -> List[torch.device]:
    """The devices of ``device``'s type: every CUDA device torch sees, or
    the one CPU (what ``jax.devices()`` gives on a CPU host)."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def cep_mesh(n_devices: Optional[int] = None,
             devices: Optional[Sequence] = None, device="cuda") -> CepMesh:
    """A 1-D mesh with the ``cep`` axis over ``devices``, by default the
    first ``n_devices`` (all if None) of ``local_devices(device)``."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else local_devices(device))]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"mesh wants {n_devices} devices, only {len(devs)} present")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError(f"mesh wants at least one device; no "
                         f"{torch.device(device).type} devices present")
    return CepMesh(tuple(devs))


def resolve_cep_mesh(mesh, k: int, device="cuda") -> Optional[CepMesh]:
    """Normalize the facade's ``mesh=`` config into a fleet mesh.

    Accepts ``None`` (no sharding), ``"auto"`` (every device of the data
    plane's type), an ``int`` device count, or a prebuilt
    :class:`CepMesh` carrying a ``cep`` axis.  The mesh must lie on the
    data plane's ``device``, and the K-partition axis must divide evenly
    over it: an uneven split would silently unbalance per-partition
    semantics, so it raises, as in the reference.
    """
    if mesh is None:
        return None
    if isinstance(mesh, CepMesh):
        if CEP_AXIS not in mesh.shape:
            raise ValueError(
                f"fleet mesh must carry a {CEP_AXIS!r} axis; "
                f"got axes {tuple(mesh.shape)}")
        m = mesh
    elif isinstance(mesh, str) and mesh == "auto":
        m = cep_mesh(device=device)
    elif isinstance(mesh, int):
        m = cep_mesh(mesh, device=device)
    else:
        raise TypeError(f"mesh must be None, 'auto', an int device count "
                        f"or a CepMesh; got {type(mesh).__name__}")
    plane = canonical_device(device)
    if any(d.type != plane.type for d in m.devices):
        raise ValueError(f"mesh devices {[str(d) for d in m.devices]} are "
                         f"not of the data plane's device type {plane.type!r}")
    d = m.shape[CEP_AXIS]
    if k % d != 0:
        raise ValueError(
            f"K={k} partitions do not divide over {d} devices; choose K "
            f"as a multiple of the mesh size")
    if d > 1:
        raise NotImplementedError(
            f"a {d}-device cep mesh: splitting K over several GPUs waits "
            "for a multi-GPU host (ROADMAP.md, Queue 1); use mesh=1, "
            "'auto' on one GPU, or None")
    if canonical_device(m.devices[0]) != plane:
        raise ValueError(f"mesh device {m.devices[0]} is not the data "
                         f"plane's device {plane}")
    return m


def fleet_pspec() -> int:
    """The one CEP partition rule as a spec: split the leading axis (K) of
    every leaf.  The port's windows shard their per-chunk step, so every
    sharded leaf leads with K (the reference's scan layout, (S, K), has no
    counterpart)."""
    return 0


# ---------------------------------------------------------------------------
# shard_map for torch functions
# ---------------------------------------------------------------------------


def _rebuild(like, fields):
    return type(like)(*fields) if hasattr(like, "_fields") else tuple(fields)


def _split(x, spec, d: int) -> list:
    """``x``'s D per-device pieces under ``spec``: ``x`` itself D times
    when replicated (None), else every tensor leaf cut into D contiguous
    blocks along axis ``spec`` (views); a tuple spec gives one spec per
    field of a NamedTuple ``x``."""
    if x is None or spec is None:
        return [x] * d
    if isinstance(x, torch.Tensor):
        return list(torch.chunk(x, d, dim=spec))
    specs = spec if isinstance(spec, tuple) else (spec,) * len(x)
    parts = [_split(f, s, d) for f, s in zip(x, specs)]
    return [_rebuild(x, [p[i] for p in parts]) for i in range(d)]


def _concat(parts: list, spec):
    """The inverse of ``_split``: the blocks' outputs joined along axis
    ``spec``, or the first block's for a replicated output."""
    first = parts[0]
    if first is None or spec is None:
        return first
    if isinstance(first, torch.Tensor):
        return first if len(parts) == 1 else torch.cat(parts, dim=spec)
    specs = spec if isinstance(spec, tuple) else (spec,) * len(first)
    return _rebuild(first, [_concat([p[i] for p in parts], s)
                            for i, s in enumerate(specs)])


def shard_map(fn, mesh: CepMesh, in_specs, out_specs):
    """``fn`` run once per block of the mesh's ``cep`` axis: each argument
    split under its entry of ``in_specs`` (a tuple, one per argument, or
    one spec for all), the outputs joined under ``out_specs`` (one spec,
    or one per output)."""
    d = mesh.shape[CEP_AXIS]

    def sharded(*args):
        specs = (in_specs if isinstance(in_specs, tuple)
                 else (in_specs,) * len(args))
        pieces = [_split(a, s, d) for a, s in zip(args, specs)]
        return _concat([fn(*(p[i] for p in pieces)) for i in range(d)],
                       out_specs)

    return sharded


def shard_fleet_fn(fn, mesh: CepMesh):
    """Shard a per-chunk fleet step: every argument and output leads with
    K (the plain ``process(buffers, chunk, plan, t0, t1, born_lo,
    born_hi)`` and the monitored step, whose clocks are (K,) vectors)."""
    return shard_map(fn, mesh, fleet_pspec(), fleet_pspec())


def shard_fleet_scan(body, mesh: CepMesh):
    """Shard a window's per-chunk body.

    Signature: ``body(buffers, monitor, cur_ops, old_ops, lowered, x) ->
    (buffers, monitor, y)``, ``x`` one chunk's row of a ``SuperchunkXs``.
    State, plan operands and lowered invariants lead with K, and so do
    ``x``'s chunk and migration control; its shared chunk clock and the
    ``enabled`` gate are replicated, so every block runs the same chunk.
    ``y`` leads with K.
    """
    from ..core.scan import SuperchunkXs

    kl = fleet_pspec()
    x_spec = SuperchunkXs(chunk=kl, t0=None, t1=None, enabled=None,
                          born_lo=kl, migrating=kl, old_sel=kl)
    return shard_map(body, mesh, (kl, kl, kl, kl, kl, x_spec), kl)
