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
rule: split K over the ``cep`` axis into D contiguous blocks of K/D,
block ``i`` on ``mesh.devices[i]``, and replicate the rest (the shared
chunk clock, a rulebook's rule rows and lattice routing).  No collective
is needed.  The reference does this with ``shard_map`` over one global
array; the port keeps each block resident on its own device as a
:class:`Blocks` value and runs one step per block (``core/fleet.py``:
one engine per block, built for the block's device; ``core/scan.py``:
one window, with its own statics and CUDA graphs, per block).  Per chunk
only each block's slice of the chunk goes up, straight to its device,
and the host reads its counters, flags and drift back block by block
(``to_host``, ``block_row``): no state is gathered to one device or
copied between devices.

``mesh=`` is ``None``, ``"auto"`` (every distinct device of the plane's
type), an int count of distinct devices, or a :class:`CepMesh`.  Only an
explicit ``CepMesh`` may repeat a device (``CepMesh((cpu, cpu))``,
``CepMesh((cuda:0,) * 4)``): D blocks then share one device.  That is the
port's counterpart of the reference's
``--xla_force_host_platform_device_count``, and the only way to run
D > 1 on the CPU or on one card.  A D = 1 mesh runs the blocked code
path with one block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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
    ``Mesh``).  A device may repeat: D blocks then share it."""

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
    :class:`CepMesh` carrying a ``cep`` axis.  ``"auto"`` and an int count
    distinct devices, so ``mesh=2`` on a one-GPU host raises, as in the
    reference.  Every device of the mesh is of the data plane's type, and
    the K-partition axis must divide evenly over it: an uneven split would
    silently unbalance per-partition semantics, so it raises, as in the
    reference.  A bare ``cuda`` device gets its index.
    """
    from ..core.engine import canonical_device

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
    devs = tuple(canonical_device(x) for x in m.devices)
    return m if devs == m.devices else CepMesh(devs, m.axis_names)


# ---------------------------------------------------------------------------
# Blocks: a meshed fleet's K-led values, one block per mesh device
# ---------------------------------------------------------------------------


class Blocks(tuple):
    """A K-led value of a meshed fleet as its D blocks: block ``i`` holds
    partitions ``[i K/D, (i+1) K/D)`` on ``mesh.devices[i]``.

    Every K-led leaf a meshed fleet carries between chunks is held so:
    ring buffers, statistics rings, plan operands, lowered invariant rows,
    a rulebook's state and plan rows.  A replicated value (a rulebook's
    rule rows, lattice routing) is held as one copy per device, shared by
    the blocks on it.  No block is joined with the others or moved to
    another device: the host reads them block by block (``to_host``,
    ``block_row``)."""

    __slots__ = ()

    def __repr__(self):
        return f"Blocks{tuple.__repr__(self)}"


def map_blocks(fn, *args):
    """``fn`` once per block, in block order: a ``Blocks`` argument gives
    its block, any other is passed to every block as it is (None, or a
    host value).  ``fn`` returns a tuple; each position comes back as
    ``Blocks`` (None where every block returned None)."""
    d = next(len(a) for a in args if isinstance(a, Blocks))
    outs = [fn(*(a[i] if isinstance(a, Blocks) else a for a in args))
            for i in range(d)]
    return tuple(None if all(o[j] is None for o in outs)
                 else Blocks(o[j] for o in outs)
                 for j in range(len(outs[0])))


def per_block(fn, x):
    """``fn(x)``, or ``Blocks`` of ``fn`` of each block of a ``Blocks``
    ``x`` (once for a block shared by several, as a replica is)."""
    if not isinstance(x, Blocks):
        return fn(x)
    done = {}
    for p in x:
        if id(p) not in done:
            done[id(p)] = fn(p)
    return Blocks(done[id(p)] for p in x)


def to_host(fn, *args, axis: int = 0) -> np.ndarray:
    """``fn(*args)``, a tensor, as numpy.  On ``Blocks`` arguments ``fn``
    runs per block (``map_blocks``' rule) and each block's result is read
    in its own device-to-host transfer, the blocks joined along ``axis``
    (where K lies in ``fn``'s result)."""
    if not any(isinstance(a, Blocks) for a in args):
        return fn(*args).cpu().numpy()
    parts = map_blocks(lambda *xs: (fn(*xs),), *args)[0]
    return np.concatenate([p.cpu().numpy() for p in parts], axis=axis)


def block_row(x, p: int):
    """Partition ``p``'s row of a K-led tensor: from the block that owns
    it when ``x`` is ``Blocks``."""
    if not isinstance(x, Blocks):
        return x[p]
    kb = x[0].shape[0]
    return x[p // kb][p % kb]


class BlockLayout:
    """Where a meshed fleet's partitions live: K split into D contiguous
    blocks of K/D, block ``i`` on ``mesh.devices[i]``."""

    def __init__(self, mesh: CepMesh, k: int):
        self.devices = tuple(mesh.devices)
        self.d = len(self.devices)
        self.kb = k // self.d
        self.slices = tuple(slice(i * self.kb, (i + 1) * self.kb)
                            for i in range(self.d))

    def owner(self, p: int) -> Tuple[int, int]:
        """(block, row in the block) of partition ``p``."""
        return divmod(int(p), self.kb)

    def split(self, x, axis: int = 0) -> list:
        """A K-led host array's D blocks (views); a scalar, or an array
        whose ``axis`` does not exist, is every block's."""
        a = np.asarray(x)
        if a.ndim <= axis:
            return [x] * self.d
        return [a[(slice(None),) * axis + (s,)] for s in self.slices]

    def upload(self, arrays: Sequence, shared: Sequence = ()) -> "Blocks":
        """K-led host arrays as ``Blocks`` of lists of tensors: each block's
        slices, followed by the ``shared`` arrays whole, go straight to its
        device in one host-to-device copy."""
        from ..core.scan import _upload

        per = [self.split(a) for a in arrays]
        return Blocks(_upload([p[i] for p in per] + list(shared), dev)
                      for i, dev in enumerate(self.devices))

    def replicate(self, arrays: Sequence) -> "Blocks":
        """Host arrays placed once per device (one copy each), as
        ``Blocks`` of lists of tensors: blocks on one device share it."""
        from ..core.scan import _upload

        placed: Dict[torch.device, list] = {}
        for dev in self.devices:
            if dev not in placed:
                placed[dev] = _upload(arrays, dev)
        return Blocks(placed[dev] for dev in self.devices)

    def build(self, fn) -> "Blocks":
        """``Blocks(fn(K/D, device) for each block)``: a K-led value made
        on the blocks' devices."""
        return Blocks(fn(self.kb, dev) for dev in self.devices)
