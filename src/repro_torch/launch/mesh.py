"""Device meshes over ``torch.distributed`` process groups.

The port of ``repro.launch.mesh``.  ``make_host_mesh(data, model)`` is a
("data", "model") mesh over the first ``data * model`` ranks of the
default process group, which the caller initializes (every rank calls
``make_host_mesh`` with the same arguments: it creates the groups).  One
default group made with ``backend="cpu:gloo,cuda:nccl"`` serves CPU
tensors through gloo and CUDA tensors through NCCL, so one mesh carries
both; a CPU-only build of torch has no NCCL and takes ``"gloo"``.

``make_production_mesh`` keeps the reference's production shapes: (16,
16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
"model") with ``multi_pod``; it needs that many ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.engine import resolve_device


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A mesh of ranks: ``shape`` ({axis name: size}, in axis order, what
    ``distributed.sharding.MeshRules`` reads), the ``DeviceMesh`` behind
    it, and the device this rank computes on.  ``coordinate`` is this
    rank's index along each axis (None off the mesh)."""

    device_mesh: object
    device: torch.device
    all_group: object = None    # the process group of all the mesh's ranks

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The device of each rank of the mesh, in rank order (ranks of
        one host, one GPU each, or the CPU)."""
        ranks = self.device_mesh.mesh.flatten().tolist()
        if self.device.type == "cuda":
            return tuple(torch.device("cuda", r) for r in ranks)
        return tuple(torch.device(self.device.type) for _ in ranks)

    @property
    def coordinate(self) -> Optional[Dict[str, int]]:
        c = self.device_mesh.get_coordinate()
        return None if c is None else dict(zip(self.axis_names, c))

    def get_group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` (one axis: its line; every
        axis of the mesh: all of its ranks)."""
        axes = tuple(axes)
        if len(axes) == 1:
            return self.get_group(axes[0])
        if set(axes) != set(self.axis_names):
            raise ValueError(f"groups span one axis or all of "
                             f"{self.axis_names}; got {axes}")
        return self.all_group


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device) -> HostMesh:
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group (gloo on the CPU, "
            "'cpu:gloo,cuda:nccl' with GPUs) on every rank first")
    if dev.type == "cuda":
        dev = torch.device("cuda", dist.get_rank()
                           % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(dev)
    n = math.prod(shape)
    ranks = torch.arange(n, dtype=torch.int64).view(*shape)
    mesh = DeviceMesh(dev.type, ranks, mesh_dim_names=axes)
    everyone = (dist.group.WORLD if n == dist.get_world_size()
                else dist.new_group(ranks=list(range(n))))
    return HostMesh(mesh, dev, everyone)


def make_host_mesh(data: int = 1, model: int = 1,
                   device="cuda") -> HostMesh:
    """Small ("data", "model") mesh over the first ``data * model`` ranks
    (tests, examples, one host)."""
    n = data * model
    if _world() < n:
        raise RuntimeError(f"need {n} ranks, have {_world()}")
    return _mesh((data, model), ("data", "model"), device)


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh's ``{axis name: size}``, in axis order."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> HostMesh:
    named = production_mesh_shape(multi_pod)
    shape, axes = tuple(named.values()), tuple(named)
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(
            f"production mesh needs {n} ranks, found {_world()}; start "
            f"{n} processes (one per GPU) and initialize the default "
            "process group before building it")
    return _mesh(shape, axes, device)
