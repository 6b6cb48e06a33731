"""Device meshes over ``torch.distributed`` process groups.

The port of ``repro.launch.mesh``.  ``make_host_mesh(data, model)`` is a
("data", "model") mesh over the first ``data * model`` ranks of the
default process group, which the caller initializes (every rank calls
``make_host_mesh`` with the same arguments: it creates the groups).  One
default group made with ``backend="cpu:gloo,cuda:nccl"`` serves CPU
tensors through gloo and CUDA tensors through NCCL, so one mesh carries
both; a CPU-only build of torch has no NCCL and takes ``"gloo"``.

On CUDA each rank takes one GPU of its host: the rank with local rank
``l`` (``LOCAL_RANK``, as torchrun and ``run_ranks`` set it) computes on
``cuda:l``, and more ranks on a host than it has GPUs are refused (NCCL
does not run two ranks on one GPU).  ``run_ranks(fn, world, *args)``
starts the ranks of one host that way: over NCCL and gloo where torch
sees a GPU, over gloo alone where it does not.

``make_production_mesh`` keeps the reference's production shapes: (16,
16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
"model") with ``multi_pod``; it needs that many ranks.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import socket
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
            per_host = local_ranks()[1]
            return tuple(torch.device("cuda", r % per_host) for r in ranks)
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


def local_ranks() -> Tuple[int, int]:
    """(this rank's index on its host, the number of ranks on its host):
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` where the launcher set them
    (torchrun, ``run_ranks``), else one host holding the whole default
    group."""
    if "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        return (int(os.environ["LOCAL_RANK"]),
                int(os.environ["LOCAL_WORLD_SIZE"]))
    return dist.get_rank(), dist.get_world_size()


def local_gpu(local_rank: int, per_host: int) -> torch.device:
    """The GPU of the rank with index ``local_rank`` among ``per_host``
    ranks of one host: ``cuda:local_rank``.  NCCL takes one rank per GPU,
    so more ranks on a host than it has GPUs are refused (never two ranks
    on one card)."""
    count = torch.cuda.device_count()
    if per_host > count:
        raise RuntimeError(
            f"{per_host} ranks on a host with {count} GPUs: NCCL takes one "
            f"rank per GPU; start at most {count} ranks on it")
    return torch.device("cuda", local_rank)


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device) -> HostMesh:
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group (gloo on the CPU, "
            "'cpu:gloo,cuda:nccl' with GPUs) on every rank first")
    if dev.type == "cuda":
        dev = local_gpu(*local_ranks())
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


# ---------------------------------------------------------------------------
# Ranks of one host
# ---------------------------------------------------------------------------

# The default group's backend for ranks on GPUs: gloo carries CPU tensors,
# NCCL CUDA ones.  A CPU-only build of torch has no NCCL: "gloo" there.
GPU_BACKEND = "cpu:gloo,cuda:nccl"



def free_port() -> int:
    """A free TCP port on 127.0.0.1 (the ranks' rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, out_dir, backend, timeout, fn, args):
    try:
        torch.set_num_threads(1)
        os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        if "nccl" in backend:                 # before the group's first use
            torch.cuda.set_device(local_gpu(rank, world))
        # The parent's limit decides first; the group's is a backstop.
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout + 30))
        try:
            result = fn(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _rank_errors(out_dir, world) -> List[Tuple[float, int, str]]:
    """(time, rank, traceback) of every rank that raised, first first."""
    errs = []
    for r in range(world):
        path = os.path.join(out_dir, f"{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                t, tb = f.read().split("\n", 1)
            errs.append((float(t), r, tb))
    return sorted(errs)


def run_ranks(fn: Callable, world: int, *args,
              backend: Optional[str] = None,
              timeout: float = 240.0) -> List:
    """Runs ``fn(rank, world, *args)`` in ``world`` new processes of this
    host and returns their results in rank order.

    Each process is started with the spawn method (CUDA is touched only
    in the children), sets one torch thread and its ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (its rank and ``world``: one host), and joins a
    default process group of ``backend`` (unless given, ``GPU_BACKEND``
    where torch sees a GPU, else ``"gloo"``; ``"gloo"`` keeps every rank
    on the CPU) on 127.0.0.1 at a free port, with a timeout on its
    collectives; with NCCL in ``backend`` rank ``r`` runs on ``cuda:r``
    and ``world`` may not exceed the GPU count (``local_gpu``).  ``fn`` is a module-level function of an
    importable module (the children import it); its results travel back
    as pickles this call wrote itself (numpy arrays, not tensors).  A rank
    that raises fails the call with a ``RuntimeError`` that holds the
    traceback of every rank that raised, the first first (a rank's fault
    makes its peers' collectives fail after it); a call still running
    after ``timeout`` seconds raises ``TimeoutError``.  Either way every
    process is stopped before it returns."""
    import torch.multiprocessing as mp

    if backend is None:
        backend = GPU_BACKEND if torch.cuda.is_available() else "gloo"
    if "nccl" in backend:
        local_gpu(0, world)             # refused here, before any spawn
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(world, free_port(), out_dir, backend, timeout,
                              fn, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            errs = _rank_errors(out_dir, world)
            if not errs:
                raise
            raise RuntimeError(
                f"{len(errs)} of {world} ranks raised, the first first:\n"
                + "\n".join(f"-- rank {r}:\n{tb}" for _, r, tb in errs)
            ) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
