"""Helpers of the port's distribution tests: gloo ranks and JAX meshes.

``run_ranks(fn, world, *args)`` spawns ``world`` processes on
127.0.0.1 (a free port), each with a gloo default process group and one
torch thread, calls ``fn(rank, world, *args)`` in each (``fn`` a
module-level function of an importable module: spawned workers import
it) and returns the per-rank results, which travel as pickles this run
wrote itself.  ``one_rank_mesh`` is the card's one-rank NCCL group and
mesh (the ``gpu`` tests).  ``start_jax(code, n_devices, out)`` starts a
Python subprocess with ``n_devices`` host devices, running ``code``
(which writes its arrays to the ``.npz`` path ``OUT``); ``finish_jax``
waits for it and loads the arrays.  A test module starts its JAX subprocess,
runs its ranks while JAX computes, then waits: one of each per module.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, out_dir, fn, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


@contextlib.contextmanager
def one_rank_mesh(device="cuda"):
    """A one-rank default group (gloo for CPU tensors, NCCL for CUDA ones)
    and a (1, 1) mesh over it, on ``device``; the group is destroyed
    after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group(
        "cpu:gloo,cuda:nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
        world_size=1, rank=0)
    try:
        yield make_host_mesh(1, 1, device=device)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 240.0) -> list:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(world, free_port(), out_dir, fn, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


_JAX_PRELUDE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {src!r})
OUT = {out!r}
"""


def start_jax(code: str, n_devices: int, out: str) -> subprocess.Popen:
    prelude = _JAX_PRELUDE.format(n=n_devices, src=SRC, out=out)
    return subprocess.Popen(
        [sys.executable, "-c", prelude + code], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_jax(proc: subprocess.Popen, out: str, timeout: float = 300.0):
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"JAX subprocess failed:\n{stderr[-3000:]}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def flat(tree, prefix=()):
    """A nested dict of arrays as {"a/b/c": array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def nest(flat_tree):
    """The inverse of ``flat``."""
    out = {}
    for key, v in flat_tree.items():
        node = out
        parts = key.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return out
