"""Helpers of the port's distribution tests: gloo ranks and JAX meshes.

``run_ranks(fn, world, *args)`` is the port's
``repro_torch.launch.mesh.run_ranks``: ``world`` spawned processes on
127.0.0.1 (a free port), each with one torch thread and a default
process group of gloo and NCCL (rank ``r`` on ``cuda:r``) where torch
sees a GPU, else of gloo; the tests of gloo ranks on the CPU pass
``backend="gloo"``, the ``gpu`` tests ``backend=GPU_BACKEND``.  Each rank
calls ``fn(rank, world, *args)`` (``fn`` a
module-level function of an importable module: spawned workers import
it); it returns the per-rank results.  ``one_rank_mesh`` is the card's
one-rank NCCL group and mesh (the ``gpu`` tests).  ``start_jax(code,
n_devices, out)`` starts a Python subprocess with ``n_devices`` host
devices, running ``code`` (which writes its arrays to the ``.npz`` path
``OUT``); ``finish_jax`` waits for it and loads the arrays.  A test
module starts its JAX subprocess, runs its ranks while JAX computes, then
waits: one of each per module.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import numpy as np

from repro_torch.launch.mesh import (  # noqa: F401 (re-exported)
    GPU_BACKEND, free_port, run_ranks)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")


@contextlib.contextmanager
def one_rank_mesh(device="cuda"):
    """A one-rank default group (gloo for CPU tensors, NCCL for CUDA ones)
    and a (1, 1) mesh over it, on ``device``; the group is destroyed
    after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group(
        GPU_BACKEND, init_method=f"tcp://127.0.0.1:{free_port()}",
        world_size=1, rank=0)
    try:
        yield make_host_mesh(1, 1, device=device)
    finally:
        dist.destroy_process_group()


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
