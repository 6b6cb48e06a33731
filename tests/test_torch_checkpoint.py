"""The port's checkpoint manager (``repro_torch.checkpoint``) on the CPU.

The eight cases of ``tests/test_checkpoint.py`` run on the port (the
cross-mesh case as a restore onto ``device="cpu"``), on the reference
test's ``make_state`` in torch.  Both managers write the same files, so
a checkpoint the JAX manager wrote restores in the port, and the other
way round, bit for bit (bf16 included), with equal manifests.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, init_state


def make_state(v=1.0):
    return {
        "a": torch.full((4, 3), v, dtype=torch.float32),
        "nested": {"b": torch.full((2,), v * 2, dtype=torch.bfloat16),
                   "c": torch.tensor(7, dtype=torch.int32)},
    }


def make_jax_state(v=1.0):
    return {
        "a": jnp.full((4, 3), v, jnp.float32),
        "nested": {"b": jnp.full((2,), v * 2, jnp.bfloat16),
                   "c": jnp.asarray(7, jnp.int32)},
    }


def leaves(state):
    return [state["a"], state["nested"]["b"], state["nested"]["c"]]


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = make_state(1.5)
    mgr.save(10, state)
    got = mgr.restore(make_state(0.0))
    for a, b in zip(leaves(state), leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, make_state(float(s)))
    assert mgr.steps() == [3, 4]
    got = mgr.restore(make_state(0.0))
    assert float(got["a"][0, 0]) == 4.0


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, make_state(1.0))
    mgr.save(2, make_state(2.0))
    got = mgr.restore(make_state(0.0), step=1)
    assert float(got["a"][0, 0]) == 1.0


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = make_state(5.0)
    mgr.save_async(5, state)
    state["a"].fill_(-1.0)  # after the snapshot: not in the checkpoint
    mgr.wait()
    assert mgr.latest_step() == 5
    assert float(mgr.restore(make_state(0.0))["a"][0, 0]) == 5.0


def test_no_tmp_left_behind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state())
    with pytest.raises(ValueError):
        mgr.restore({"a": torch.zeros((4, 3))})


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state())
    bad = make_state()
    bad["a"] = torch.zeros((5, 5))
    with pytest.raises(ValueError):
        mgr.restore(bad)


def test_restore_onto_a_device(tmp_path):
    """The cross-mesh case on one host: leaves are saved as full host
    arrays and placed on the device asked for, whatever ``like`` holds."""
    mgr = CheckpointManager(str(tmp_path))
    state = make_state(2.0)
    mgr.save(1, state)
    got = mgr.restore({"a": np.zeros((4, 3)), "nested": {
        "b": np.zeros(2), "c": np.zeros(())}}, device="cpu")
    assert all(t.device == torch.device("cpu") for t in leaves(got))
    assert torch.equal(got["a"], state["a"])


def test_async_writer_error_is_raised_by_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    # A file where the step directory's parent should be: the writer's
    # makedirs fails in the thread, and ``wait`` re-raises it.
    mgr.dir = str(tmp_path / "not_a_dir")
    open(mgr.dir, "w").close()
    mgr.save_async(1, make_state())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error is raised once


def manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    JCheckpointManager(str(tmp_path / "j")).save(3, make_jax_state(1.25))
    CheckpointManager(str(tmp_path / "t")).save(3, make_state(1.25))
    assert manifest(tmp_path / "j", 3) == manifest(tmp_path / "t", 3)
    got = CheckpointManager(str(tmp_path / "j")).restore(make_state(0.0))
    for a, b in zip(leaves(make_state(1.25)), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_restores_in_jax(tmp_path):
    CheckpointManager(str(tmp_path)).save(4, make_state(-3.5))
    got = JCheckpointManager(str(tmp_path)).restore(make_jax_state(0.0))
    for a, b in zip(jax.tree.leaves(make_jax_state(-3.5)),
                    jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))


def test_optimizer_state_paths_match_jax(tmp_path):
    """A ``(params, AdamWState)`` pair flattens to the paths JAX gives the
    same structure (NamedTuple fields by name, ``()`` holds no leaf)."""
    from repro.train.optimizer import AdamWConfig as JAdamWConfig
    from repro.train.optimizer import init_state as jinit_state

    params = {"w": torch.ones(3), "b": torch.zeros(2)}
    jparams = {"w": jnp.ones(3), "b": jnp.zeros(2)}
    CheckpointManager(str(tmp_path / "t")).save(
        1, (params, init_state(AdamWConfig(), params)))
    JCheckpointManager(str(tmp_path / "j")).save(
        1, (jparams, jinit_state(JAdamWConfig(), jparams)))
    assert manifest(tmp_path / "t", 1) == manifest(tmp_path / "j", 1)
