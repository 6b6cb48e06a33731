"""The tree rows of ``tests/test_torch_session.py``'s grid:
``repro_torch.cep.open(..., plan="tree").run`` against
``repro.cep.open(..., plan="tree").run`` (ZStream planner, tree engine;
monitor on and off, K in {1, 4}), and the tree runners' join work
(``FleetMetrics.pm_created`` and every other counter) against the
reference's runners, and a tree session's stream split across
``run(..., resume=True)``.  A file of their own, so that the session
tests and these run on two workers (each compiles its plan family's JAX
programs once).
"""

import pytest
import torch

from repro_torch.cep import P, RefEngine
from test_torch_session import SCFG, _resume_split, _runner_join_work, \
    rule, run_both, streams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("monitor,k", [(False, 1), (False, 4), (True, 1),
                                       (True, 4)])
def test_tree_session_grid_matches_jax(monitor, k):
    """The tree rows of the grid: ZStream planner, tree engine."""
    tel = run_both(monitor, k, plan="tree")
    oracle = [RefEngine(rule(P).build()).run(s).full_matches
              for s in streams(k)]
    assert tel.per_partition_matches.tolist() == oracle
    assert tel.chunks == SCFG["n_chunks"]
    if monitor:
        assert tel.host_syncs == tel.violations


@pytest.mark.parametrize("monitor", [False, True])
def test_tree_runner_join_work_matches_jax(monitor):
    _runner_join_work(monitor, "zstream")


def test_tree_resume_split_matches_jax_and_one_run():
    _resume_split("tree")
