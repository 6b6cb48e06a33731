"""Superchunk windows of the port against the JAX package, on the CPU.

``repro_torch.core.fleet.MonitoredFleetRunner(superchunk=S)`` (the window
of ``repro_torch.core.scan``, run eagerly on the CPU) must equal the JAX
package's per-chunk runner bit for bit on the stream of
``tests/test_superchunk.py`` for S in {2, 3, 8, 16}: every counter of
``FleetMetrics``, per-partition matches and deployments, ``last_drift``,
the deployed plans and the replan points; and the JAX package's own
scanned runner at S = 8.  Further runs: tree plans (S = 4), overflow
escalation inside a window, a drifting stream that cuts many windows at
an in-window event (against the port's per-chunk run),
``run(resume=True)`` split inside a window, the ``cep.open(...,
superchunk=8)`` session, and the config's validation.  On a GPU, the
graph-replayed window equals the eager CPU window and the per-chunk run
on the card.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro import cep as jcep
from repro.cep import P as JP
from repro.cep import RuntimeConfig as JConfig
from repro.core import fleet as jfleet
from repro.core.decision import InvariantPolicy as JInvariantPolicy
from repro.core.engine import EngineConfig as JEngineConfig
from repro.data.cep_streams import StreamConfig as JStreamConfig
from repro.data.cep_streams import make_stream as j_make_stream
from repro_torch import cep
from repro_torch.cep import P, RuntimeConfig
from repro_torch.core import fleet, scan
from repro_torch.core.decision import InvariantPolicy
from repro_torch.core.engine import EngineConfig
from repro_torch.data.cep_streams import StreamConfig, make_stream

SCFG = dict(n_types=3, n_chunks=12, chunk_cap=128, base_rate=8.0)
CONFIG = dict(buffer_capacity=64, match_capacity=1024, max_invariants=8,
              max_terms=16)
_COUNTER_FIELDS = (
    "chunks", "events", "full_matches", "pm_created", "overflow",
    "closure_expansions", "neg_rejected", "replans", "deployments",
    "escalations", "migration_partition_chunks", "violations", "host_syncs",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run thousands of small torch ops; with xdist workers on
    a shared CPU, torch's intra-op thread pool only contends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rule(P_):
    return (P_.seq(0, 1, 2)
            .where(P_.attr(0) < P_.attr(1) - 0.3,
                   P_.attr(1) < P_.attr(2) - 0.3)
            .within(4.0))


def streams(k, seed=11, kind="traffic", **scfg):
    cfg = StreamConfig(**dict(SCFG, **scfg))
    return fleet.stacked_streams([
        make_stream(kind, dataclasses.replace(cfg, seed=seed + p))
        for p in range(k)])


def jstreams(k, seed=11, kind="traffic", **scfg):
    cfg = JStreamConfig(**dict(SCFG, **scfg))
    return jfleet.stacked_streams([
        j_make_stream(kind, dataclasses.replace(cfg, seed=seed + p))
        for p in range(k)])


def port_runner(k, superchunk=1, planner="greedy", b_cap=64, m_cap=1024,
                device="cpu"):
    return fleet.MonitoredFleetRunner(
        rule(P).build(), k, planner=planner,
        policy_factory=lambda: InvariantPolicy(k=1, d=0.0),
        engine_cfg=EngineConfig(b_cap=b_cap, m_cap=m_cap, device=device),
        max_inv=8, max_terms=16, seed=0, superchunk=superchunk)


def jax_runner(k, superchunk=1, planner="greedy", b_cap=64, m_cap=1024):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return jfleet.MonitoredFleetRunner(
            rule(JP).build(), k, planner=planner,
            policy_factory=lambda: JInvariantPolicy(k=1, d=0.0),
            engine_cfg=JEngineConfig(b_cap=b_cap, m_cap=m_cap),
            max_inv=8, max_terms=16, seed=0, superchunk=superchunk)


def assert_metrics_identical(got, want):
    """Every deterministic FleetMetrics field, bitwise."""
    for f in _COUNTER_FIELDS:
        assert getattr(got, f) == getattr(want, f), (
            f, getattr(got, f), getattr(want, f))
    assert got.per_partition_matches.tolist() == \
        want.per_partition_matches.tolist()
    assert got.per_partition_deployments.tolist() == \
        want.per_partition_deployments.tolist()
    assert np.array_equal(got.last_drift, want.last_drift)


def assert_same_control(got_runner, want_runner):
    """Deployed plans (the same dataclasses in both packages) and replan
    points."""
    assert [repr(p) for p in got_runner.cur_plans] == \
        [repr(p) for p in want_runner.cur_plans]
    assert np.array_equal(got_runner._replan_t, want_runner._replan_t)


@pytest.fixture(scope="module")
def jax_per_chunk():
    """One JAX per-chunk run shared by the window-size grid."""
    base = jax_runner(4)
    return base, base.run(jstreams(4))


@pytest.mark.parametrize("superchunk", [2, 3, 8, 16])
def test_window_equals_jax_per_chunk(superchunk, jax_per_chunk):
    """Window sizes that straddle, divide and exceed the 12-chunk stream
    reproduce the reference's per-chunk loop exactly."""
    base, want = jax_per_chunk
    runner = port_runner(4, superchunk)
    got = runner.run(streams(4))
    assert_metrics_identical(got, want)
    assert_same_control(runner, base)
    assert want.violations > 0  # the stream exercises the flags


def test_window_equals_jax_scanned():
    """S = 8 against the JAX package's own scanned runner (lax.scan)."""
    jrun = jax_runner(4, superchunk=8)
    want = jrun.run(jstreams(4))
    runner = port_runner(4, superchunk=8)
    got = runner.run(streams(4))
    assert_metrics_identical(got, want)
    assert_same_control(runner, jrun)
    assert got.violations > 0
    assert runner.in_window_events > 0


def test_tree_window_equals_jax_per_chunk():
    """ZStream tree plans through the window (S = 4); a tree step joins
    slot against slot, M x M cells, so the match capacity is 256."""
    jrun = jax_runner(4, planner="zstream", m_cap=256)
    want = jrun.run(jstreams(4))
    runner = port_runner(4, superchunk=4, planner="zstream", m_cap=256)
    got = runner.run(streams(4))
    assert runner.fleet.kind == "tree"
    assert_metrics_identical(got, want)
    assert_same_control(runner, jrun)


def test_escalation_window_equals_jax_per_chunk():
    """Truncated joins re-run at pow2 capacity fire identically through
    the window (an overflow is an in-window event)."""
    want = jax_runner(4, b_cap=32, m_cap=32).run(jstreams(4, seed=7))
    runner = port_runner(4, superchunk=8, b_cap=32, m_cap=32)
    got = runner.run(streams(4, seed=7))
    assert want.escalations > 0  # the capacity truncates
    assert_metrics_identical(got, want)
    assert len(runner._fleets) > 1  # an escalated fleet ran windows


def test_drifting_stream_cuts_windows():
    """Frequent drift: many in-window events, so many windows continue
    from the carry snapshot of a mid-window chunk; that stays exact
    (against the port's per-chunk run)."""
    want = port_runner(4).run(streams(4, 23, "stocks", n_chunks=20))
    runner = port_runner(4, superchunk=8)
    got = runner.run(streams(4, 23, "stocks", n_chunks=20))
    assert_metrics_identical(got, want)
    assert runner.in_window_events > 0
    assert got.migration_partition_chunks > 0  # pass B ran in windows


def test_resume_split_inside_a_window():
    """``run(resume=True)`` split at chunk 5 (not a boundary of 4-chunk
    windows) continues the stream exactly: the two segments add up to one
    run, and the control state ends the same."""
    whole_runner = port_runner(4, superchunk=4)
    whole = whole_runner.run(streams(4))
    chunks = list(streams(4))
    runner = port_runner(4, superchunk=4)
    first = runner.run(chunks[:5])
    second = runner.run(chunks[5:], resume=True)
    for f in _COUNTER_FIELDS:
        assert getattr(first, f) + getattr(second, f) == \
            getattr(whole, f), f
    assert (first.per_partition_matches + second.per_partition_matches
            ).tolist() == whole.per_partition_matches.tolist()
    assert np.array_equal(second.last_drift, whole.last_drift)
    assert_same_control(runner, whole_runner)


def test_session_superchunk_equals_jax_per_chunk():
    """``cep.open(..., monitor=True, superchunk=8).run`` against the JAX
    package's per-chunk session."""
    k = 4
    want = jcep.open(rule(JP), partitions=k, plan="order", monitor=True,
                     config=JConfig(**CONFIG)).run(jstreams(k))
    sess = cep.open(rule(P), partitions=k, plan="order", monitor=True,
                    config=RuntimeConfig(device="cpu", **CONFIG),
                    superchunk=8)
    scan.reset_counts()
    got = sess.run(streams(k))
    for f in ("chunks", "events", "matches", "replans", "deployments",
              "violations", "host_syncs", "overflow", "neg_rejected",
              "closure_expansions", "escalations",
              "migration_partition_chunks"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.per_partition_matches.tolist() == \
        want.per_partition_matches.tolist()
    assert np.array_equal(got.last_drift, want.last_drift)
    # On the CPU the window runs its steps eagerly: one per chunk, plus
    # the chunks after an in-window event, which are dropped.
    assert scan.COUNTS["replays"] == scan.COUNTS["captures"] == 0
    assert scan.COUNTS["eager_steps"] >= got.chunks


def test_window_control_is_the_per_chunk_fold():
    """``window_control`` rolls ``_fold_lapsed`` forward without mutating
    its inputs, in float64."""
    replan_t = np.asarray([fleet.NEG_INF, 2.0, 5.0], np.float64)
    until = np.asarray([fleet.NEG_INF, 6.0, 9.0], np.float64)
    ctl = scan.window_control(replan_t, until, [4.0, 6.0, 9.0], 5)
    assert replan_t.tolist() == [fleet.NEG_INF, 2.0, 5.0]
    assert ctl.migrating[:3].tolist() == [[False, True, True],
                                          [False, False, True],
                                          [False, False, False]]
    assert ctl.old_sel[:3].tolist() == [[False, False, False],
                                        [False, True, False],
                                        [False, True, True]]
    assert ctl.born_lo[0].tolist() == [np.float32(fleet.NEG_INF), 2.0, 5.0]
    assert not ctl.migrating[3:].any()
    assert scan.first_event(ctl.migrating, np.zeros((5, 3)), 3,
                            escalate=False) == 0
    assert scan.first_event(np.zeros((5, 3), bool), np.eye(5, 3), 3,
                            escalate=True) == 0
    assert scan.first_event(np.zeros((5, 3), bool), np.eye(5, 3), 3,
                            escalate=False) is None


def test_superchunk_requires_monitor_on_batch_plane():
    sess = cep.open(rule(P), partitions=2, plan="order", superchunk=8,
                    config=RuntimeConfig(device="cpu"))
    with pytest.raises(ValueError, match="monitor=True"):
        sess.run(list(streams(2)))
    with pytest.raises(ValueError, match="superchunk"):
        RuntimeConfig(superchunk=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("planner", ["greedy", "zstream"])
def test_cuda_graph_window_equals_eager_window(planner, cuda_device):
    """The window replayed from captured CUDA graphs equals the same
    window run eagerly on the CPU, and the per-chunk run on the card, at
    a small size (order and tree plans)."""
    eager = port_runner(4, superchunk=4, planner=planner).run(streams(4))
    scan.reset_counts()
    runner = port_runner(4, superchunk=4, planner=planner, device="cuda")
    got = runner.run(streams(4))
    assert scan.COUNTS["replays"] > 0 and scan.COUNTS["eager_steps"] == 0
    assert_metrics_identical(got, eager)
    per_chunk = port_runner(4, planner=planner, device="cuda").run(
        streams(4))
    assert_metrics_identical(got, per_chunk)


@pytest.mark.gpu
def test_cuda_capture_survives_garbage_collection(cuda_device):
    """A session and its windows form reference cycles, so a dropped
    session's captured graphs are freed by Python's cyclic collector,
    whenever it runs.  Destroying a graph while a stream captures
    invalidates the capture, so the collector is held off during one;
    here it is set to run on nearly every allocation while a new session
    captures, with a dropped session's graphs waiting to be collected
    (the memo dropped too, so the new session captures anew)."""
    import gc

    eager = port_runner(4, superchunk=4).run(streams(4))
    dropped = port_runner(4, superchunk=4, device="cuda")
    dropped.run(streams(4))
    del dropped
    fleet.clear_trace_memo()
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        got = port_runner(4, superchunk=4, device="cuda").run(streams(4))
    finally:
        gc.set_threshold(*old)
    assert_metrics_identical(got, eager)
