"""The port's incremental serving plane against the JAX package, on the
CPU.

``Session.step``, ``step_superchunk``, ``process``, ``deploy``, ``reset``
and ``telemetry()`` of ``repro_torch.cep`` must equal ``repro.cep``'s on
the inputs of ``tests/test_session.py``'s serving tests (plain and
monitored, OR-composites); the serving fronts'
``process_superchunk`` must equal looping ``process_chunk`` (order and
tree plans, plain and monitored); and the port's ``CEPStreamRouter``
must account for every event as the JAX router does on the workload of
``tests/test_serving.py``: ``tick_superchunk(n)`` equals n ticks, and
``submitted == reached + late_dropped + dropped + pending``.
"""

import warnings

import numpy as np
import pytest
import torch

from repro import cep as jcep
from repro.cep import P as JP
from repro.cep import RuntimeConfig as JConfig
from repro.core import fleet as jfleet
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.patterns import chain_predicates as j_chain_predicates
from repro.core.patterns import seq_pattern as j_seq_pattern
from repro.core.plans import OrderPlan as JOrderPlan
from repro.data.cep_streams import StreamConfig as JStreamConfig
from repro.data.cep_streams import make_stream as j_make_stream
from repro.serving import CEPFleetServingEngine as JServing
from repro.serving import CEPStreamRouter as JRouter
from repro_torch import cep
from repro_torch.cep import P, RefEngine, RuntimeConfig
from repro_torch.core import fleet
from repro_torch.core.adaptation import make_planner
from repro_torch.core.engine import EngineConfig
from repro_torch.core.patterns import chain_predicates, seq_pattern
from repro_torch.core.plans import OrderPlan
from repro_torch.core.stats import uniform_stat
from repro_torch.data.cep_streams import StreamConfig, make_stream
from repro_torch.serving import (CEPFleetServingEngine, CEPStreamRouter,
                                 MonitoredCEPFleetServingEngine)

SCFG = dict(n_types=3, n_chunks=10, chunk_cap=128, base_rate=8.0)
CONFIG = dict(buffer_capacity=64, match_capacity=1024, max_invariants=8,
              max_terms=16)
TEL_FIELDS = ("chunks", "events", "matches", "replans", "deployments",
              "violations", "host_syncs", "overflow", "dropped",
              "neg_rejected", "closure_expansions")


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


def records(k, seed=11):
    return [list(make_stream("traffic", StreamConfig(seed=seed + p,
                                                     **SCFG)))
            for p in range(k)]


def jrecords(k, seed=11):
    return [list(j_make_stream("traffic", JStreamConfig(seed=seed + p,
                                                        **SCFG)))
            for p in range(k)]


def sessions(partitions, pattern=rule, plan="order", monitor=False,
             **cfg):
    """The same session in both packages."""
    config = dict(CONFIG, **cfg)
    want = jcep.open(pattern(JP), partitions=partitions, plan=plan,
                     monitor=monitor, config=JConfig(**config))
    got = cep.open(pattern(P), partitions=partitions, plan=plan,
                   monitor=monitor,
                   config=RuntimeConfig(device="cpu", **config))
    return got, want


def assert_same_telemetry(got, want):
    for f in TEL_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    if want.per_partition_matches is None:
        assert got.per_partition_matches is None
    else:
        assert got.per_partition_matches.tolist() == \
            want.per_partition_matches.tolist()
    if want.last_drift is None:
        assert got.last_drift is None
    else:
        assert np.array_equal(got.last_drift, want.last_drift)


def test_step_deploy_reset_matches_jax():
    """step == the oracle and the reference; deploy is a row write;
    reset clears stream state but keeps deployed plans."""
    got, want = sessions(1, policy=None)
    got.deploy(0, OrderPlan((2, 1, 0)))
    want.deploy(0, JOrderPlan((2, 1, 0)))
    recs, jrecs = records(1)[0], jrecords(1)[0]
    per_step = [got.step(r.chunk, r.t0, r.t1).tolist() for r in recs]
    assert per_step == [want.step(r.chunk, r.t0, r.t1).tolist()
                        for r in jrecs]
    oracle = RefEngine(rule(P).build()).run(recs).full_matches
    assert sum(c[0] for c in per_step) == oracle
    assert_same_telemetry(got.telemetry(), want.telemetry())
    assert got.telemetry().deployments == 1

    got.reset()
    want.reset()
    assert got.telemetry().matches == 0
    for r, jr in zip(recs, jrecs):
        got.step(r.chunk, r.t0, r.t1)
        want.step(jr.chunk, jr.t0, jr.t1)
    assert got.telemetry().matches == oracle  # plans survived the reset
    assert_same_telemetry(got.telemetry(), want.telemetry())


def test_monitored_step_and_both_planes_match_jax():
    """Monitored incremental plane (flag -> immediate replan) tick for
    tick, then a batch run on the same session: ``telemetry()`` merges
    both planes as the reference does."""
    k = 4
    got, want = sessions(k, monitor=True)
    tfc = list(fleet.stacked_streams(records(k, seed=31)))
    jfc = list(jfleet.stacked_streams(jrecords(k, seed=31)))
    for fc, jfc_ in zip(tfc, jfc):
        assert got.step(fc.chunk, fc.t0, fc.t1).tolist() == \
            want.step(jfc_.chunk, jfc_.t0, jfc_.t1).tolist()
    tel = got.telemetry()
    assert_same_telemetry(tel, want.telemetry())
    assert tel.violations > 0 and tel.host_syncs == tel.violations
    assert tel.last_drift.shape == (k,)
    got.run(tfc)
    want.run(jfc)
    assert_same_telemetry(got.telemetry(), want.telemetry())


@pytest.mark.parametrize("monitor,k", [(True, 4), (False, 2)])
def test_step_superchunk_matches_jax_and_step(monitor, k):
    """step_superchunk (S = 4) == the reference's step_superchunk == a loop
    of the port's own step ticks."""
    cfg = {} if monitor else dict(policy=None)
    seed = 31 if monitor else 5
    got, want = sessions(k, monitor=monitor, superchunk=4, **cfg)
    stepped, _ = sessions(k, monitor=monitor, **cfg)
    tfc = list(fleet.stacked_streams(records(k, seed=seed)))
    jfc = list(jfleet.stacked_streams(jrecords(k, seed=seed)))
    out = got.step_superchunk([fc.chunk for fc in tfc],
                              [(fc.t0, fc.t1) for fc in tfc])
    assert out.tolist() == want.step_superchunk(
        [fc.chunk for fc in jfc], [(fc.t0, fc.t1) for fc in jfc]).tolist()
    assert out.tolist() == [stepped.step(fc.chunk, fc.t0, fc.t1).tolist()
                            for fc in tfc]
    assert_same_telemetry(got.telemetry(), want.telemetry())
    for f in ("matches", "violations", "replans", "host_syncs", "overflow"):
        assert getattr(got.telemetry(), f) == \
            getattr(stepped.telemetry(), f), f
    if monitor:
        assert got.telemetry().violations > 0
        assert got._serving.in_window_events > 0
        assert np.array_equal(got.telemetry().last_drift,
                              stepped.telemetry().last_drift)


def test_or_composite_process_matches_jax(rng):
    """Keyed batches through a composite session: the aggregated counts
    equal the reference's and the per-branch oracles on the routed
    sub-streams."""
    k = 2
    b1 = lambda P_: P_.seq(0, 1).within(6.0)  # noqa: E731
    b2 = lambda P_: P_.seq(2, 1).within(6.0)  # noqa: E731
    got, want = sessions(k, pattern=lambda P_: P_.or_(b1(P_), b2(P_)),
                         policy=None)
    n = 120
    ts = np.sort(rng.uniform(0, 12, n)).astype(np.float32)
    tid = rng.integers(0, 3, n).astype(np.int32)
    attr = rng.normal(size=(n, 1)).astype(np.float32)
    keys = rng.integers(0, 50, n)
    total = np.zeros(k, np.int64)
    for s in range(3):
        t0, t1 = 4.0 * s, 4.0 * (s + 1)
        m = (ts > t0) & (ts <= t1)
        out = got.process(tid[m], ts[m], attr[m], keys[m], t0, t1)
        assert out.tolist() == want.process(tid[m], ts[m], attr[m],
                                            keys[m], t0, t1).tolist()
        total += out
    oracle = np.zeros(k, np.int64)
    for b in (b1, b2):
        for p in range(k):
            ref = RefEngine(b(P).build())
            sel = (keys % k) == p
            for s in range(3):
                t0, t1 = 4.0 * s, 4.0 * (s + 1)
                m = sel & (ts > t0) & (ts <= t1)
                oracle[p] += ref.process_chunk(tid[m], ts[m], attr[m],
                                               t0, t1).full_matches
    assert total.tolist() == oracle.tolist()
    tel, jtel = got.telemetry(), want.telemetry()
    assert_same_telemetry(tel, jtel)
    for bt, jbt in zip(tel.branches, jtel.branches):
        assert_same_telemetry(bt, jbt)
    with pytest.raises(ValueError, match="ambiguous"):
        got.deploy(0, OrderPlan((0, 1)))


def test_composite_mixed_plane_chunk_accounting_matches_jax():
    """Composite telemetry counts shared input once, across both planes."""
    comp = lambda P_: P_.or_(P_.seq(0, 1).within(5.0),  # noqa: E731
                             P_.seq(2, 1).within(5.0))
    got, want = sessions(1, pattern=comp, policy=None)
    recs, jrecs = records(1, seed=53)[0], jrecords(1, seed=53)[0]
    got.run(recs)
    want.run(jrecs)
    for r, jr in zip(recs[:3], jrecs[:3]):
        assert got.step(r.chunk, r.t0, r.t1).tolist() == \
            want.step(jr.chunk, jr.t0, jr.t1).tolist()
    tel = got.telemetry()
    assert_same_telemetry(tel, want.telemetry())
    assert tel.chunks == len(recs) + 3
    assert tel.events == sum(r.n_events for r in recs)  # step skips events


@pytest.mark.parametrize("kind,monitored", [("order", False),
                                            ("order", True),
                                            ("tree", True)])
def test_process_superchunk_equals_process_chunk(kind, monitored):
    """A serving front's windows (S = 3 over 10 chunks: a short tail)
    equal looping its per-chunk tick, counter for counter."""
    k = 4
    pattern = rule(P).build()
    # A tree step joins slot against slot (M x M cells): a smaller M.
    cfg = EngineConfig(b_cap=64, m_cap=1024 if kind == "order" else 256,
                       device="cpu")

    planner = "greedy" if kind == "order" else "zstream"

    def make(superchunk):
        if monitored:
            return MonitoredCEPFleetServingEngine(
                pattern, k, cfg, kind=kind, planner=planner, max_inv=8,
                max_terms=16, superchunk=superchunk)
        plan0, _ = make_planner(planner)(pattern, uniform_stat(pattern.n))
        return CEPFleetServingEngine(pattern, k, plan0, cfg, kind=kind,
                                     superchunk=superchunk)

    tfc = list(fleet.stacked_streams(records(k, seed=31)))
    windowed, ticked = make(3), make(1)
    out = windowed.process_superchunk([fc.chunk for fc in tfc],
                                      [(fc.t0, fc.t1) for fc in tfc])
    assert out.tolist() == [ticked.process_chunk(fc.chunk, fc.t0,
                                                 fc.t1).tolist()
                            for fc in tfc]
    for f in ("matches", "neg_rejected", "closure_expansions", "overflow"):
        assert getattr(windowed, f).tolist() == getattr(ticked, f).tolist()
    if monitored:
        for f in ("violations", "replans"):
            assert getattr(windowed, f).tolist() == \
                getattr(ticked, f).tolist()
        assert windowed.host_syncs == ticked.host_syncs
        assert np.array_equal(windowed.last_drift, ticked.last_drift)
        assert windowed.violations.sum() > 0
        assert [repr(p) for p in windowed.plans] == \
            [repr(p) for p in ticked.plans]


# ---------------------------------------------------------------------------
# The keyed-stream router (the workload of tests/test_serving.py)
# ---------------------------------------------------------------------------


def _router(superchunk, chunk_cap=64, monitored=False):
    pat = seq_pattern([0, 1, 2], 3.0, chain_predicates([0, 1, 2], theta=0.6))
    cfg = EngineConfig(b_cap=64, m_cap=512, device="cpu")
    if monitored:
        eng = MonitoredCEPFleetServingEngine(
            pat, 2, cfg, chunk_cap=chunk_cap, superchunk=superchunk,
            monitor_buckets=8)
    else:
        eng = CEPFleetServingEngine(pat, 2, OrderPlan((0, 1, 2)), cfg,
                                    chunk_cap=chunk_cap,
                                    superchunk=superchunk)
    return CEPStreamRouter(eng, slice_duration=0.5)


def _jax_router(chunk_cap=64):
    pat = j_seq_pattern([0, 1, 2], 3.0,
                        j_chain_predicates([0, 1, 2], theta=0.6))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = JServing(pat, 2, JOrderPlan((0, 1, 2)),
                       JEngineConfig(b_cap=64, m_cap=512),
                       chunk_cap=chunk_cap)
    return JRouter(eng, slice_duration=0.5)


def _submit_workload(routers, rng, n=180, t_hi=4.25):
    """Random keyed events, including late (ts <= 0), slice-edge-exact and
    far-future timestamps, submitted identically to every router."""
    ts = rng.uniform(-0.5, t_hi, n).astype(np.float32)
    ts[:4] = [0.0, 0.5, 1.0, 2.5]      # exactly on slice edges
    tid = rng.integers(0, 3, n).astype(np.int32)
    keys = rng.integers(0, 7, n)
    attr = rng.normal(size=(n, 1)).astype(np.float32)
    for i in range(n):
        for r in routers:
            r.submit(keys[i], tid[i], ts[i], attr[i])
    return n


def _assert_conserved(router, submitted):
    """Every submitted event is accounted for exactly once."""
    reached = router.routed - router.engine.dropped
    assert submitted == (reached + router.late_dropped
                         + router.engine.dropped + router.pending)


def test_router_superchunk_ticks_equal_sequential_and_jax(rng):
    """``tick_superchunk(4)`` is accounting-identical to 4 ticks, in the
    port and against the JAX router's ticks: same matches, same late
    drops, same capacity drops, same queue."""
    seq, sup, ref = _router(1), _router(4), _jax_router()
    submitted = 0
    # A second round crosses the superchunk boundary with carried state.
    for n, t_hi in ((180, 4.25), (60, 4.5)):
        submitted += _submit_workload((seq, sup, ref), rng, n=n, t_hi=t_hi)
        full_seq = np.stack([seq.tick() for _ in range(4)])
        full_ref = np.stack([ref.tick() for _ in range(4)])
        full_sup = sup.tick_superchunk(4)
        np.testing.assert_array_equal(full_seq, full_sup)
        np.testing.assert_array_equal(full_ref, full_sup)
    for r in (seq, sup):
        assert r.late_dropped == ref.late_dropped > 0
        assert r.routed == ref.routed
        assert r.pending == ref.pending
        assert r.engine.dropped == ref.engine.dropped
        np.testing.assert_array_equal(r.engine.matches, ref.engine.matches)
        assert r.slices == 8
        _assert_conserved(r, submitted)
    assert seq.monitor_telemetry() is None


def test_router_drop_conservation(rng):
    """A tiny chunk capacity clips events; every one is still accounted
    for, per tick and per superchunk."""
    for superchunk in (1, 4):
        router = _router(superchunk, chunk_cap=8)
        submitted = _submit_workload((router,), rng, n=150)
        if superchunk == 1:
            for _ in range(4):
                router.tick()
        else:
            router.tick_superchunk(4)
        _assert_conserved(router, submitted)
        assert router.engine.dropped > 0     # the tiny cap clips
    with pytest.raises(ValueError, match="n >= 1"):
        router.tick_superchunk(0)


def test_router_superchunk_monitored_engine(rng):
    """The monitored serving engine behind ``tick_superchunk`` agrees with
    the per-tick monitored router on matches, drops and telemetry."""
    seq, sup = _router(1, monitored=True), _router(2, monitored=True)
    submitted = _submit_workload((seq, sup), rng)
    full_seq = np.stack([seq.tick() for _ in range(4)])
    full_sup = sup.tick_superchunk(4)
    np.testing.assert_array_equal(full_seq, full_sup)
    assert seq.late_dropped == sup.late_dropped
    assert seq.routed == sup.routed
    np.testing.assert_array_equal(seq.engine.matches, sup.engine.matches)
    a, b = seq.monitor_telemetry(), sup.monitor_telemetry()
    for f in ("violations", "replans", "last_drift"):
        np.testing.assert_array_equal(a[f], b[f])
    assert a["host_syncs"] == b["host_syncs"]
    _assert_conserved(sup, submitted)
