"""The port's single-stream ``MonitoredEngine`` against the JAX package's,
on the CPU.

The stream of ``tests/test_monitor.py::test_monitored_single_stream_engine``
(stocks, three types, 15 chunks) goes through both engines, chunk by
chunk, with the same plan row and the same lowered invariant set; when
the flag fires, each side replans from its own synced statistics and
lowers the new invariant set.  The ``StepResult`` counters, ``violated``,
``drift``, ``rates``, ``sel`` and the chunks that replan must be equal,
for order plans (greedy) and tree plans (ZStream).  On the port, the
fused flag must also equal the host float32 mirror (``check_lowered_np``)
and the host policy's decision, and at least one flag must fire.
"""

import numpy as np
import pytest
import torch

from repro.core.compat import legacy_ok as j_legacy_ok
from repro.core.decision import InvariantPolicy as JInvariantPolicy
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import MonitoredEngine as JMonitoredEngine
from repro.core.greedy import greedy_order_plan as j_greedy
from repro.core.patterns import chain_predicates as j_chain
from repro.core.patterns import seq_pattern as j_seq
from repro.core.stats import Stat as JStat
from repro.core.stats import uniform_stat as j_uniform_stat
from repro.core.zstream import zstream_tree_plan as j_zstream
from repro.data.cep_streams import StreamConfig as JStreamConfig
from repro.data.cep_streams import make_stream as j_make_stream
from repro_torch.core.compat import legacy_ok
from repro_torch.core.decision import InvariantPolicy
from repro_torch.core.engine import EngineConfig, MonitoredEngine
from repro_torch.core.greedy import greedy_order_plan
from repro_torch.core.invariants import check_lowered_np
from repro_torch.core.patterns import chain_predicates, seq_pattern
from repro_torch.core.stats import Stat, uniform_stat
from repro_torch.core.zstream import zstream_tree_plan
from repro_torch.data.cep_streams import StreamConfig, make_stream

SCFG = dict(n_types=3, n_chunks=15, chunk_cap=128, base_rate=8.0, seed=3)
CFG = dict(b_cap=64, m_cap=512)
# Tree invariant sets grow with the statistics: fixed caps (the JAX
# tests') keep one shape across redeployments.
CAPS = {"order": (), "tree": (8, 16)}
PLANNERS = {"order": (greedy_order_plan, j_greedy),
            "tree": (zstream_tree_plan, j_zstream)}
COUNTERS = ("full_matches", "pm_created", "overflow", "closure_expansions",
            "neg_rejected")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pattern(seq, chain):
    return seq([0, 1, 2], 4.0, chain([0, 1, 2], theta=-0.3))


def drive(kind, eng, planner, pol_cls, stat_cls, uniform, stream,
          n, to_np):
    """Run ``eng`` over ``stream`` with flag-triggered replans; returns one
    record per chunk: (counters, violated, drift, rates, sel, lowered set,
    the host policy's decision on the synced statistics) and the replan
    chunks."""
    state, mon = eng.init_state(), eng.init_monitor()
    stat0 = uniform(n)
    plan, dcs = planner(eng.pattern, stat0)
    pol = pol_cls(k=1, d=0.0)
    pol.on_replan(plan, dcs, stat0)
    low = pol.compile(n, *CAPS[kind])
    caps = CAPS[kind] or (low.active.shape[0], low.scale.shape[-1])
    recs, replans = [], []
    for i, rec in enumerate(stream):
        state, mon, res, violated, drift, rates, sel = eng.process_chunk(
            state, mon, rec.chunk, eng.plan_row(plan), low, rec.t0, rec.t1)
        rates, sel = to_np(rates), to_np(sel)
        flag = bool(to_np(violated))
        synced = stat_cls(np.asarray(rates, np.float64),
                          np.asarray(sel, np.float64))
        recs.append((tuple(int(to_np(getattr(res, f))) for f in COUNTERS),
                     flag, to_np(drift), rates, sel, low,
                     pol.should_reoptimize(synced)))
        if flag:
            replans.append(i)
            plan, dcs = planner(eng.pattern, synced)
            pol.on_replan(plan, dcs, synced)
            low = pol.compile(n, *caps)
    return recs, replans


def port_drive(kind, device="cpu"):
    pat = pattern(seq_pattern, chain_predicates)
    with legacy_ok():
        eng = MonitoredEngine(kind, pat, EngineConfig(device=device, **CFG))
    return drive(kind, eng, PLANNERS[kind][0], InvariantPolicy, Stat,
                 uniform_stat, make_stream("stocks", StreamConfig(**SCFG)),
                 pat.n, lambda x: x.cpu().numpy())


def jax_drive(kind):
    pat = pattern(j_seq, j_chain)
    with j_legacy_ok():
        eng = JMonitoredEngine(kind, pat, JEngineConfig(**CFG))
    return drive(kind, eng, PLANNERS[kind][1], JInvariantPolicy, JStat,
                 j_uniform_stat,
                 j_make_stream("stocks", JStreamConfig(**SCFG)), pat.n,
                 np.asarray)


@pytest.fixture(scope="module")
def jax_baseline():
    return {kind: jax_drive(kind) for kind in CAPS}


@pytest.fixture(scope="module")
def port_runs():
    return {kind: port_drive(kind) for kind in CAPS}


@pytest.mark.parametrize("kind", list(CAPS))
def test_monitored_engine_matches_jax(kind, jax_baseline, port_runs):
    recs, replans = port_runs[kind]
    jrecs, jreplans = jax_baseline[kind]
    assert replans == jreplans
    assert len(recs) == len(jrecs) == SCFG["n_chunks"]
    for i, (got, want) in enumerate(zip(recs, jrecs)):
        assert got[0] == want[0], (i, "counters")
        assert got[1] == want[1], (i, "violated")
        assert np.array_equal(got[2], want[2]), (i, "drift")
        assert np.array_equal(got[3], want[3]), (i, "rates")
        assert np.array_equal(got[4], want[4]), (i, "sel")


@pytest.mark.parametrize("kind", list(CAPS))
def test_fused_flags_equal_host_checks(kind, port_runs):
    """The K = 1 building block: the fused step's flag equals the host
    float32 mirror of the lowered set and the host policy's decision on
    the synced statistics; the stream makes it fire."""
    recs, replans = port_runs[kind]
    for _, flag, drift, rates, sel, low, host in recs:
        v_np, drift_np = check_lowered_np(low, rates, sel)
        assert flag == bool(v_np)
        assert (drift > 0) == flag
        # the float64 host policy may differ only on an exact f32 tie
        assert host == flag or abs(drift_np) < 1e-5
    assert replans


def test_shapes_and_state_axis():
    """Counters and monitoring outputs come back without the K axis; the
    buffers and the statistics ring keep their leading K = 1."""
    pat = pattern(seq_pattern, chain_predicates)
    with legacy_ok():
        eng = MonitoredEngine("order", pat, EngineConfig(device="cpu", **CFG))
    plan, dcs = greedy_order_plan(pat, uniform_stat(pat.n))
    pol = InvariantPolicy(k=1, d=0.0)
    pol.on_replan(plan, dcs, uniform_stat(pat.n))
    rec = next(iter(make_stream("stocks", StreamConfig(**SCFG))))
    state, mon, res, violated, drift, rates, sel = eng.process_chunk(
        eng.init_state(), eng.init_monitor(), rec.chunk, eng.plan_row(plan),
        pol.compile(pat.n), rec.t0, rec.t1)
    assert all(getattr(res, f).shape == () for f in COUNTERS)
    assert violated.shape == drift.shape == ()
    assert rates.shape == (3,) and sel.shape == (3, 3)
    assert state.ts.shape[0] == mon.head.shape[0] == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(CAPS))
def test_cuda_monitored_engine_equals_cpu(cuda_device, kind, port_runs):
    recs, replans = port_drive(kind, device="cuda")
    want, want_replans = port_runs[kind]
    assert replans == want_replans
    for got, w in zip(recs, want):
        assert got[:2] == w[:2]
        assert np.array_equal(got[2], w[2])
