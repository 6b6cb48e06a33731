"""The port's single-stream adaptive loop (Algorithm 1) against the JAX
package's, on the CPU.

``repro_torch.core.adaptation.AdaptiveRunner`` and
``repro.core.adaptation.AdaptiveRunner`` consume the same seeded streams
(greedy order plans under the static, unconditional and invariant
policies, with the regret measured; ZStream trees under the invariant
policy at d=0.1; adaptive match capacities that escalate on overflow; an
OR-composite through ``CompositeAdaptiveRunner`` and ``merge_metrics``).
Every integer ``RunMetrics`` field must be equal, and the regret must
agree to 1e-9 relative.  The properties of ``tests/test_adaptation.py``
are checked on the port's runs: matches do not depend on the policy, the
invariant policy at d=0 has no false positives, and a migration detects
each match exactly once.  A ``gpu`` case holds the card's run (the CUDA
kernels) against the CPU run (the plain versions).
"""

import pytest
import torch

from repro.core.adaptation import AdaptiveRunner as JAdaptiveRunner
from repro.core.adaptation import CompositeAdaptiveRunner as JComposite
from repro.core.adaptation import merge_metrics as j_merge_metrics
from repro.core.decision import make_policy as j_make_policy
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.patterns import CompositePattern as JCompositePattern
from repro.core.patterns import chain_predicates as j_chain
from repro.core.patterns import seq_pattern as j_seq
from repro.data.cep_streams import StreamConfig as JStreamConfig
from repro.data.cep_streams import make_stream as j_make_stream
from repro_torch.core import AdaptiveRunner, EngineConfig, make_policy
from repro_torch.core.adaptation import (CompositeAdaptiveRunner,
                                         RunMetrics, merge_metrics)
from repro_torch.core.patterns import (CompositePattern, chain_predicates,
                                       seq_pattern)
from repro_torch.data.cep_streams import StreamConfig, make_stream

INT_FIELDS = ("chunks", "events", "full_matches", "pm_created", "overflow",
              "closure_expansions", "replans", "deployments",
              "false_positives", "migration_chunks", "condition_checks",
              "regret_samples")
# The traffic stream shifts regime every ~6 chunks, so the greedy plan
# changes within 24 chunks (deployments and migrations on the grid).
SCFG = dict(n_types=4, n_attrs=1, n_chunks=24, chunk_cap=128,
            base_rate=15.0, seed=3, shift_every=6.0)
CAPS = dict(b_cap=64, m_cap=512)
GREEDY_POLICIES = {"static": {}, "unconditional": {},
                   "invariant": dict(k=1, d=0.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of small torch ops; with xdist workers on a shared CPU,
    torch's intra-op thread pool only contends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def seq4(seq, chain):
    return seq([0, 1, 2, 3], window=4.0,
               predicates=chain([0, 1, 2, 3], theta=-0.3))


def composite(seq, chain, comp):
    return comp((seq([0, 1], 4.0, chain([0, 1], theta=-0.3)),
                 seq([2, 3], 4.0, chain([2, 3], theta=-0.3))))


PAT = seq4(seq_pattern, chain_predicates)
JPAT = seq4(j_seq, j_chain)


def assert_same_metrics(got, want):
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.regret == pytest.approx(want.regret, rel=1e-9, abs=0.0)


# One JAX baseline for the module: every case below runs the reference
# once.
CASES = {
    # greedy order plans, each policy, the regret measured alongside
    **{f"greedy-{p}": dict(planner="greedy", policy=(p, kw),
                           measure_regret=True)
       for p, kw in GREEDY_POLICIES.items()},
    # ZStream trees on the tree engine, on a stream that makes the
    # invariant policy replan twice (migrations of tree plans)
    "zstream-invariant": dict(planner="zstream",
                              policy=("invariant", dict(k=1, d=0.1)),
                              scfg=dict(SCFG, seed=6, shift_every=4.0)),
    # adaptive capacities: bounds low enough that overflow escalates
    "greedy-caps": dict(planner="greedy",
                        policy=("invariant", dict(k=1, d=0.0)),
                        kind="stocks", ecfg=dict(b_cap=64, m_cap=64),
                        adaptive_caps=True, cap_bounds=(64, 128)),
}


def _policy_obj(factory, spec):
    name, kw = spec
    return factory(name, **kw)


def _run(side, case, device="cpu"):
    """One case through the JAX runner (``side="jax"``) or the port's on
    ``device``: (runner, metrics)."""
    spec = dict(CASES[case])
    pol = spec.pop("policy")
    planner = spec.pop("planner")
    kind = spec.pop("kind", "traffic")
    ecfg = spec.pop("ecfg", CAPS)
    scfg = spec.pop("scfg", SCFG)
    if side == "jax":
        r = JAdaptiveRunner(JPAT, planner=planner,
                            policy=_policy_obj(j_make_policy, pol),
                            engine_cfg=JEngineConfig(**ecfg), **spec)
        return r, r.run(j_make_stream(kind, JStreamConfig(**scfg)))
    r = AdaptiveRunner(PAT, planner=planner,
                       policy=_policy_obj(make_policy, pol),
                       engine_cfg=EngineConfig(device=device, **ecfg),
                       **spec)
    return r, r.run(make_stream(kind, StreamConfig(**scfg)))


@pytest.fixture(scope="module")
def jax_runs():
    return {case: _run("jax", case) for case in CASES}


@pytest.fixture(scope="module")
def port_runs():
    return {case: _run("port", case) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_run_metrics_match_jax(case, jax_runs, port_runs):
    assert_same_metrics(port_runs[case][1], jax_runs[case][1])


def test_matches_are_policy_independent(port_runs):
    """Adaptation must never change WHAT is detected, only how fast."""
    ms = [port_runs[f"greedy-{p}"][1] for p in GREEDY_POLICIES]
    assert len({m.full_matches for m in ms}) == 1
    assert all(m.overflow == 0 for m in ms)
    assert ms[0].full_matches > 0


def test_invariant_zero_false_positives_d0(port_runs):
    m = port_runs["greedy-invariant"][1]
    assert m.false_positives == 0  # Theorem 1 in the full loop
    assert 0 < m.replans <= m.chunks
    mz = port_runs["zstream-invariant"][1]
    assert mz.false_positives == 0 and mz.deployments > 0
    assert mz.migration_chunks > 0


def test_migration_no_duplicate_detection(port_runs):
    """The unconditional policy migrates repeatedly; the match count must
    still equal the static run's (exactly once under the [36] split)."""
    ms = port_runs["greedy-static"][1]
    mu = port_runs["greedy-unconditional"][1]
    assert ms.full_matches == mu.full_matches
    assert mu.migration_chunks > 0 and mu.deployments > 0


def test_regret_measurement(port_runs):
    ms = port_runs["greedy-static"][1]
    mi = port_runs["greedy-invariant"][1]
    assert 0 < ms.regret_samples <= ms.chunks
    assert ms.regret > 0.0
    # The adaptive run tracks the optimum at least as well as static.
    assert mi.regret <= ms.regret + 1e-9


def test_escalation_buckets_match_jax(jax_runs, port_runs):
    """Overflow escalated through the same pow2 buckets as the reference,
    each bucket's engine on the runner's device, with the runner's buffer
    capacity and backend; no overflow is left after escalation."""
    runner, m = port_runs["greedy-caps"]
    jrunner, _ = jax_runs["greedy-caps"]
    assert sorted(runner._engines) == sorted(jrunner._engines)
    assert len(runner._engines) > 1
    assert runner._cap_floor == jrunner._cap_floor > 64
    for cap, eng in runner._engines.items():
        assert eng.cfg == EngineConfig(b_cap=64, m_cap=cap, device="cpu")
        assert eng.device == torch.device("cpu")
    assert m.overflow == 0


def test_composite_runner_and_merge_match_jax():
    def streams(scfg_cls, make):
        return [make("traffic", scfg_cls(**dict(SCFG, seed=s)))
                for s in (5, 6)]

    runner = CompositeAdaptiveRunner(
        composite(seq_pattern, chain_predicates, CompositePattern),
        planner="greedy", policy=None,
        engine_cfg=EngineConfig(device="cpu", **CAPS))
    jrunner = JComposite(composite(j_seq, j_chain, JCompositePattern),
                         planner="greedy", policy=None,
                         engine_cfg=JEngineConfig(**CAPS))
    # composite branches need their own policies
    for r in runner.runners:
        r.policy = make_policy("invariant")
    for r in jrunner.runners:
        r.policy = j_make_policy("invariant")
    ms = runner.run(streams(StreamConfig, make_stream))
    jms = jrunner.run(streams(JStreamConfig, j_make_stream))
    for got, want in zip(ms, jms):
        assert_same_metrics(got, want)
    total = merge_metrics(ms)
    assert_same_metrics(total, j_merge_metrics(jms))
    assert total.chunks == 2 * SCFG["n_chunks"]
    assert isinstance(total, RunMetrics)
    with pytest.raises(ValueError, match="one stream per branch"):
        runner.run(streams(StreamConfig, make_stream)[:1])


def test_cuda_default_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdaptiveRunner(PAT, policy=make_policy("static"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["greedy-unconditional", "zstream-invariant",
                                  "greedy-caps"])
def test_cuda_run_equals_cpu(cuda_device, case, port_runs):
    """The loop on the card (the CUDA kernels, escalated engines on the
    card too) gives the CPU run's integer metrics."""
    runner, m = _run("port", case, device="cuda")
    assert_same_metrics(m, port_runs[case][1])
    assert all(e.device.type == "cuda" for e in runner._engines.values())
