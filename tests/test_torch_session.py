"""``repro_torch.cep.open(...).run`` against ``repro.cep.open(...).run``.

On the per-chunk order rows of the ``tests/test_session.py`` grid
(monitor on and off, K in {1, 4}), every integer field of the port's
``Telemetry`` must equal the reference's, and so must ``last_drift`` and
the runners' ``FleetMetrics.pm_created`` (join work).  The tree rows and
the tree resume split are in ``tests/test_torch_session_tree.py``, which
imports the helpers here.  Further runs cover a flag-triggered replan,
overflow escalation (with de-escalation on deploy), a ``plan="auto"`` that
resolves to tree, and streams split across ``run(..., resume=True)``.  A subprocess checks that
importing the port and the benchmark twins loads neither jax nor any
module of the JAX package or a JAX harness.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro import cep as jcep
from repro.cep import P as JP
from repro.cep import RuntimeConfig as JConfig
from repro.core import fleet as jfleet
from repro.core.decision import InvariantPolicy as JInvariantPolicy
from repro.core.decision import make_policy as j_make_policy
from repro.core.engine import EngineConfig as JEngineConfig
from repro.data.cep_streams import StreamConfig as JStreamConfig
from repro.data.cep_streams import make_stream as j_make_stream
from repro_torch import cep
from repro_torch.cep import P, RefEngine, RuntimeConfig
from repro_torch.core import fleet
from repro_torch.core.decision import InvariantPolicy, make_policy
from repro_torch.core.engine import EngineConfig
from repro_torch.data.cep_streams import StreamConfig, make_stream
from repro_torch.distributed import CepMesh

INT_FIELDS = ("chunks", "events", "matches", "replans", "deployments",
              "violations", "host_syncs", "overflow", "dropped",
              "neg_rejected", "closure_expansions", "escalations",
              "migration_partition_chunks")
SCFG = dict(n_types=3, n_chunks=10, chunk_cap=128, base_rate=8.0)
CONFIG = dict(buffer_capacity=64, match_capacity=1024, max_invariants=8,
              max_terms=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rule(P_):
    return (P_.seq(0, 1, 2)
            .where(P_.attr(0) < P_.attr(1) - 0.3,
                   P_.attr(1) < P_.attr(2) - 0.3)
            .within(4.0))


def streams(k, seed=11, scfg=SCFG):
    return [make_stream("traffic", StreamConfig(seed=seed + p, **scfg))
            for p in range(k)]


def jstreams(k, seed=11, scfg=SCFG):
    return [j_make_stream("traffic", JStreamConfig(seed=seed + p, **scfg))
            for p in range(k)]


def assert_same_telemetry(got, want):
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.per_partition_matches.tolist() == \
        want.per_partition_matches.tolist()
    if want.last_drift is None:
        assert got.last_drift is None
    else:
        assert np.array_equal(got.last_drift, want.last_drift)


def run_both(monitor, k, config=CONFIG, seed=11, scfg=SCFG, plan="order"):
    want = jcep.open(rule(JP), partitions=k, plan=plan, monitor=monitor,
                     config=JConfig(**config)).run(jstreams(k, seed, scfg))
    got = cep.open(rule(P), partitions=k, plan=plan, monitor=monitor,
                   config=RuntimeConfig(device="cpu", **config)).run(
        streams(k, seed, scfg))
    assert_same_telemetry(got, want)
    return got


@pytest.mark.parametrize("monitor,k", [(False, 1), (False, 4), (True, 1),
                                       (True, 4)])
def test_session_grid_matches_jax(monitor, k):
    tel = run_both(monitor, k)
    oracle = [RefEngine(rule(P).build()).run(s).full_matches
              for s in streams(k)]
    assert tel.per_partition_matches.tolist() == oracle
    assert tel.chunks == SCFG["n_chunks"]
    if monitor:
        assert tel.host_syncs == tel.violations


def _runner_join_work(monitor, planner):
    """``FleetMetrics.pm_created`` (and every other counter) of the
    runners behind the sessions, built with the same knobs."""
    k = 4
    pattern_j, pattern_t = rule(JP).build(), rule(P).build()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if monitor:
            legacy = jfleet.MonitoredFleetRunner(
                pattern_j, k, planner=planner,
                policy_factory=lambda: JInvariantPolicy(),
                engine_cfg=JEngineConfig(b_cap=64, m_cap=1024),
                max_inv=8, max_terms=16)
        else:
            legacy = jfleet.FleetRunner(
                pattern_j, k, planner=planner,
                policy_factory=lambda: j_make_policy("invariant"),
                engine_cfg=JEngineConfig(b_cap=64, m_cap=1024))
    cfg = EngineConfig(b_cap=64, m_cap=1024, device="cpu")
    if monitor:
        port = fleet.MonitoredFleetRunner(
            pattern_t, k, planner=planner,
            policy_factory=lambda: InvariantPolicy(),
            engine_cfg=cfg, max_inv=8, max_terms=16)
    else:
        port = fleet.FleetRunner(
            pattern_t, k, planner=planner,
            policy_factory=lambda: make_policy("invariant"),
            engine_cfg=cfg)
    want = legacy.run(jfleet.stacked_streams(jstreams(k)))
    got = port.run(fleet.stacked_streams(streams(k)))
    for f in ("chunks", "events", "full_matches", "pm_created", "overflow",
              "closure_expansions", "neg_rejected", "replans",
              "deployments", "escalations", "migration_partition_chunks",
              "violations", "host_syncs"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.pm_created > 0
    assert got.per_partition_deployments.tolist() == \
        want.per_partition_deployments.tolist()
    assert port.fleet.kind == ("order" if planner == "greedy" else "tree")


@pytest.mark.parametrize("monitor", [False, True])
def test_runner_join_work_matches_jax(monitor):
    _runner_join_work(monitor, "greedy")


def test_flag_triggered_replans_match_jax():
    """Shocks every few chunks fire device flags; replans, deployments and
    the [36] migration split must land on the reference's chunks."""
    scfg = dict(SCFG, n_chunks=14, shift_every=3.0)
    tel = run_both(True, 4, seed=40, scfg=scfg)
    assert tel.violations > 0 and tel.deployments > 0
    assert tel.migration_partition_chunks > 0


def test_escalation_matches_jax():
    """A match capacity at the buffer size overflows: the pow2 escalation
    recounts (and de-escalates on deploy) exactly as the reference."""
    scfg = dict(SCFG, base_rate=24.0, shift_every=4.0)
    config = dict(CONFIG, match_capacity=64, max_escalations=3)
    tel = run_both(True, 4, config=config, seed=3, scfg=scfg)
    assert tel.escalations > 0
    tel = run_both(False, 2, config=config, seed=3, scfg=scfg)
    assert tel.escalations > 0


def _resume_split(plan):
    k = 4
    jsess = jcep.open(rule(JP), partitions=k, plan=plan, monitor=True,
                      config=JConfig(**CONFIG))
    tsess = cep.open(rule(P), partitions=k, plan=plan, monitor=True,
                     config=RuntimeConfig(device="cpu", **CONFIG))
    jfc = list(jfleet.stacked_streams(jstreams(k)))
    tfc = list(fleet.stacked_streams(streams(k)))
    for lo, hi, resume in ((0, 6, False), (6, 10, True)):
        assert_same_telemetry(tsess.run(tfc[lo:hi], resume=resume),
                              jsess.run(jfc[lo:hi], resume=resume))
    whole = cep.open(rule(P), partitions=k, plan=plan, monitor=True,
                     config=RuntimeConfig(device="cpu", **CONFIG)).run(tfc)
    assert tsess.telemetry().matches == whole.matches
    assert tsess.telemetry().replans == whole.replans


def test_resume_split_matches_jax_and_one_run():
    _resume_split("order")


def test_plan_resolution_and_deferred_features():
    from repro.cep.session import _resolve_plan_kind as j_resolve
    from repro_torch.cep.session import _resolve_plan_kind

    patterns = [rule, lambda p: p.seq(0, 1).within(5.0),
                lambda p: p.and_(0, 1, 2, 3).within(2.0),
                lambda p: p.seq(0, 1, 2, 3, 4).within(9.0)]
    for build in patterns:
        assert _resolve_plan_kind(build(P).build(), "auto") == \
            j_resolve(build(JP).build(), "auto")
    cfg = RuntimeConfig(device="cpu")
    # plan="tree" runs the ZStream planner on the tree engine, as the
    # reference does.
    tsess = cep.open(rule(P), plan="tree", config=cfg)
    jsess = jcep.open(rule(JP), plan="tree", config=JConfig())
    assert (tsess.plan_kind, tsess.planner_name) == \
        (jsess.plan_kind, jsess.planner_name) == ("tree", "zstream")
    assert_same_telemetry(tsess.run(streams(1)), jsess.run(jstreams(1)))
    with pytest.raises(ValueError, match="monitor=True"):
        cep.open(rule(P), plan="order", config=cfg, superchunk=4).run(
            streams(1))
    with pytest.raises(ValueError, match="superchunk"):
        RuntimeConfig(device="cpu", superchunk=0)
    # A D=1 mesh opens (tests/test_torch_sharding.py runs it), and so
    # does a split over two blocks that share the CPU: each block's state
    # on its mesh device (tests/test_torch_mesh.py runs every front).
    assert cep.open(rule(P), plan="order", config=cfg, mesh="auto")
    two = CepMesh((torch.device("cpu"),) * 2)
    sess = cep.open(rule(P), partitions=2, plan="order", config=cfg,
                    mesh=two)
    eng = sess._ensure_serving()
    assert eng.fleet.mesh.shape == {"cep": 2}
    assert [b.ts.device for b in eng.state] == list(two.devices)
    with pytest.raises(ValueError, match="devices"):
        cep.open(rule(P), partitions=2, plan="order", config=cfg, mesh=2)
    assert RuntimeConfig().device == "cuda"


def test_auto_resolving_to_tree_matches_jax(monkeypatch):
    """``plan="auto"`` runs whatever it resolves to.  Under the uniform
    prior it always resolves to order (every prefix cardinality is at most
    1, so the order cost is at most n, below the tree's n leaves plus its
    joins); a skewed cold-start prior, patched into both packages alike,
    makes the ZStream tree cheaper, and the session then runs tree plans
    exactly as the reference does."""
    import repro.cep.session as jsession
    import repro_torch.cep.session as tsession
    from repro.core.stats import Stat as JStat
    from repro_torch.core.stats import Stat

    rates = np.asarray([21.7460507, 27.85126413, 21.96285929, 9.03248628])
    monkeypatch.setattr(jsession, "uniform_stat",
                        lambda n: JStat(rates, np.ones((n, n))))
    monkeypatch.setattr(tsession, "uniform_stat",
                        lambda n: Stat(rates, np.ones((n, n))))

    def rule4(P_):
        return (P_.seq(0, 1, 2, 3)
                .where(P_.attr(1) < P_.attr(2) + 0.3)
                .within(3.0))

    scfg = dict(SCFG, n_types=4, n_chunks=6)
    k = 2
    jsess = jcep.open(rule4(JP), partitions=k, plan="auto",
                      config=JConfig(**CONFIG))
    tsess = cep.open(rule4(P), partitions=k, plan="auto",
                     config=RuntimeConfig(device="cpu", **CONFIG))
    assert tsess.plan_kind == jsess.plan_kind == "tree"
    assert tsess.planner_name == "zstream"
    tel = tsess.run(streams(k, scfg=scfg))
    assert_same_telemetry(tel, jsess.run(jstreams(k, scfg=scfg)))
    assert tel.per_partition_matches.tolist() == [
        RefEngine(rule4(P).build()).run(s).full_matches
        for s in streams(k, scfg=scfg)]


def test_cuda_default_without_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cep.open(rule(P), partitions=2, plan="order")


def test_or_composite_session_sums_branches():
    k = 2
    b_seq = rule(P)
    b_and = P.and_(0, 2).where(abs(P.attr(0) - P.attr(1)) <= 1.0).within(3.0)
    cfg = RuntimeConfig(device="cpu", **CONFIG)
    tel = cep.open(P.or_(b_seq, b_and), partitions=k, plan="order",
                   config=cfg).run(streams(k, seed=23))
    want = [np.asarray([RefEngine(b.build()).run(s).full_matches
                        for s in streams(k, seed=23)])
            for b in (b_seq, b_and)]
    assert tel.per_partition_matches.tolist() == sum(want).tolist()
    assert tel.chunks == SCFG["n_chunks"]


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port and every benchmark twin
    (``benchmarks/torch_*.py``) loads no jax, no module of the JAX package
    and no JAX harness (checked in a fresh interpreter)."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    modules = [
        "repro_torch", "repro_torch.adaptive",
        "repro_torch.adaptive.batching", "repro_torch.adaptive.placement",
        "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
        "repro_torch.cep",
        "repro_torch.cep.config",
        "repro_torch.cep.dsl", "repro_torch.cep.rulebook",
        "repro_torch.cep.session",
        "repro_torch.core", "repro_torch.core.adaptation",
        "repro_torch.core.compat",
        "repro_torch.core.convert", "repro_torch.core.decision",
        "repro_torch.core.engine", "repro_torch.core.fleet",
        "repro_torch.core.greedy", "repro_torch.core.invariants",
        "repro_torch.core.multipattern",
        "repro_torch.core.patterns", "repro_torch.core.plans",
        "repro_torch.core.ref_engine", "repro_torch.core.scan",
        "repro_torch.core.spans",
        "repro_torch.core.stats", "repro_torch.core.zstream",
        "repro_torch.configs", "repro_torch.configs.dbrx_132b",
        "repro_torch.configs.deepseek_moe_16b",
        "repro_torch.configs.mamba2_1p3b",
        "repro_torch.configs.musicgen_large", "repro_torch.configs.olmo_1b",
        "repro_torch.configs.paligemma_3b",
        "repro_torch.configs.phi3_mini_3p8b",
        "repro_torch.configs.stablelm_12b", "repro_torch.configs.yi_34b",
        "repro_torch.configs.zamba2_1p2b",
        "repro_torch.data", "repro_torch.data.cep_streams",
        "repro_torch.data.lm_data",
        "repro_torch.data.scenarios", "repro_torch.data.scenarios.base",
        "repro_torch.data.scenarios.citibike",
        "repro_torch.data.scenarios.flowsense",
        "repro_torch.data.scenarios.fraud",
        "repro_torch.distributed", "repro_torch.distributed.collectives",
        "repro_torch.distributed.sharding",
        "repro_torch.kernels", "repro_torch.kernels.ops",
        "repro_torch.kernels.ref", "repro_torch.kernels.window_join",
        "repro_torch.launch", "repro_torch.launch.cost",
        "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
        "repro_torch.launch.serve", "repro_torch.launch.shapes",
        "repro_torch.launch.train",
        "repro_torch.models", "repro_torch.models.config",
        "repro_torch.models.layers", "repro_torch.models.model",
        "repro_torch.models.moe", "repro_torch.models.params",
        "repro_torch.models.ssm",
        "repro_torch.serving", "repro_torch.serving.engine",
        "repro_torch.serving.scheduler",
        "repro_torch.train", "repro_torch.train.optimizer",
        "repro_torch.train.train_step",
    ]
    # The benchmark twins: none may load jax, repro or a JAX harness.
    twins = [
        "benchmarks.torch_adaptive_moe", "benchmarks.torch_common",
        "benchmarks.torch_dsl_trees", "benchmarks.torch_fig5_distance", "benchmarks.torch_fig69_methods",
        "benchmarks.torch_fleet_bench", "benchmarks.torch_kernel_bench",
        "benchmarks.torch_perf_iter", "benchmarks.torch_replay_bench",
        "benchmarks.torch_roofline", "benchmarks.torch_rulebook_bench",
        "benchmarks.torch_run", "benchmarks.torch_table1_davg",
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules + twins!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') or "
        "(m.startswith('benchmarks.') and "
        "not m.startswith('benchmarks.torch_')))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    root = os.path.abspath(os.path.join(src, ".."))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(src), root]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
    # Every twin under benchmarks/ is in the list above.
    assert {"benchmarks." + f[:-3] for f in
            os.listdir(os.path.join(root, "benchmarks"))
            if f.startswith("torch_") and f.endswith(".py")} == set(twins)
    # Every module of the package is in the list above.
    pkg = os.path.join(os.path.abspath(src), "repro_torch")
    found = {
        "repro_torch" + ("." + os.path.relpath(os.path.join(d, f), pkg)
                         [:-3].replace(os.sep, ".")).replace(".__init__", "")
        for d, _, files in os.walk(pkg) for f in files if f.endswith(".py")}
    assert found == set(modules)
