"""The port's ``cep`` device mesh against the JAX package's, on the CPU.

``repro_torch.distributed.sharding`` splits the K-partition axis over a
1-D mesh: D contiguous blocks of K/D partitions, each resident on its
mesh device and run by its own engine, the rest replicated.  Partitions
are independent, so a meshed run must equal the unmeshed one count for
count, and both the JAX package's run (whose own tests hold its meshed
runs equal to its per-chunk ones): the fleet runner with
``superchunk=8`` (``tests/test_superchunk.py::test_sharded_d1_run_smoke``),
the serving plane's ``step_superchunk`` (``test_sharded_d1_serving_smoke``),
and the rulebook per chunk and in windows
(``tests/test_rulebook.py::test_mesh_d1_path_matches``,
``tests/test_rulebook_superchunk.py::test_superchunk_mesh_d1_matches``),
all at D = 1 (one CPU).  ``resolve_cep_mesh`` keeps the reference's
errors (``test_mesh_validation``) and adds the port's: a mesh on another
device type than the data plane; an explicit mesh may repeat a device.
The split rule itself is held at D = 2 over two CPU blocks through the
meshed ``FleetEngine``'s step directly (D > 1 on every front:
``tests/test_torch_mesh.py``).  On a GPU, meshed windows on the card
equal the unmeshed ones.
"""

import jax
import numpy as np
import pytest
import torch

from repro import cep as jcep
from repro.cep import P as JP
from repro.cep import RuntimeConfig as JConfig
from repro.cep.rulebook import open_rulebook as j_open_rulebook
from repro.core import fleet as jfleet
from repro.distributed.sharding import cep_mesh as j_cep_mesh
from repro.distributed.sharding import resolve_cep_mesh as j_resolve
from repro_torch import cep
from repro_torch.cep import P, RuntimeConfig, open_rulebook
from repro_torch.core import fleet
from repro_torch.core.decision import InvariantPolicy
from repro_torch.core.engine import EngineConfig
from repro_torch.distributed import (Blocks, CepMesh, cep_mesh,
                                     resolve_cep_mesh)

from test_torch_rulebook import CFG, K, jchunk, make_chunks, rule_pool
from test_torch_superchunk import (CONFIG, assert_metrics_identical,
                                   jax_runner, jstreams, port_runner, rule,
                                   streams)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def _memos_as_found():
    """Both packages' memos start empty here and are left as found: the
    JAX memo shares traces across this process's tests, and a trace this
    module leaves behind would hide a retrace that another module's test
    counts."""
    saved = [(m, list(m.items())) for m in (jfleet._TRACE_MEMO,
                                            fleet._TRACE_MEMO)]
    for m, _ in saved:
        m.clear()
    yield
    for m, items in saved:
        m.clear()
        m.update(items)


def meshed_runner(k, superchunk, mesh, device="cpu"):
    """``port_runner`` with a mesh (the runner takes it, as the
    reference's does)."""
    return fleet.MonitoredFleetRunner(
        rule(P).build(), k, planner="greedy",
        policy_factory=lambda: InvariantPolicy(k=1, d=0.0),
        engine_cfg=EngineConfig(b_cap=64, m_cap=1024, device=device),
        max_inv=8, max_terms=16, seed=0, superchunk=superchunk, mesh=mesh)


@pytest.fixture(scope="module")
def jax_baseline():
    """The JAX package's per-chunk runs, once per module (its own tests
    hold its meshed and windowed runs equal to them): the K=4 fleet
    runner, the K=2 serving plane's ``step`` loop, and the 2-rule
    rulebook's ``step`` loop."""
    recs = list(jstreams(2, seed=31))
    sess = jcep.open(rule(JP), partitions=2, plan="order", monitor=True,
                     config=JConfig(**CONFIG))
    jrb = j_open_rulebook(rule_pool(JP)[:2], partitions=K, monitor=True,
                          config=JConfig(**CFG))
    return {
        "run": jax_runner(4).run(jstreams(4)),
        "serving": np.stack([np.asarray(sess.step(fc.chunk, fc.t0, fc.t1))
                             for fc in recs]),
        "rulebook": (np.stack([np.asarray(jrb.step(jchunk(c), t0, t1))
                               for c, _, t0, t1 in make_chunks(0, 6)]),
                     np.asarray(jrb.match_counts))}


def test_mesh_validation():
    """``tests/test_superchunk.py::test_mesh_validation`` on the port: the
    same mesh sizes and errors as the JAX package, plus the port's device
    check; an explicit mesh that repeats a device resolves."""
    d, jd = len(cep_mesh(device="cpu").devices), len(jax.devices())
    assert d == jd == 1
    mesh = cep_mesh(device="cpu")
    assert resolve_cep_mesh(None, 4, "cpu") is None
    assert j_resolve(None, 4) is None
    assert resolve_cep_mesh("auto", 4 * d, "cpu").shape["cep"] == d == \
        j_resolve("auto", 4 * jd).shape["cep"]
    assert resolve_cep_mesh(1, 3, "cpu").shape == {"cep": 1}
    assert resolve_cep_mesh(mesh, 4 * d, "cpu") is mesh
    jmesh = j_cep_mesh()
    assert j_resolve(jmesh, 4 * jd) is jmesh
    with pytest.raises(ValueError, match="cep"):
        resolve_cep_mesh(CepMesh((CPU,), ("data",)), 4, "cpu")
    with pytest.raises(TypeError):
        resolve_cep_mesh(3.5, 4, "cpu")
    with pytest.raises(TypeError):
        j_resolve(3.5, 4)
    with pytest.raises(ValueError, match="devices"):
        cep_mesh(4096, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        j_cep_mesh(4096)
    with pytest.raises(ValueError, match="devices"):
        resolve_cep_mesh(2, 4, "cpu")
    two = CepMesh((CPU, CPU))
    with pytest.raises(ValueError, match="divide"):
        resolve_cep_mesh(two, 3, "cpu")
    assert resolve_cep_mesh(two, 4, "cpu") is two
    assert resolve_cep_mesh(two, 4, "cpu").shape == {"cep": 2}
    # The mesh lies on the data plane's device type, either way round.
    with pytest.raises(ValueError, match="device type"):
        resolve_cep_mesh(mesh, 4, "cuda")
    with pytest.raises(ValueError, match="device type"):
        resolve_cep_mesh(CepMesh((torch.device("cuda", 0),)), 4, "cpu")
    with pytest.raises(ValueError, match="devices"):
        cep.open(rule(P), partitions=4, plan="order",
                 config=RuntimeConfig(device="cpu"), mesh=2)


def test_sharded_d1_run_smoke(jax_baseline):
    """The D=1 mesh runs the sharded code path; results equal the
    unsharded run and the JAX package's."""
    plain = port_runner(4, superchunk=8).run(streams(4))
    runner = meshed_runner(4, 8, 1)
    shard = runner.run(streams(4))
    assert runner.fleet.mesh.shape == {"cep": 1}
    assert_metrics_identical(shard, plain)
    assert_metrics_identical(shard, jax_baseline["run"])
    assert shard.violations > 0 and runner.in_window_events > 0


def test_sharded_d1_serving_smoke(jax_baseline):
    recs = list(streams(2, seed=31))
    chunks = [fc.chunk for fc in recs]
    edges = [(fc.t0, fc.t1) for fc in recs]
    cfg = RuntimeConfig(device="cpu", **CONFIG)
    plain = cep.open(rule(P), partitions=2, plan="order", monitor=True,
                     config=cfg, superchunk=4)
    shard = cep.open(rule(P), partitions=2, plan="order", monitor=True,
                     config=cfg, superchunk=4, mesh=1)
    got = shard.step_superchunk(chunks, edges)
    assert got.tolist() == plain.step_superchunk(chunks, edges).tolist()
    assert got.tolist() == jax_baseline["serving"].tolist()
    assert shard._serving.fleet.mesh is not None


def test_mesh_d1_path_matches(jax_baseline):
    rules = rule_pool(P)[:2]
    chunks = make_chunks(0, 6)
    rb_mesh = open_rulebook(rules, partitions=K, monitor=True,
                            config=RuntimeConfig(device="cpu", mesh=1,
                                                 **CFG))
    rb_plain = open_rulebook(rules, partitions=K, monitor=True,
                             config=RuntimeConfig(device="cpu", **CFG))
    got = np.stack([rb_mesh.step(stacked, t0, t1)
                    for stacked, _, t0, t1 in chunks])
    for stacked, _, t0, t1 in chunks:
        rb_plain.step(stacked, t0, t1)
    want, want_counts = jax_baseline["rulebook"]
    assert rb_mesh.mesh is not None
    assert np.array_equal(got, want)
    assert np.array_equal(rb_mesh.match_counts, rb_plain.match_counts)
    assert np.array_equal(rb_mesh.match_counts, want_counts)


def test_superchunk_mesh_d1_matches(jax_baseline):
    rules = rule_pool(P)[:2]
    chunks = make_chunks(0, 6)
    edges = [(t0, t1) for _, _, t0, t1 in chunks]
    cs = [c for c, _, _, _ in chunks]
    rb_mesh = open_rulebook(
        rules, partitions=K, monitor=True,
        config=RuntimeConfig(device="cpu", superchunk=4, mesh="auto", **CFG))
    rb_plain = open_rulebook(
        rules, partitions=K, monitor=True,
        config=RuntimeConfig(device="cpu", superchunk=4, **CFG))
    a = rb_mesh.step_superchunk(cs, edges)
    b = rb_plain.step_superchunk(cs, edges)
    want, want_counts = jax_baseline["rulebook"]
    assert np.array_equal(a, b) and np.array_equal(a, want)
    assert np.array_equal(rb_mesh.match_counts, rb_plain.match_counts)
    assert np.array_equal(rb_mesh.match_counts, want_counts)


def _leaves(x):
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in x for t in _leaves(f)]


def _joined(x):
    """A ``Blocks`` value's leaves joined along K on the host (a test's
    view: the engine itself never joins its blocks)."""
    if not isinstance(x, Blocks):
        return _leaves(x)
    parts = [_leaves(p) for p in x]
    return [torch.cat(ls) for ls in zip(*parts)]


@pytest.mark.parametrize("monitored", [False, True])
def test_split_rule_over_two_blocks(monitored):
    """The meshed ``FleetEngine`` at D = 2 (two CPU blocks of two
    partitions, each its own engine): over the stream's first chunks, the
    per-chunk fleet step cut along K, its outputs joined, equals the whole
    step, every output leaf bit for bit; the state stays two blocks."""
    runner = port_runner(4)
    runner._prime()
    whole = runner.fleet
    split = fleet.FleetEngine(whole.kind, whole.pattern, 4, whole.cfg,
                              mesh=CepMesh((CPU, CPU)))
    rows = [pol.compile(whole.pattern.n, *runner._caps)
            for pol in runner.policies]
    low = {whole: runner._low.device(),
           split: fleet.StackedLowered(rows, "cpu", split.mesh).device()}
    carries = {f: (f.init_state(), f.init_monitor(8))
               for f in (whole, split)}
    matches = 0
    for fc in list(streams(4))[:6]:
        outs = {}
        for f, (state, monitor) in carries.items():
            if monitored:
                outs[f] = f.process_chunk_monitored(
                    state, monitor, fc.chunk, runner._cur_rows, low[f],
                    fc.t0, fc.t1)
                carries[f] = outs[f][:2]
            else:
                outs[f] = f.process_chunk(state, fc.chunk, runner._cur_rows,
                                          fc.t0, fc.t1)
                carries[f] = (outs[f][0], monitor)
        got = [t for o in outs[split] for t in _joined(o)]
        want = [t for o in outs[whole] for t in _leaves(o)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert isinstance(carries[split][0], Blocks)
        assert len(carries[split][0]) == 2
        matches += int(outs[whole][2 if monitored else 1]
                       .full_matches.sum())
    assert matches > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_mesh_d1_windows_equal_unmeshed(cuda_device):
    """Meshed windows on the card (their blocks' steps captured in one
    graph per shape) equal the unmeshed windows: the fleet runner and
    the rulebook."""
    plain = port_runner(4, superchunk=4, device="cuda").run(streams(4))
    for mesh in (1, "auto"):
        got = meshed_runner(4, 4, mesh, device="cuda").run(streams(4))
        assert_metrics_identical(got, plain)
    chunks = make_chunks(0, 6)
    cs = [c for c, _, _, _ in chunks]
    edges = [(t0, t1) for _, _, t0, t1 in chunks]
    books = [open_rulebook(rule_pool(P)[:2], partitions=K, monitor=True,
                           config=RuntimeConfig(device="cuda", superchunk=4,
                                                mesh=mesh, **CFG))
             for mesh in (None, 1)]
    outs = [rb.step_superchunk(cs, edges) for rb in books]
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(books[0].match_counts, books[1].match_counts)
