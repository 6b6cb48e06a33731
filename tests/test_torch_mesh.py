"""The port's ``cep`` device mesh at D > 1 against the JAX package, on the
CPU.

A meshed fleet splits K into D contiguous blocks of K/D partitions, block
``i`` resident on ``mesh.devices[i]`` (``distributed/sharding.py``).  On a
host with one CPU the only way to run D > 1 is a ``CepMesh`` that repeats
the device, the port's counterpart of the reference's
``--xla_force_host_platform_device_count``: D = 2 and D = 4 blocks share
the CPU here.  Partitions are independent, so every meshed run must equal
the JAX package's unmeshed run and the port's, exactly: per-partition
matches, the five counters, violations, replan points and deployments.

Fronts: ``cep.open(...).run`` with order and tree plans, per chunk and in
superchunk windows, the configuration of
``tests/test_superchunk.py::test_sharded_d2_subprocess`` taken verbatim
(its K = 3 over D = 2 error too); the rulebook per chunk and in bucket
windows, with a hot add; both serving fronts (``Session.step`` and
``step_superchunk``, monitored and not).  The session and rulebook tests
also show that the state carried between chunks is D blocks, each on its
mesh device.  On a GPU, D = 2 windows on repeated ``cuda`` blocks, and
on two GPUs where a host has them, equal the unmeshed ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import cep as jcep
from repro.cep import P as JP
from repro.cep import RuntimeConfig as JConfig
from repro.cep.rulebook import open_rulebook as j_open_rulebook
from repro.core import fleet as jfleet
from repro.data.cep_streams import StreamConfig as JStreamConfig
from repro.data.cep_streams import make_stream as j_make_stream
from repro_torch import cep
from repro_torch.cep import P, RuntimeConfig, open_rulebook
from repro_torch.core import fleet
from repro_torch.data.cep_streams import StreamConfig, make_stream
from repro_torch.distributed import Blocks, CepMesh, resolve_cep_mesh

from test_torch_rulebook import CFG as RB_CFG
from test_torch_rulebook import jchunk, make_chunks, rule_counters, rule_pool

CPU = torch.device("cpu")
K = 4
# tests/test_superchunk.py::test_sharded_d2_subprocess, verbatim.
SCFG = dict(n_types=3, n_chunks=10, chunk_cap=128, base_rate=8.0)
CFG = dict(buffer_capacity=64, match_capacity=1024, max_invariants=8,
           max_terms=16)
# Tree plans at a quarter of the match capacity (no overflow on this
# stream; the unpacked join is the CPU's slowest step) over 6 chunks.
TREE_CFG = dict(CFG, match_capacity=256)
TREE_CHUNKS = 6
# The serving fronts over 4 chunks, the monitored one at K = 4 (its JAX
# step is the order run's, compiled once) and the plain one at K = 8; the
# rulebook at K = 4, its rule pool's first two rules, a third hot-added
# after RB_CHUNKS chunks.
K_SERVE = {True: 4, False: 8}
SERVE_CHUNKS = 4
RB_CHUNKS = 4
INT_FIELDS = ("chunks", "events", "matches", "replans", "deployments",
              "violations", "host_syncs", "overflow", "dropped",
              "neg_rejected", "closure_expansions", "escalations",
              "migration_partition_chunks")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def _memos_as_found():
    """Meshed engines never enter the memo; the unmeshed baselines here
    do, so both packages' memos are left as found."""
    saved = [(m, list(m.items())) for m in (jfleet._TRACE_MEMO,
                                            fleet._TRACE_MEMO)]
    yield
    for m, items in saved:
        m.clear()
        m.update(items)


def pattern(P_):
    return (P_.seq(0, 1, 2)
            .where(P_.attr(0) < P_.attr(1) - 0.3,
                   P_.attr(1) < P_.attr(2) - 0.3)
            .within(4.0))


def streams(k, n_chunks=10, seed=11):
    scfg = StreamConfig(**dict(SCFG, n_chunks=n_chunks))
    return [make_stream("traffic", dataclasses.replace(scfg, seed=seed + p))
            for p in range(k)]


def jstreams(k, n_chunks=10, seed=11):
    scfg = JStreamConfig(**dict(SCFG, n_chunks=n_chunks))
    return [j_make_stream("traffic", dataclasses.replace(scfg, seed=seed + p))
            for p in range(k)]


def mesh(d):
    """D blocks sharing the CPU."""
    return CepMesh((CPU,) * d)


def assert_same_telemetry(got, want):
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.per_partition_matches.tolist() == \
        want.per_partition_matches.tolist()
    assert np.array_equal(got.last_drift, want.last_drift)


def control(sess):
    """A run's replan points and deployed plans (the same dataclasses in
    both packages)."""
    r = sess._runner
    return r._replan_t.tolist(), [repr(p) for p in r.cur_plans]


def serve(open_, P_, recs, monitor, superchunk, **kw):
    chunks = [fc.chunk for fc in recs]
    edges = [(fc.t0, fc.t1) for fc in recs]
    sess = open_(pattern(P_), partitions=K_SERVE[monitor], plan="order",
                 monitor=monitor, superchunk=superchunk, **kw)
    if superchunk:
        out = sess.step_superchunk(chunks, edges)
    else:
        out = np.stack([np.asarray(sess.step(c, t0, t1))
                        for c, (t0, t1) in zip(chunks, edges)])
    tel = sess.telemetry()
    return np.asarray(out).tolist(), (tel.matches, tel.violations,
                                      tel.replans, tel.host_syncs)


def run_rulebook(open_, P_, to_chunk, superchunk, **kw):
    """The first two rules over RB_CHUNKS chunks, a hot-added third over
    as many more: per-chunk (R, K) matches (the first segment's rows
    padded with the added rule's zero row) and the rule counters."""
    chunks = make_chunks(0, 2 * RB_CHUNKS, k=K)
    rb = open_(rule_pool(P_)[:2], partitions=K, monitor=True,
               spare_slots=1, **kw)
    segs = []
    for half in (chunks[:RB_CHUNKS], chunks[RB_CHUNKS:]):
        if superchunk:
            segs.append(np.asarray(rb.step_superchunk(
                [to_chunk(c) for c, _, _, _ in half],
                [(t0, t1) for _, _, t0, t1 in half])))
        else:
            segs.append(np.stack([np.asarray(rb.step(to_chunk(c), t0, t1))
                                  for c, _, t0, t1 in half]))
        if len(segs) == 1:
            traces = rb.trace_count() if superchunk else None
            rb.add_rule(rule_pool(P_)[2])
    first = np.pad(segs[0], ((0, 0), (0, 1), (0, 0)))
    return rb, np.concatenate([first, segs[1]]).tolist(), traces


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in x for t in _leaves(f)]


def assert_blocks(x, m, kb):
    """``x`` is D blocks, block i's every leaf on ``m.devices[i]`` with
    K/D partitions."""
    assert isinstance(x, Blocks) and len(x) == len(m.devices)
    for blk, dev in zip(x, m.devices):
        for t in _leaves(blk):
            assert t.device == dev and t.shape[0] == kb


@pytest.fixture(scope="module")
def jax_baseline():
    """The JAX package's unmeshed per-chunk runs, once per module (its own
    tests hold its windows equal to them): the reference's D = 2
    configuration, the tree, both serving fronts and the rulebook with
    its hot add."""
    order = jcep.open(pattern(JP), partitions=K, plan="order", monitor=True,
                      config=JConfig(**CFG))
    tree = jcep.open(pattern(JP), partitions=K, plan="tree", monitor=True,
                     config=JConfig(**TREE_CFG))
    rb, rb_out, _ = run_rulebook(
        lambda *a, **kw: j_open_rulebook(*a, config=JConfig(**RB_CFG), **kw),
        JP, jchunk, superchunk=None)
    return {
        "order": (order.run(jstreams(K)), control(order)),
        "tree": (tree.run(jstreams(K, TREE_CHUNKS)), control(tree)),
        "serving": {m: serve(jcep.open, JP, list(jfleet.stacked_streams(
            jstreams(K_SERVE[m], SERVE_CHUNKS, seed=31))), m, None,
            config=JConfig(**CFG)) for m in (True, False)},
        "rulebook": (rb_out, rule_counters(rb), rb.telemetry().host_syncs)}


@pytest.fixture(scope="module")
def port_order():
    """The port's unmeshed run of the reference's configuration (per
    chunk: its windows equal it, tests/test_torch_superchunk.py)."""
    sess = cep.open(pattern(P), partitions=K, plan="order", monitor=True,
                    config=RuntimeConfig(device="cpu", **CFG))
    return sess.run(streams(K)), control(sess)


def test_k3_over_d2_raises_divide():
    """The reference's ``resolve_cep_mesh(cep_mesh(2), 3)`` error, and
    the facades' errors for a bad mesh."""
    with pytest.raises(ValueError, match="divide"):
        resolve_cep_mesh(mesh(2), 3, "cpu")
    with pytest.raises(ValueError, match="divide"):
        cep.open(pattern(P), partitions=3, plan="order",
                 config=RuntimeConfig(device="cpu"), mesh=mesh(2))
    with pytest.raises(ValueError, match="divide"):
        open_rulebook(rule_pool(P)[:2], partitions=3,
                      config=RuntimeConfig(device="cpu", mesh=mesh(2)))
    # mesh=int and "auto" count distinct devices: the CPU is one.
    with pytest.raises(ValueError, match="devices"):
        cep.open(pattern(P), partitions=K, plan="order",
                 config=RuntimeConfig(device="cpu"), mesh=2)
    assert resolve_cep_mesh("auto", K, "cpu").shape == {"cep": 1}
    with pytest.raises(TypeError):
        resolve_cep_mesh(2.0, K, "cpu")


@pytest.mark.parametrize("superchunk", [8, None])
@pytest.mark.parametrize("d", [2, 4])
def test_reference_d2_configuration(d, superchunk, jax_baseline,
                                    port_order):
    """``test_sharded_d2_subprocess``'s run at D = 2 and D = 4, in
    windows of 8 and per chunk: equal to the JAX package's unmeshed run
    and the port's, counter for counter, with the same replan points and
    plans; what the run carries between chunks (ring buffers, monitor
    rings, lowered rows, plan operands) is D blocks, each on its mesh
    device, run by its own engine."""
    sess = cep.open(pattern(P), partitions=K, plan="order", monitor=True,
                    config=RuntimeConfig(device="cpu", **CFG),
                    superchunk=superchunk, mesh=mesh(d))
    got = sess.run(streams(K))
    want, want_ctl = jax_baseline["order"]
    assert_same_telemetry(got, want)
    assert_same_telemetry(got, port_order[0])
    assert control(sess) == want_ctl == port_order[1]
    assert got.violations > 0 and got.deployments > 0
    r, m = sess._runner, mesh(d)
    for x in (r._state, r._monitor, r._low.device(),
              r.fleet.plan_operands(r._cur_rows)):
        assert_blocks(x, m, K // d)
    assert [(b.device, b.k) for b in r.fleet.blocks] == \
        [(dev, K // d) for dev in m.devices]


@pytest.mark.parametrize("superchunk", [4, None])
@pytest.mark.parametrize("d", [2, 4])
def test_tree_meshed(d, superchunk, jax_baseline):
    """Tree plans, per chunk and in windows of 4, at D = 2 and 4."""
    sess = cep.open(pattern(P), partitions=K, plan="tree", monitor=True,
                    config=RuntimeConfig(device="cpu", **TREE_CFG),
                    superchunk=superchunk, mesh=mesh(d))
    got = sess.run(streams(K, TREE_CHUNKS))
    want, want_ctl = jax_baseline["tree"]
    assert_same_telemetry(got, want)
    assert control(sess) == want_ctl
    assert got.violations > 0 and got.matches > 0


@pytest.mark.parametrize("superchunk", [4, None])
@pytest.mark.parametrize("monitor", [True, False])
@pytest.mark.parametrize("d", [2, 4])
def test_serving_fronts_meshed(d, monitor, superchunk, jax_baseline):
    """``CEPFleetServingEngine`` (monitor=False, K = 8) and
    ``MonitoredCEPFleetServingEngine`` (K = 4) over D = 2 and 4, 4
    chunks, through ``Session.step`` and ``step_superchunk``: per-chunk
    matches and the serving telemetry equal the JAX package's ``step``
    loop."""
    recs = list(fleet.stacked_streams(
        streams(K_SERVE[monitor], SERVE_CHUNKS, seed=31)))
    got = serve(cep.open, P, recs, monitor, superchunk,
                config=RuntimeConfig(device="cpu", **CFG), mesh=mesh(d))
    assert got == jax_baseline["serving"][monitor]
    assert np.sum(got[0]) > 0
    if monitor:
        assert got[1][1] > 0


@pytest.mark.parametrize("superchunk", [4, None])
@pytest.mark.parametrize("d", [2, 4])
def test_rulebook_meshed(d, superchunk, jax_baseline):
    """The rulebook at K = 4 over D = 2 and 4, per chunk and in bucket
    windows of 4, with a rule hot-added halfway: per-chunk matches and
    every rule counter equal the JAX package's per-chunk run; per chunk,
    ``host_syncs`` too (a window reads once per window); the hot add
    into a spare slot enters no new window shape.  Each bucket's state,
    monitor rings, plan rows and lowered rows are D blocks on the mesh
    devices, its rule rows and lattice routing one copy per device,
    shared by the blocks on it."""
    rb, out, traces = run_rulebook(
        lambda *a, **kw: open_rulebook(*a, config=RuntimeConfig(
            device="cpu", superchunk=superchunk or 1, mesh=mesh(d),
            **RB_CFG), **kw), P, lambda c: c, superchunk)
    want_out, want_counters, want_syncs = jax_baseline["rulebook"]
    assert out == want_out
    assert rule_counters(rb) == want_counters
    assert np.sum(out) > 0 and rb.telemetry().violations > 0
    if superchunk:
        assert rb.trace_count() == traces
    else:
        assert rb.telemetry().host_syncs == want_syncs
    for bucket in rb._buckets:
        for x in (bucket.state, bucket.monitor, bucket.plans_d,
                  bucket.lowered.device()):
            assert_blocks(x, mesh(d), K // d)
        for x in (bucket.ops_d, bucket.share_d):
            assert isinstance(x, Blocks) and all(b is x[0] for b in x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda", 0)


def _cuda_windows_equal_unmeshed(two):
    """The order session's windows and the rulebook's bucket windows over
    the mesh ``two`` equal the unmeshed ones."""
    runs = []
    for m in (None, two):
        sess = cep.open(pattern(P), partitions=K, plan="order", monitor=True,
                        config=RuntimeConfig(device="cuda", **CFG),
                        superchunk=8, mesh=m)
        runs.append((sess.run(streams(K)), control(sess)))
    assert_same_telemetry(runs[1][0], runs[0][0])
    assert runs[1][1] == runs[0][1]
    books = [run_rulebook(
        lambda *a, **kw: open_rulebook(*a, config=RuntimeConfig(
            device="cuda", superchunk=4, mesh=m, **RB_CFG), **kw),
        P, lambda c: c, 4) for m in (None, two)]
    assert books[1][1] == books[0][1]
    assert rule_counters(books[1][0]) == rule_counters(books[0][0])


@pytest.mark.gpu
def test_cuda_d2_windows_equal_unmeshed(cuda_device):
    """D = 2 blocks sharing the card, each its own statics and graphs."""
    _cuda_windows_equal_unmeshed(CepMesh((cuda_device,) * 2))


@pytest.mark.gpu
def test_cuda_distinct_gpus_equal_unmeshed(cuda_device):
    """Two blocks on two GPUs (each window captured on its own device):
    equal to the unmeshed run on one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (chip_smoke.py --mesh on a "
                    "multi-GPU host)")
    _cuda_windows_equal_unmeshed(
        CepMesh((torch.device("cuda", 0), torch.device("cuda", 1))))
