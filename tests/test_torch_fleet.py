"""The port's monitored fleet step against the JAX package's, on the CPU.

The same seeded per-partition streams, plan rows and lowered invariant
rows go through JAX ``FleetEngine.process_chunk_monitored`` and the
port's, for order plans and for tree plans (a different tree per
partition, lowered ZStream invariants).  Counters, violation flags,
``rates`` and ``sel`` must be equal, and so must the ring buffers and the
statistics rings, and ``drift`` too: each invariant side is summed left
to right, as ``jnp.sum`` does on the CPU.  The plain (unmonitored) tree
step is held the same way.  Two tests run JAX for a few chunks, carry
its state into the port with ``repro_torch.core.convert`` and continue
both.  Each invariant side's sum is checked on its own against JAX's, on
rows with every term live.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.fleet as jfleet
from repro.cep import P as JP
from repro.core.greedy import greedy_order_plan as j_greedy
from repro.core.decision import InvariantPolicy as JInvariantPolicy
from repro.core.plans import TreeNode as JTreeNode
from repro.core.plans import TreePlan as JTreePlan
from repro.core.zstream import zstream_tree_plan as j_zstream
from repro.data.cep_streams import StreamConfig as JStreamConfig
from repro.data.cep_streams import make_stream as j_make_stream
from repro_torch.cep import P as TP
from repro_torch.core import convert
from repro_torch.core import fleet as tfleet
from repro_torch.core.decision import InvariantPolicy
from repro_torch.core.engine import EngineConfig
from repro_torch.core.greedy import greedy_order_plan
from repro_torch.core.plans import TreeNode, TreePlan
from repro_torch.core.zstream import zstream_tree_plan
from repro_torch.data.cep_streams import StreamConfig, make_stream


def seq_rule(P):
    return (P.seq(0, 1, 2)
            .where(P.attr(0) < P.attr(1) - 0.3,
                   P.attr(1) < P.attr(2) - 0.3)
            .within(4.0))


def neg_rule(P):
    return (P.seq(0, P.neg(3), 1, 2)
            .where(P.attr(0) < P.attr(1) + 0.3,
                   P.attr(1) < P.attr(2) + 0.3)
            .within(3.0))


SCFG = dict(n_chunks=6, chunk_cap=64, base_rate=12.0, shift_every=3.0)
CAPS = (8, 16)


def _chunks(k, n_types, seed=5):
    recs = [list(make_stream("traffic", StreamConfig(
        n_types=n_types, seed=seed + p, **SCFG))) for p in range(k)]
    return list(tfleet.stacked_streams(recs))


def _engines(rule, k, b_cap=32, m_cap=256, kind="order"):
    jf = jfleet.FleetEngine(kind, rule(JP).build(), k,
                            jfleet.EngineConfig(b_cap=b_cap, m_cap=m_cap))
    tf = tfleet.FleetEngine(kind, rule(TP).build(), k,
                            EngineConfig(b_cap=b_cap, m_cap=m_cap,
                                         device="cpu"))
    return jf, tf


def _lowered(k, kind="order"):
    """Identical lowered invariant rows from both packages' cold start,
    with the greedy planner (order) or the ZStream planner (tree)."""
    jplanner, tplanner = ((j_greedy, greedy_order_plan) if kind == "order"
                          else (j_zstream, zstream_tree_plan))
    jplan, jlow, _ = jfleet.prime_invariant_policies(
        seq_rule(JP).build(), jplanner,
        [JInvariantPolicy(k=1, d=0.0) for _ in range(k)], CAPS)
    tplan, tlow, _ = tfleet.prime_invariant_policies(
        seq_rule(TP).build(), tplanner,
        [InvariantPolicy(k=1, d=0.0) for _ in range(k)], CAPS,
        device="cpu")
    assert str(jplan) == str(tplan)
    for a, b in zip(jlow.host, tlow.host):
        assert np.array_equal(np.asarray(a), b)
    return jlow, tlow


def _rows(k, n):
    rng = np.random.default_rng(k)
    return np.stack([rng.permutation(n) for _ in range(k)]).astype(np.int32)


def _step_both(jf, tf, jstate, tstate, fc, rows, jlow, tlow, born_lo):
    jchunk = jfleet.Chunk(*map(jnp.asarray, fc.chunk))
    jout = jf.process_chunk_monitored(jstate[0], jstate[1], jchunk, rows,
                                      jlow, fc.t0, fc.t1, born_lo=born_lo)
    tout = tf.process_chunk_monitored(tstate[0], tstate[1], fc.chunk, rows,
                                      tlow, fc.t0, fc.t1, born_lo=born_lo)
    return jout, tout


def _compare(jout, tout):
    jbuf, jmon, jres, jviol, jdrift, jrates, jsel = jout
    tbuf, tmon, tres, tviol, tdrift, trates, tsel = tout
    for f in tres._fields:
        assert np.array_equal(getattr(tres, f).numpy(),
                              np.asarray(getattr(jres, f))), f
    assert np.array_equal(tviol.numpy(), np.asarray(jviol))
    assert np.array_equal(trates.numpy(), np.asarray(jrates))
    assert np.array_equal(tsel.numpy(), np.asarray(jsel))
    assert np.array_equal(tdrift.numpy(), np.asarray(jdrift))
    for want, got in zip(jbuf, tbuf):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for want, got in zip(jmon, tmon):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rule,n_types,k", [
    (seq_rule, 3, 1), (seq_rule, 3, 4), (seq_rule, 3, 16), (neg_rule, 4, 4),
], ids=["seq-k1", "seq-k4", "seq-k16", "neg-k4"])
def test_monitored_fleet_step_matches_jax(rule, n_types, k):
    jf, tf = _engines(rule, k)
    jlow, tlow = _lowered(k)
    rows = _rows(k, 3)
    jstate = (jf.init_state(), jf.init_monitor(8))
    tstate = (tf.init_state(), tf.init_monitor(8))
    # Half the partitions run a migration split (born window from t=2).
    born_lo = np.where(np.arange(k) % 2 == 1, 2.0, -3.0e38).astype(
        np.float32)
    fired = 0
    for fc in _chunks(k, n_types):
        jout, tout = _step_both(jf, tf, jstate, tstate, fc, rows,
                                jlow.device(), tlow.device(), born_lo)
        _compare(jout, tout)
        jstate, tstate = jout[:2], tout[:2]
        fired += int(tout[3].sum())
    if rule is seq_rule and k >= 4:
        assert fired > 0  # the shocks do fire invariant flags


def test_carry_jax_state_into_port():
    """Run JAX for three chunks, convert its buffers and monitor rings,
    then continue both for three more: every output stays equal."""
    k = 4
    jf, tf = _engines(seq_rule, k)
    jlow, tlow = _lowered(k)
    rows = _rows(k, 3)
    chunks = _chunks(k, 3, seed=9)
    jstate = (jf.init_state(), jf.init_monitor(8))
    for fc in chunks[:3]:
        jchunk = jfleet.Chunk(*map(jnp.asarray, fc.chunk))
        jstate = jf.process_chunk_monitored(
            jstate[0], jstate[1], jchunk, rows, jlow.device(), fc.t0,
            fc.t1)[:2]
    tstate = (convert.buffers_to_torch(jstate[0], "cpu"),
              convert.monitor_to_torch(jstate[1], "cpu"))
    tlow_dev = convert.lowered_to_torch(jlow.host, "cpu")
    for got, want in zip(tlow_dev, tlow.device()):
        assert np.array_equal(got.numpy(), want.numpy())
    for fc in chunks[3:]:
        jout, tout = _step_both(jf, tf, jstate, tstate, fc, rows,
                                jlow.device(), tlow_dev, -3.0e38)
        _compare(jout, tout)
        jstate, tstate = jout[:2], tout[:2]


def test_convert_matches_port_initial_state():
    """A converted JAX fleet state has the port's shapes and dtypes."""
    jf, tf = _engines(neg_rule, 3, b_cap=16, m_cap=32)
    for got, want in ((convert.buffers_to_torch(jf.init_state(), "cpu"),
                       tf.init_state()),
                      (convert.monitor_to_torch(jf.init_monitor(4), "cpu"),
                       tf.init_monitor(4))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert bool((g == w).all())


def test_streams_copy_gives_the_same_arrays():
    """The port's copy of the stream generators yields the reference's
    arrays for the same seed (both regimes)."""
    for kind in ("traffic", "stocks"):
        cfg = dict(n_types=4, n_chunks=5, chunk_cap=64, base_rate=20.0,
                   shift_every=2.0, seed=3)
        want = list(j_make_stream(kind, JStreamConfig(**cfg)))
        got = list(make_stream(kind, StreamConfig(**cfg)))
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert (w.t0, w.t1) == (g.t0, g.t1)
            assert np.array_equal(w.counts, g.counts)
            for a, b in zip(w.chunk, g.chunk):
                assert np.array_equal(np.asarray(a), np.asarray(b))


def _trees(k, node_cls, plan_cls):
    """K three-position trees, alternating ((0, 1), 2) and (0, (1, 2))."""
    N = node_cls
    shapes = (N(left=N(left=N(leaf=0), right=N(leaf=1)), right=N(leaf=2)),
              N(left=N(leaf=0), right=N(left=N(leaf=1), right=N(leaf=2))))
    return [plan_cls(shapes[p % 2]) for p in range(k)]


@pytest.mark.parametrize("monitored,k", [(True, 1), (True, 4), (False, 1),
                                         (False, 4)],
                         ids=["monitored-k1", "monitored-k4", "plain-k1",
                              "plain-k4"])
def test_tree_fleet_step_matches_jax(monitored, k):
    """``FleetEngine("tree", ...)`` with a different tree per partition:
    every output of each chunk equals the JAX tree fleet's."""
    jf, tf = _engines(seq_rule, k, kind="tree")
    jtrees, ttrees = _trees(k, JTreeNode, JTreePlan), _trees(k, TreeNode,
                                                             TreePlan)
    rows = tf.plans_to_array(ttrees)
    assert np.array_equal(rows, np.asarray(jf.plans_to_array(jtrees)))
    born_lo = np.where(np.arange(k) % 2 == 1, 2.0, -3.0e38).astype(
        np.float32)
    jlow, tlow = _lowered(k, kind="tree")
    jstate = (jf.init_state(), jf.init_monitor(8))
    tstate = (tf.init_state(), tf.init_monitor(8))
    pm = 0
    for fc in _chunks(k, 3):
        if monitored:
            jout, tout = _step_both(jf, tf, jstate, tstate, fc, rows,
                                    jlow.device(), tlow.device(), born_lo)
            _compare(jout, tout)
            jstate, tstate = jout[:2], tout[:2]
        else:
            jchunk = jfleet.Chunk(*map(jnp.asarray, fc.chunk))
            jbuf, jres = jf.process_chunk(jstate[0], jchunk, jtrees, fc.t0,
                                          fc.t1, born_lo=born_lo)
            tbuf, tres = tf.process_chunk(tstate[0], fc.chunk, ttrees,
                                          fc.t0, fc.t1, born_lo=born_lo)
            for f in tres._fields:
                assert np.array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f))), f
            for want, got in zip(jbuf, tbuf):
                assert np.array_equal(got.numpy(), np.asarray(want))
            jstate, tstate = (jbuf, jstate[1]), (tbuf, tstate[1])
            tout = (tbuf, None, tres)
        pm += int(tout[2].pm_created.sum())
    assert pm > 0
    # The slot program of a deployed plan matrix is uploaded once.
    assert tf.plan_operands(ttrees) is tf.plan_operands(ttrees)


def test_fleet_engine_rejects_tree_plans():
    """The tree fleet takes ZStream-shaped trees only: a tree whose
    children are not contiguous earlier/later intervals, or a plan list
    of the wrong length, is refused before anything runs."""
    tf = tfleet.FleetEngine("tree", seq_rule(TP).build(), 2,
                            EngineConfig(device="cpu"))
    N = TreeNode
    swapped = TreePlan(N(left=N(left=N(leaf=1), right=N(leaf=0)),
                         right=N(leaf=2)))
    gapped = TreePlan(N(left=N(left=N(leaf=0), right=N(leaf=2)),
                        right=N(leaf=1)))
    for bad in (swapped, gapped):
        with pytest.raises(AssertionError):
            tf.plans_to_array(bad)
    with pytest.raises(ValueError, match="expected 2 plans"):
        tf.plans_to_array(_trees(3, TreeNode, TreePlan))
    with pytest.raises(ValueError, match="unknown engine kind"):
        tfleet.FleetEngine("nfa", seq_rule(TP).build(), 2,
                           EngineConfig(device="cpu"))


def test_carry_jax_tree_fleet_into_port():
    """A JAX tree fleet's buffers, monitor rings and lowered ZStream
    invariants, converted after three chunks, continue in the port with
    every output equal."""
    k = 4
    jf, tf = _engines(seq_rule, k, kind="tree")
    jlow, _ = _lowered(k, kind="tree")
    jtrees, ttrees = _trees(k, JTreeNode, JTreePlan), _trees(k, TreeNode,
                                                             TreePlan)
    rows = tf.plans_to_array(ttrees)
    chunks = _chunks(k, 3, seed=9)
    jstate = (jf.init_state(), jf.init_monitor(8))
    for fc in chunks[:3]:
        jchunk = jfleet.Chunk(*map(jnp.asarray, fc.chunk))
        jstate = jf.process_chunk_monitored(
            jstate[0], jstate[1], jchunk, jtrees, jlow.device(), fc.t0,
            fc.t1)[:2]
    tstate = (convert.buffers_to_torch(jstate[0], "cpu"),
              convert.monitor_to_torch(jstate[1], "cpu"))
    tlow = convert.lowered_to_torch(jlow.host, "cpu")
    for fc in chunks[3:]:
        jout, tout = _step_both(jf, tf, jstate, tstate, fc, rows,
                                jlow.device(), tlow, -3.0e38)
        _compare(jout, tout)
        jstate, tstate = jout[:2], tout[:2]


def test_stacked_lowered_patches_one_row_in_place():
    k = 3
    _, tlow = _lowered(k)
    dev = tlow.device()
    scale_before = dev.scale.clone()
    pol = InvariantPolicy(k=1, d=0.5)
    plan, dcs = greedy_order_plan(seq_rule(TP).build(),
                                  tfleet.uniform_stat(3))
    pol.on_replan(plan, dcs, tfleet.uniform_stat(3))
    tlow.write_row(1, pol.compile(3, *CAPS))
    assert tlow.device() is dev  # patched, not re-uploaded
    assert float(dev.d[1]) == pytest.approx(0.5)
    assert float(dev.d[0]) == 0.0 and float(dev.d[2]) == 0.0
    assert np.array_equal(dev.scale.numpy(), scale_before.numpy())


def _random_lowered(rng, k, i_cap=8, t_cap=16, n=3):
    """Lowered invariant rows with every term live: enough float terms per
    side that the order of the side sums shows in the last bits."""
    from repro_torch.core.invariants import LoweredInvariants

    return LoweredInvariants(
        scale=rng.uniform(0.1, 50.0, (k, i_cap, 2, t_cap)).astype(np.float32),
        const=rng.uniform(-5.0, 5.0, (k, i_cap, 2, t_cap)).astype(
            np.float32),
        rate_exp=(rng.random((k, i_cap, 2, t_cap, n)) < 0.5).astype(
            np.float32),
        sel_exp=(rng.random((k, i_cap, 2, t_cap, n, n)) < 0.2).astype(
            np.float32),
        active=rng.random((k, i_cap)) < 0.8,
        d=rng.uniform(0.0, 0.2, k).astype(np.float32))


def test_eval_lowered_matches_jax_bit_for_bit():
    """Each invariant side is summed left to right, as the JAX package's
    ``jnp.sum`` does on the CPU, so flags and drift are the reference's
    bit for bit (a device-order sum differed in the last bits)."""
    import jax

    from repro.core.invariants import LoweredInvariants as JLowered
    from repro.core.invariants import eval_lowered as j_eval
    from repro_torch.core.invariants import eval_lowered

    rng = np.random.default_rng(7)
    k, n = 64, 3
    low = _random_lowered(rng, k, n=n)
    rates = rng.uniform(0.5, 20.0, (k, n)).astype(np.float32)
    sel = rng.uniform(0.01, 1.0, (k, n, n)).astype(np.float32)
    jv, jd = jax.vmap(j_eval)(JLowered(*map(jnp.asarray, low)),
                              jnp.asarray(rates), jnp.asarray(sel))
    tv, td = eval_lowered(type(low)(*map(torch.as_tensor, low)),
                          torch.as_tensor(rates), torch.as_tensor(sel))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.gpu
def test_cuda_eval_lowered_matches_cpu():
    """On the card the flags and drift equal the CPU's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    from repro_torch.core.invariants import eval_lowered

    rng = np.random.default_rng(7)
    k, n = 64, 3
    low = _random_lowered(rng, k, n=n)
    rates = rng.uniform(0.5, 20.0, (k, n)).astype(np.float32)
    sel = rng.uniform(0.01, 1.0, (k, n, n)).astype(np.float32)
    outs = [eval_lowered(type(low)(*(torch.as_tensor(x, device=dev)
                                     for x in low)),
                         torch.as_tensor(rates, device=dev),
                         torch.as_tensor(sel, device=dev))
            for dev in ("cpu", "cuda")]
    for a, b in zip(*outs):
        assert np.array_equal(a.numpy(), b.cpu().numpy())
