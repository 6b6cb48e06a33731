"""The port's monitored fleet step against the JAX package's, on the CPU.

The same seeded per-partition streams, plan rows and lowered invariant
rows go through JAX ``FleetEngine.process_chunk_monitored`` and the
port's.  Counters, violation flags, ``rates`` and ``sel`` must be equal,
and so must the ring buffers and the statistics rings; ``drift`` (a
ratio of float sums and products) is held to ``rtol=1e-6``.  One test
runs JAX for a few chunks, carries its state into the port with
``repro_torch.core.convert`` and continues both.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.fleet as jfleet
from repro.cep import P as JP
from repro.core.greedy import greedy_order_plan as j_greedy
from repro.core.decision import InvariantPolicy as JInvariantPolicy
from repro.data.cep_streams import StreamConfig as JStreamConfig
from repro.data.cep_streams import make_stream as j_make_stream
from repro_torch.cep import P as TP
from repro_torch.core import convert
from repro_torch.core import fleet as tfleet
from repro_torch.core.decision import InvariantPolicy
from repro_torch.core.engine import EngineConfig
from repro_torch.core.greedy import greedy_order_plan
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


def _engines(rule, k, b_cap=32, m_cap=256):
    jf = jfleet.FleetEngine("order", rule(JP).build(), k,
                            jfleet.EngineConfig(b_cap=b_cap, m_cap=m_cap))
    tf = tfleet.FleetEngine("order", rule(TP).build(), k,
                            EngineConfig(b_cap=b_cap, m_cap=m_cap,
                                         device="cpu"))
    return jf, tf


def _lowered(k):
    """Identical lowered invariant rows from both packages' cold start."""
    jplan, jlow, _ = jfleet.prime_invariant_policies(
        seq_rule(JP).build(), j_greedy,
        [JInvariantPolicy(k=1, d=0.0) for _ in range(k)], CAPS)
    tplan, tlow, _ = tfleet.prime_invariant_policies(
        seq_rule(TP).build(), greedy_order_plan,
        [InvariantPolicy(k=1, d=0.0) for _ in range(k)], CAPS,
        device="cpu")
    assert jplan.order == tplan.order
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
    np.testing.assert_allclose(tdrift.numpy(), np.asarray(jdrift),
                               rtol=1e-6)
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


def test_fleet_engine_rejects_tree_plans():
    with pytest.raises(NotImplementedError, match="tree engine"):
        tfleet.FleetEngine("tree", seq_rule(TP).build(), 2,
                           EngineConfig(device="cpu"))


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
