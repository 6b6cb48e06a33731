"""The port's scenario suite (the mirror of ``tests/test_scenarios.py``).

Every bundled scenario's stream prefix runs through the port's
``cep.open`` across the (K, superchunk) grid and must report exactly the
brute-force oracle's match count; heavy grid points carry
``@pytest.mark.slow`` as in the JAX file.  The port's scenario streams
are held to the JAX package's array for array, and the FlowSense
rulebook replay gate runs through the port's ``open_rulebook``.
"""

import numpy as np
import pytest
import torch

from repro.data import scenarios as jscenarios
from repro_torch import cep
from repro_torch.cep import RuntimeConfig
from repro_torch.core.ref_engine import RefEngine
from repro_torch.data import scenarios

CHUNKS = 12          # prefix length fed to the oracle (warmup + control)
GRID = [
    pytest.param(1, 1, id="k1-s1"),
    pytest.param(4, 1, id="k4-s1", marks=pytest.mark.slow),
    pytest.param(1, 8, id="k1-s8", marks=pytest.mark.slow),
    pytest.param(4, 8, id="k4-s8", marks=pytest.mark.slow),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _config(sc, *, superchunk=1):
    return RuntimeConfig(**sc.runtime, escalate_on_overflow=True,
                         superchunk=superchunk, device="cpu")


def _oracle_matches(sc, k, *, seed=0, chunks=CHUNKS):
    total = 0
    for p in range(k):
        total += RefEngine(sc.pattern.build()).run(
            sc.stream(p, seed=seed, chunks=chunks)).full_matches
    return total


@pytest.mark.parametrize("name", scenarios.names())
@pytest.mark.parametrize("k,superchunk", GRID)
def test_scenario_prefix_matches_oracle(name, k, superchunk):
    sc = scenarios.get(name)
    n = CHUNKS if superchunk == 1 else 16   # superchunk needs n % s == 0
    s = cep.open(sc.pattern, partitions=k, monitor=True,
                 superchunk=superchunk,
                 config=_config(sc, superchunk=superchunk))
    tel = s.run(sc.streams(k, seed=0, chunks=n))
    assert tel.matches == _oracle_matches(sc, k, chunks=n)


@pytest.mark.parametrize("name", scenarios.names())
def test_scenario_streams_equal_jax(name):
    """The copy of the scenario suite emits the JAX package's streams,
    array for array, for every partition, and the same trajectories,
    segments, runtime and expectations."""
    sc, jsc = scenarios.get(name), jscenarios.get(name)
    for f in ("name", "partitions", "n_types", "runtime", "expected",
              "chunk_duration", "chunk_cap", "n_attrs", "rate_scale"):
        assert getattr(sc, f) == getattr(jsc, f), f
    assert [(s.name, s.n_chunks, s.gate) for s in sc.segments] == \
        [(s.name, s.n_chunks, s.gate) for s in jsc.segments]
    assert np.array_equal(sc.drift_trajectory(1, seed=2),
                          jsc.drift_trajectory(1, seed=2))
    for p in range(sc.partitions):
        for got, want in zip(sc.stream(p, seed=1, chunks=20),
                             jsc.stream(p, seed=1, chunks=20)):
            for f in ("ts", "type_id", "attr", "valid"):
                a, b = getattr(got.chunk, f), np.asarray(getattr(want.chunk,
                                                                  f))
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            assert np.array_equal(got.counts, want.counts)
            assert (got.t0, got.t1) == (want.t0, want.t1)
    assert repr(sc.pattern.build()) == repr(jsc.pattern.build())


@pytest.mark.parametrize("name", scenarios.names())
def test_scenario_stream_deterministic(name):
    sc = scenarios.get(name)
    a = list(sc.stream(0, seed=3, chunks=4))
    b = list(sc.stream(0, seed=3, chunks=4))
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.chunk.ts, rb.chunk.ts)
        np.testing.assert_array_equal(ra.counts, rb.counts)
    # distinct partitions / seeds draw distinct event noise
    c = list(sc.stream(1, seed=3, chunks=4))
    assert any(ra.n_events != rc.n_events or
               not np.array_equal(ra.chunk.ts, rc.chunk.ts)
               for ra, rc in zip(a, c))


@pytest.mark.parametrize("name", scenarios.names())
def test_scenario_trajectory_structure(name):
    """Ground-truth drift structure: control is stationary, drift is not,
    and the emitted streams' true rates mirror the trajectory exactly."""
    sc = scenarios.get(name)
    rates = sc.drift_trajectory(0, seed=0)
    assert rates.shape == (sc.n_chunks, sc.n_types)
    for seg, lo, hi in sc.segment_slices():
        if seg.gate == "control":
            assert np.allclose(rates[lo:hi], rates[lo])
        if seg.gate == "drift":
            assert not np.allclose(rates[lo:hi], rates[lo - 1])
    recs = list(sc.stream(0, seed=0, chunks=6))
    want = sc.drift_trajectory(0, seed=0, chunks=6)
    got = np.stack([r.true_rates for r in recs])
    np.testing.assert_allclose(got, want * sc.rate_scale)


@pytest.mark.parametrize("name", scenarios.names())
def test_scenario_resume_equals_continuous(name):
    """Segment-by-segment replay with ``resume=True`` is the same run as
    one continuous stream — the replay's measurement boundaries must not
    be semantic boundaries."""
    sc = scenarios.get(name)
    k = sc.partitions
    full = cep.open(sc.pattern, partitions=k, monitor=True,
                    config=_config(sc))
    t_full = full.run(sc.streams(k, seed=0, chunks=16))

    seg = cep.open(sc.pattern, partitions=k, monitor=True,
                   config=_config(sc))
    tels = []
    for lo, hi in ((0, 6), (6, 11), (11, 16)):
        parts = [list(sc.stream(p, seed=0, chunks=16))[lo:hi]
                 for p in range(k)]
        tels.append(seg.run(parts, resume=bool(tels)))
    assert sum(t.matches for t in tels) == t_full.matches
    assert sum(t.replans for t in tels) == t_full.replans
    assert sum(t.escalations for t in tels) == t_full.escalations


@pytest.mark.slow
@pytest.mark.parametrize("name", scenarios.names())
def test_scenario_drift_prefix_matches_oracle(name):
    """Reaching into the drift segment (plan changes, migrations and
    escalations active) at native K."""
    sc = scenarios.get(name)
    warm = sum(s.n_chunks for s in sc.segments[:2])
    n = warm + 8
    k = sc.partitions
    s = cep.open(sc.pattern, partitions=k, monitor=True, config=_config(sc))
    tel = s.run(sc.streams(k, seed=0, chunks=n))
    assert tel.matches == _oracle_matches(sc, k, chunks=n)


def test_fraud_full_run_matches_jax():
    """Over the whole fraud run, the campaign puts more events of one type
    inside a window than the scenario's ring buffers hold
    (``buffer_capacity=64``), so live events are overwritten and fewer
    matches are counted than the oracle finds: the port must count
    exactly what the JAX package counts, telemetry field for field."""
    from repro import cep as jcep
    from repro.cep import RuntimeConfig as JConfig

    sc, jsc = scenarios.get("fraud"), jscenarios.get("fraud")
    tel = cep.open(sc.pattern, partitions=sc.partitions, monitor=True,
                   config=_config(sc)).run(sc.streams())
    jtel = jcep.open(jsc.pattern, partitions=jsc.partitions, monitor=True,
                     config=JConfig(**jsc.runtime,
                                    escalate_on_overflow=True)).run(
        jsc.streams())
    for f in ("chunks", "events", "matches", "replans", "deployments",
              "violations", "host_syncs", "overflow", "neg_rejected",
              "closure_expansions", "escalations",
              "migration_partition_chunks"):
        assert getattr(tel, f) == getattr(jtel, f), f
    assert tel.per_partition_matches.tolist() == \
        np.asarray(jtel.per_partition_matches).tolist()
    assert tel.deployments >= sc.expected["min_drift_deployments"]


def test_flowsense_rulebook_replay_gates():
    """The 3-rule tenant rulebook (alert + ack + fraud-combo) through the
    port's ``open_rulebook``: the control gate (zero replans under
    stationary statistics) and the oracle differential both hold."""
    from repro_torch.cep.rulebook import open_rulebook
    from repro_torch.data.scenarios import flowsense

    sc = scenarios.get("flowsense")
    rules = flowsense.rulebook_patterns()
    k = sc.partitions
    warm = sc.segments[0].n_chunks
    n = warm + 4
    streams = [list(sc.stream(p, seed=0, chunks=n)) for p in range(k)]

    rb = open_rulebook(rules, partitions=k, monitor=True,
                       config=_config(sc))
    rb.run([s[:warm] for s in streams])
    tel_control = rb.run([s[warm:] for s in streams])
    assert tel_control.replans == 0, (
        "control segment must keep every (q, k) cell silent")
    assert rb.telemetry().overflow == 0

    for i, r in enumerate(rules):
        want = np.array([RefEngine(r.build()).run(streams[p]).full_matches
                         for p in range(k)], np.int64)
        np.testing.assert_array_equal(rb.match_counts[i], want)


def test_scenario_registry():
    assert set(scenarios.names()) == {"citibike", "flowsense", "fraud"}
    assert scenarios.SCENARIOS == jscenarios.SCENARIOS
    sc = scenarios.get("citibike")
    assert sc.n_chunks == sum(s.n_chunks for s in sc.segments)
    assert [s.gate for s in sc.segments] == ["none", "control", "drift"]
    with pytest.raises(ValueError):
        scenarios.get("nope")
