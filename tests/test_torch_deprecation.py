"""The port's legacy class-ladder shims (the mirror of
``tests/test_deprecation.py``): every pre-facade entry point warns once,
the facades (``cep.open``, ``cep.open_rulebook``) surface no warning, and
the legacy ``FleetRunner`` counts what the session counts, as it does in
the JAX package."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import compat as j_compat
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.fleet import FleetRunner as JFleetRunner
from repro.core.fleet import stacked_streams as j_stacked_streams
from repro.core.patterns import chain_predicates as j_chain
from repro.core.patterns import seq_pattern as j_seq
from repro.data.cep_streams import StreamConfig as JStreamConfig
from repro.data.cep_streams import make_stream as j_make_stream
from repro_torch import cep
from repro_torch.cep import OrderPlan, RuntimeConfig
from repro_torch.core import compat
from repro_torch.core.engine import EngineConfig, MonitoredEngine, make_engine
from repro_torch.core.fleet import (FleetRunner, MonitoredFleetRunner,
                                    stacked_streams)
from repro_torch.core.patterns import chain_predicates, seq_pattern
from repro_torch.data.cep_streams import StreamConfig, make_stream
from repro_torch.serving.engine import (CEPFleetServingEngine,
                                        MonitoredCEPFleetServingEngine)

PAT = seq_pattern([0, 1, 2], 4.0, chain_predicates([0, 1, 2], theta=-0.3))
CFG = EngineConfig(b_cap=64, m_cap=512, device="cpu")
RT = dict(buffer_capacity=64, match_capacity=512, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _one_warning(record):
    msgs = [str(w.message) for w in record
            if issubclass(w.category, DeprecationWarning)]
    assert len(msgs) == 1, msgs
    assert "repro_torch.cep" in msgs[0]
    return record[0]


LEGACY = {
    "make_engine": lambda: make_engine("order", PAT, CFG),
    "MonitoredEngine": lambda: MonitoredEngine("order", PAT, CFG),
    "FleetRunner": lambda: FleetRunner(PAT, 2, engine_cfg=CFG),
    "MonitoredFleetRunner": lambda: MonitoredFleetRunner(PAT, 2,
                                                         engine_cfg=CFG),
    "CEPFleetServingEngine": lambda: CEPFleetServingEngine(
        PAT, 2, OrderPlan((0, 1, 2)), CFG),
    "MonitoredCEPFleetServingEngine": lambda: MonitoredCEPFleetServingEngine(
        PAT, 2, CFG),
}


@pytest.mark.parametrize("name", list(LEGACY))
def test_legacy_constructors_warn(name):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        LEGACY[name]()
    w = _one_warning(rec)
    assert str(w.message).startswith(name + " is a legacy entry point")
    # attributed to the code that constructed the legacy object
    assert w.filename == __file__


def test_message_names_the_port_and_legacy_ok_silences():
    assert compat._MSG.replace("repro_torch.cep", "repro.cep") == \
        j_compat._MSG
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with compat.legacy_ok():
            for ctor in LEGACY.values():
                ctor()


def test_facade_is_warning_free():
    """Internal construction through the facades must not surface the
    ladder deprecation warnings to the user."""
    scfg = StreamConfig(n_types=3, n_chunks=4, chunk_cap=64, base_rate=6.0,
                        seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        sess = cep.open(PAT, partitions=1, plan="order", monitor=True,
                        config=RuntimeConfig(**RT))
        sess.run(make_stream("traffic", scfg))
        sess.step(next(iter(make_stream("traffic", scfg))).chunk, 0.0, 1.0)
        plain = cep.open(PAT, partitions=1, plan="tree",
                         config=RuntimeConfig(policy=None, **RT))
        plain.run(make_stream("traffic", scfg))
        plain.step(next(iter(make_stream("traffic", scfg))).chunk, 0.0, 1.0)
        book = cep.open_rulebook([PAT, seq_pattern([1, 2], 3.0)],
                                 partitions=1, monitor=True,
                                 config=RuntimeConfig(**RT))
        book.run(make_stream("traffic", scfg))


def test_legacy_runner_equivalent_to_session_and_jax():
    """Shim equivalence: the deprecated FleetRunner and the facade give
    the same per-partition counts on the same drifting streams, and so
    does the JAX package's FleetRunner."""
    k = 2
    scfg = dict(n_types=3, n_chunks=8, chunk_cap=128, base_rate=8.0)

    def streams(cfg_cls=StreamConfig, make=make_stream):
        return [make("stocks", cfg_cls(seed=41 + p, **scfg))
                for p in range(k)]

    with pytest.warns(DeprecationWarning, match="repro_torch.cep"):
        legacy = FleetRunner(PAT, k, planner="greedy",
                             engine_cfg=dataclasses.replace(CFG, m_cap=1024))
    legacy_m = legacy.run(stacked_streams(streams()))

    sess = cep.open(PAT, partitions=k, plan="order",
                    config=RuntimeConfig(buffer_capacity=64,
                                         match_capacity=1024, policy=None,
                                         device="cpu"))
    tel = sess.run(streams())
    assert (tel.per_partition_matches.tolist()
            == legacy_m.per_partition_matches.tolist())
    assert tel.matches == legacy_m.full_matches

    jpat = j_seq([0, 1, 2], 4.0, j_chain([0, 1, 2], theta=-0.3))
    with j_compat.legacy_ok():
        jlegacy = JFleetRunner(jpat, k, planner="greedy",
                               engine_cfg=JEngineConfig(b_cap=64,
                                                        m_cap=1024))
    jm = jlegacy.run(j_stacked_streams(streams(JStreamConfig,
                                               j_make_stream)))
    assert np.array_equal(legacy_m.per_partition_matches,
                          jm.per_partition_matches)
    assert legacy_m.full_matches == jm.full_matches
