"""The paper's headline result in miniature, on the port against the JAX
package: the invariant-based method dominates the alternatives on the
quality/overhead frontier in both data regimes.

The twin of ``tests/test_system.py``, at its sizes (the greedy planner on
a 4-type chained SEQ, ``EngineConfig(b_cap=128, m_cap=4096)``, 80 chunks
of 256 at ``base_rate=15``, seed 3, regret measured).  Each of the six
runs (invariant, unconditional, static, threshold t = 0.4 on the traffic
stream; unconditional and invariant d = 0.3 on the stocks stream) is made
once per module in each package; every integer ``RunMetrics`` field and
the regret must be equal (the regret to the bit), and the reference's
assertions must hold on the port's runs.  Slow, as the reference.
"""

import functools

import pytest
import torch

from repro.core.adaptation import AdaptiveRunner as JAdaptiveRunner
from repro.core.decision import make_policy as j_make_policy
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.patterns import chain_predicates as j_chain
from repro.core.patterns import seq_pattern as j_seq
from repro.data.cep_streams import StreamConfig as JStreamConfig
from repro.data.cep_streams import make_stream as j_make_stream
from repro_torch.core import AdaptiveRunner, EngineConfig, make_policy
from repro_torch.core.patterns import chain_predicates, seq_pattern
from repro_torch.data.cep_streams import StreamConfig, make_stream

pytestmark = pytest.mark.slow

INT_FIELDS = ("chunks", "events", "full_matches", "pm_created", "overflow",
              "closure_expansions", "replans", "deployments",
              "false_positives", "migration_chunks", "condition_checks",
              "regret_samples")
SCFG = dict(n_types=4, n_attrs=1, n_chunks=80, chunk_cap=256,
            base_rate=15.0)
CAPS = dict(b_cap=128, m_cap=4096)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pattern(seq, chain):
    return seq([0, 1, 2, 3], window=4.0,
               predicates=chain([0, 1, 2, 3], theta=-0.3))


@functools.lru_cache(maxsize=None)
def run(package, policy, kind, seed=3, **kw):
    """``tests/test_system.py::run`` in either package, once per module."""
    if package == "jax":
        r = JAdaptiveRunner(pattern(j_seq, j_chain), planner="greedy",
                            policy=j_make_policy(policy, **kw),
                            engine_cfg=JEngineConfig(**CAPS),
                            measure_regret=True)
        return r.run(j_make_stream(kind, JStreamConfig(seed=seed, **SCFG)))
    r = AdaptiveRunner(pattern(seq_pattern, chain_predicates),
                       planner="greedy", policy=make_policy(policy, **kw),
                       engine_cfg=EngineConfig(device="cpu", **CAPS),
                       measure_regret=True)
    return r.run(make_stream(kind, StreamConfig(seed=seed, **SCFG)))


def port(policy, kind, **kw):
    """The port's run, held to the JAX run: every integer field, and the
    regret to the bit."""
    got, want = run("port", policy, kind, **kw), run("jax", policy, kind,
                                                     **kw)
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), (policy, kind, f)
    assert float.hex(got.regret) == float.hex(want.regret), (policy, kind)
    return got


def test_invariant_on_pareto_frontier_traffic():
    inv = port("invariant", "traffic", d=0.0)
    unc = port("unconditional", "traffic")
    sta = port("static", "traffic")
    assert inv.regret <= unc.regret + 1e-6
    assert inv.replans < unc.replans / 5
    assert inv.regret < sta.regret
    assert inv.false_positives == 0


def test_invariant_beats_threshold_on_regret_or_replans():
    inv = port("invariant", "traffic", d=0.0)
    thr = port("threshold", "traffic", t=0.4)
    assert (inv.regret <= thr.regret + 1e-6
            or inv.replans <= thr.replans)


def test_stocks_regime_unconditional_overadapts():
    unc = port("unconditional", "stocks")
    inv = port("invariant", "stocks", d=0.3)
    assert unc.replans > 10 * max(inv.replans, 1)
    assert unc.migration_chunks >= inv.migration_chunks
    assert unc.full_matches == inv.full_matches
