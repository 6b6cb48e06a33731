"""The port's host statistics (``core/stats.py``: ``SlidingWindowEstimator``,
``sample_selectivities``, ``Stat``, ``uniform_stat``) against the JAX
package's.

The twin of ``tests/test_stats.py``, test for test: the same observations
go into both packages' estimators, whose snapshots must be equal to the
bit after every update; the selectivity sampler gets generators in the
same state and must draw the same trials and hits; and the reference's
assertions must hold on the port.
"""

import copy

import numpy as np

from _torch_twin import plain
from repro.core import stats as jstats
from repro.core.patterns import PRED_LT as J_PRED_LT
from repro.core.patterns import Predicate as JPredicate
from repro.core.patterns import seq_pattern as j_seq_pattern
from repro_torch.core import stats
from repro_torch.core.patterns import PRED_LT, Predicate, seq_pattern


def estimators(n, **kw):
    return (stats.SlidingWindowEstimator(n=n, **kw),
            jstats.SlidingWindowEstimator(n=n, **kw))


def update_both(est, jest, counts, duration):
    est.update(counts, duration=duration)
    jest.update(counts, duration=duration)
    got = est.snapshot()
    assert plain(got) == plain(jest.snapshot())
    return got


def test_rate_estimation_converges(rng):
    est, jest = estimators(3, num_buckets=8)
    true = np.array([10.0, 3.0, 0.5])
    for _ in range(50):
        got = update_both(est, jest, rng.poisson(true * 2.0), 2.0)
    assert np.allclose(got.rates, true, rtol=0.25)


def test_window_forgets_old_regime(rng):
    est, jest = estimators(1, num_buckets=4)
    for _ in range(10):
        update_both(est, jest, np.array([100.0]), 1.0)
    for _ in range(4):  # window length — old buckets fully evicted
        got = update_both(est, jest, np.array([1.0]), 1.0)
    assert got.rates[0] < 5.0


def test_selectivity_sampling(rng):
    pat = seq_pattern([0, 1], 10.0, (Predicate(0, 1, PRED_LT, 0, 0, 0.0),))
    jpat = j_seq_pattern([0, 1], 10.0,
                         (JPredicate(0, 1, J_PRED_LT, 0, 0, 0.0),))
    t, jt = pat.pred_tensors(), jpat.pred_tensors()
    assert plain(t) == plain(jt)
    pos_of = {0: 0, 1: 1}
    # attrs of type 0 ~ N(-1), type 1 ~ N(+1): P(a0 < a1) ≈ 0.92
    tid = np.repeat([0, 1], 500).astype(np.int32)
    attrs = np.concatenate([rng.normal(-1, 1, (500, 1)),
                            rng.normal(1, 1, (500, 1))]).astype(np.float32)
    jrng = copy.deepcopy(rng)
    trials, hits = stats.sample_selectivities(
        rng, tid, attrs, t, pos_of, 2, samples_per_pair=512)
    jtrials, jhits = jstats.sample_selectivities(
        jrng, tid, attrs, jt, pos_of, 2, samples_per_pair=512)
    assert plain((trials, hits)) == plain((jtrials, jhits))
    assert rng.bit_generator.state == jrng.bit_generator.state
    sel = hits[0, 1] / trials[0, 1]
    assert 0.8 < sel < 1.0


def test_unsampled_pairs_default_to_one():
    est, jest = estimators(2)
    s = update_both(est, jest, np.array([1.0, 1.0]), 1.0)
    assert s.sel[0, 1] == 1.0


def test_stat_values_flat():
    s, js = stats.uniform_stat(3, rate=2.0, sel=0.5), jstats.uniform_stat(
        3, rate=2.0, sel=0.5)
    assert plain(s) == plain(js)
    v = s.values()
    assert plain(v) == plain(js.values())
    assert v.shape == (3 + 6,)
    assert (v[:3] == 2.0).all() and (v[3:] == 0.5).all()
