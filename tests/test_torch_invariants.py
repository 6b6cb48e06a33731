"""The paper's guarantees (Theorems 1 and 2) on the port's host copies of
``core/greedy.py``, ``core/zstream.py``, ``core/invariants.py`` and
``core/decision.py``, against the JAX package's.

The twin of ``tests/test_invariants.py``, test for test, on its fixed
seeds and, for its property tests, the fixed examples of ``tests/
_prop.py``'s seeded sweep (``_torch_twin.prop_draws``).
The statistics are drawn once with the reference test's own ``rand_stat``
/ ``drift`` and handed to both packages as the same arrays; per example the
plans, the DCS lists, the selected invariants, every ``check`` and the
replanned plan must be equal (floats to the bit), and the reference's
assertion must hold on the port.
"""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest

from _torch_twin import plain, prop_draws
from repro.core import decision as jdecision
from repro.core import greedy as jgreedy
from repro.core import invariants as jinv
from repro.core import zstream as jzstream
from repro.core.patterns import chain_predicates as j_chain_predicates
from repro.core.patterns import seq_pattern as j_seq_pattern
from repro_torch.core import decision, greedy, invariants, zstream
from repro_torch.core.patterns import chain_predicates, seq_pattern
from repro_torch.core.stats import Stat
from test_invariants import drift, rand_stat

PLANNERS = {"greedy_order_plan": (greedy.greedy_order_plan,
                                  jgreedy.greedy_order_plan),
            "zstream_tree_plan": (zstream.zstream_tree_plan,
                                  jzstream.zstream_tree_plan)}
DRAWS = dict(n=("int", 3, 6), seed=("int", 0, 10_000),
             dscale=("float", 0.05, 1.0))


def to_port(stat):
    return Stat(np.array(stat.rates), np.array(stat.sel))


def chain_seq(n, theta=0.1):
    """The reference test's pattern in each package: (port, JAX)."""
    if theta is None:
        return (seq_pattern(list(range(n)), 10.0),
                j_seq_pattern(list(range(n)), 10.0))
    return (seq_pattern(list(range(n)), 10.0,
                        chain_predicates(list(range(n)), theta=theta)),
            j_seq_pattern(list(range(n)), 10.0,
                          j_chain_predicates(list(range(n)), theta=theta)))


def plan_both(planner, pat, jpat, stat):
    """(plan, dcs) of each package on the same statistics; equal."""
    port, jax = planner
    got, want = port(pat, to_port(stat)), jax(jpat, stat)
    assert plain(got) == plain(want)
    return got, want


def sets_both(dcs, jdcs, stat, d, **kw):
    """The selected invariants of each package as ``InvariantSet``s;
    equal, and so are their lowered tensors."""
    invs = invariants.select_invariants(dcs, to_port(stat), **kw)
    jinvs = jinv.select_invariants(jdcs, stat, **kw)
    assert plain(invs) == plain(jinvs)
    iset, jset = invariants.InvariantSet(invs, d=d), jinv.InvariantSet(
        jinvs, d=d)
    if invs:
        n = stat.n
        assert plain(iset.lower(n)) == plain(jset.lower(n))
    return invs, jinvs, iset, jset


def check_both(iset, jset, stat):
    got = iset.check(to_port(stat))
    assert got == jset.check(stat)
    return got


def shim_prop():
    """``tests/_prop.py`` loaded as where hypothesis is not installed."""
    spec = importlib.util.spec_from_file_location(
        "_prop_fallback", os.path.join(os.path.dirname(__file__),
                                       "_prop.py"))
    mod = importlib.util.module_from_spec(spec)
    saved = sys.modules.get("hypothesis")
    sys.modules["hypothesis"] = None          # import hypothesis fails
    try:
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            del sys.modules["hypothesis"]
        else:
            sys.modules["hypothesis"] = saved
    assert not mod.HAVE_HYPOTHESIS
    return mod


def test_prop_draws_are_the_shims():
    """``prop_draws`` gives what ``_prop.given`` hands the reference test
    where hypothesis is not installed."""
    _prop = shim_prop()
    seen = []

    def probe(n, seed, dscale):
        seen.append(dict(n=n, seed=seed, dscale=dscale))

    probe.__module__ = "test_invariants"
    probe.__qualname__ = "test_theorem1_no_false_positives"
    _prop.settings(max_examples=60, deadline=None)(_prop.given(
        n=_prop.st.integers(3, 6), seed=_prop.st.integers(0, 10_000),
        dscale=_prop.st.floats(0.05, 1.0))(probe))()
    assert seen == prop_draws("test_invariants",
                              "test_theorem1_no_false_positives", 60,
                              **DRAWS)


@pytest.mark.parametrize("planner", list(PLANNERS))
def test_theorem1_no_false_positives(planner):
    fired = 0
    for ex in prop_draws("test_invariants",
                         "test_theorem1_no_false_positives", 60, **DRAWS):
        n, seed, dscale = ex["n"], ex["seed"], ex["dscale"]
        rng = np.random.default_rng(seed)
        pat, jpat = chain_seq(n)
        stat0 = rand_stat(rng, n)
        (plan0, dcs), (_, jdcs) = plan_both(PLANNERS[planner], pat, jpat,
                                            stat0)
        _, _, iset, jset = sets_both(dcs, jdcs, stat0, 0.0, strategy="all")
        for _ in range(5):
            stat1 = drift(rng, stat0, dscale)
            if check_both(iset, jset, stat1):
                fired += 1
                (plan1, _), _ = plan_both(PLANNERS[planner], pat, jpat,
                                          stat1)
                assert plan1 != plan0, (seed, planner)
    assert fired > 0


def test_theorem2_no_false_negatives_greedy():
    changed = 0
    for ex in prop_draws("test_invariants",
                         "test_theorem2_no_false_negatives_greedy", 60,
                         **DRAWS):
        n, seed, dscale = ex["n"], ex["seed"], ex["dscale"]
        rng = np.random.default_rng(seed)
        pat, jpat = chain_seq(n)
        stat0 = rand_stat(rng, n)
        planner = PLANNERS["greedy_order_plan"]
        (plan0, dcs), (_, jdcs) = plan_both(planner, pat, jpat, stat0)
        _, _, iset, jset = sets_both(dcs, jdcs, stat0, 0.0, strategy="all")
        for _ in range(5):
            stat1 = drift(rng, stat0, dscale)
            (plan1, _), _ = plan_both(planner, pat, jpat, stat1)
            fired = check_both(iset, jset, stat1)
            if plan1 != plan0:
                changed += 1
                assert fired, seed
    assert changed > 0


def test_k_invariant_monotone_sensitivity(rng):
    n = 5
    pat, jpat = chain_seq(n)
    stat0 = rand_stat(rng, n)
    (_, dcs), (_, jdcs) = plan_both(PLANNERS["greedy_order_plan"], pat,
                                    jpat, stat0)
    sets = {k: sets_both(dcs, jdcs, stat0, 0.0, k=k)[2:] for k in (1, 2, 4)}
    fired = {k: 0 for k in sets}
    for i in range(200):
        stat1 = drift(np.random.default_rng(i), stat0, 0.3)
        for k, (s, js) in sets.items():
            fired[k] += int(check_both(s, js, stat1))
    assert fired[1] <= fired[2] <= fired[4]


def test_distance_d_damps_firing(rng):
    n = 4
    pat, jpat = chain_seq(n, theta=None)
    stat0 = rand_stat(rng, n)
    (_, dcs), (_, jdcs) = plan_both(PLANNERS["greedy_order_plan"], pat,
                                    jpat, stat0)
    counts = []
    for d in (0.0, 0.2, 0.5):
        _, _, s, js = sets_both(dcs, jdcs, stat0, d)
        counts.append(sum(
            check_both(s, js, drift(np.random.default_rng(i), stat0, 0.25))
            for i in range(200)))
    assert counts[0] >= counts[1] >= counts[2]
    assert counts[0] > counts[2]


def test_vectorized_check_matches_scalar(rng):
    n = 5
    pat, jpat = chain_seq(n, theta=0.2)
    stat0 = rand_stat(rng, n)
    (_, dcs), (_, jdcs) = plan_both(PLANNERS["zstream_tree_plan"], pat,
                                    jpat, stat0)
    invs, _, iset, jset = sets_both(dcs, jdcs, stat0, 0.1, strategy="all")
    for i in range(20):
        stat1 = drift(np.random.default_rng(i), stat0, 0.4)
        slow = any(not c.holds(to_port(stat1), d=0.1) for c in invs)
        assert check_both(iset, jset, stat1) == slow
        assert iset.first_violation(to_port(stat1)) == \
            jset.first_violation(stat1)


def test_d_avg_estimate_positive(rng):
    n = 5
    pat, jpat = chain_seq(n, theta=None)
    stat = rand_stat(rng, n)
    (_, dcs), (_, jdcs) = plan_both(PLANNERS["greedy_order_plan"], pat,
                                    jpat, stat)
    d = invariants.d_avg_estimate(dcs, to_port(stat))
    assert float.hex(d) == float.hex(jinv.d_avg_estimate(jdcs, stat))
    assert d > 0.0


def test_violation_prob_strategy(rng):
    n = 4
    pat, jpat = chain_seq(n, theta=None)
    stat = rand_stat(rng, n)
    (_, dcs), (_, jdcs) = plan_both(PLANNERS["greedy_order_plan"], pat,
                                    jpat, stat)
    std = dict(std_rates=np.full(n, 1.0), std_sel=np.full((n, n), 0.1))
    prob = invariants.make_variance_violation_prob(**std)
    jprob = jinv.make_variance_violation_prob(**std)
    invs = invariants.select_invariants(dcs, to_port(stat), strategy="prob",
                                        violation_prob=prob)
    jinvs = jinv.select_invariants(jdcs, stat, strategy="prob",
                                   violation_prob=jprob)
    assert plain(invs) == plain(jinvs)
    assert len(invs) == sum(1 for _, c in dcs if c)
    for (_, conds), (_, jconds) in zip(dcs, jdcs):
        for c, jc in zip(conds, jconds):
            assert float.hex(prob(c, to_port(stat))) == \
                float.hex(jprob(jc, stat))
    prob0 = invariants.make_variance_violation_prob(np.zeros(n),
                                                    np.zeros((n, n)))
    jprob0 = jinv.make_variance_violation_prob(np.zeros(n), np.zeros((n, n)))
    for (_, conds), (_, jconds) in zip(dcs, jdcs):
        for c, jc in zip(conds, jconds):
            p = prob0(c, to_port(stat))
            assert p in (0.0, 1.0) and p == jprob0(jc, stat)


def test_zstream_exact_vs_paper_freeze():
    """freeze='none' (exact live cost sums) has no false positive; the
    paper's frozen constants have some: the same count in both packages,
    seed for seed."""
    stats = {}
    for mode in ("none", "paper"):
        planner = (functools.partial(zstream.zstream_tree_plan, freeze=mode),
                   functools.partial(jzstream.zstream_tree_plan,
                                     freeze=mode))
        fp = 0
        for seed in range(60):
            rng = np.random.default_rng(seed)
            n = int(rng.integers(3, 7))
            pat, jpat = chain_seq(n)
            s0 = rand_stat(rng, n)
            (p0, dcs), (_, jdcs) = plan_both(planner, pat, jpat, s0)
            _, _, iset, jset = sets_both(dcs, jdcs, s0, 0.0, strategy="all")
            for _ in range(4):
                s1 = drift(rng, s0, rng.uniform(0.05, 0.8))
                if check_both(iset, jset, s1):
                    (p1, _), _ = plan_both(planner, pat, jpat, s1)
                    fp += int(p1 == p0)
        stats[mode] = fp
    assert stats["none"] == 0, stats
    assert stats["paper"] > stats["none"]


def test_policy_factory():
    for name in ("static", "unconditional", "threshold", "invariant"):
        p, jp = decision.make_policy(name), jdecision.make_policy(name)
        assert p.name == jp.name == name
        assert type(p).__name__ == type(jp).__name__
        assert plain(vars(p)) == plain(vars(jp))
    for make in (decision.make_policy, jdecision.make_policy):
        with pytest.raises(ValueError):
            make("nope")
