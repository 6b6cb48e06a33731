"""The port's plan generators (``core/greedy.py``, ``core/zstream.py``,
``core/plans.py``) against the JAX package's.

The twin of ``tests/test_planners.py``, test for test, with the reference
test's statistics (its own ``rand_stat``) and, for its property test, the
fixed examples of ``tests/_prop.py``'s seeded sweep
(``_torch_twin.prop_draws``): both packages' plans and DCS
lists must be equal, costs and margins to the bit, and the reference's
assertions (greedy's §4.1 objective, the DP against enumeration, the DCS
sizes) must hold on the port.
"""

import numpy as np
import pytest

from _torch_twin import plain, prop_draws
from repro.core import greedy as jgreedy
from repro.core import patterns as jpatterns
from repro.core import plans as jplans
from repro.core import zstream as jzstream
from repro.core.stats import Stat as JStat
from repro_torch.core import greedy, patterns, plans, zstream
from repro_torch.core.plans import TreeNode, tree_cost
from repro_torch.core.stats import Stat
from test_planners import rand_stat

GREEDY = (greedy.greedy_order_plan, jgreedy.greedy_order_plan)
ZSTREAM = (zstream.zstream_tree_plan, jzstream.zstream_tree_plan)


def to_port(stat):
    return Stat(np.array(stat.rates), np.array(stat.sel))


def pattern(kind, n, theta=None):
    """``kind`` ("seq" / "and") over types 0..n-1 in each package, with
    chained predicates at ``theta`` if given: (port, JAX)."""
    out = []
    for m in (patterns, jpatterns):
        preds = (() if theta is None
                 else m.chain_predicates(list(range(n)), theta=theta))
        make = m.seq_pattern if kind == "seq" else m.and_pattern
        out.append(make(list(range(n)), 10.0, preds))
    assert plain(out[0]) == plain(out[1])
    return out


def plan_both(planner, pat, jpat, stat):
    got = planner[0](pat, to_port(stat))
    assert plain(got) == plain(planner[1](jpat, stat))
    return got


def test_greedy_no_preds_sorts_by_rate():
    pat, jpat = pattern("seq", 4)
    stat = JStat(np.array([7.0, 1.0, 9.0, 3.0]), np.ones((4, 4)))
    plan, dcs = plan_both(GREEDY, pat, jpat, stat)
    assert plan.order == (1, 3, 0, 2)
    assert [len(c) for _, c in dcs] == [3, 2, 1, 0]


def test_greedy_step_objective():
    pat, jpat = pattern("seq", 4, theta=0.2)
    pred_pairs = set(pat.selectivity_pairs())
    for trial in range(5):
        stat = rand_stat(np.random.default_rng(trial), 4)
        plan, _ = plan_both(GREEDY, pat, jpat, stat)
        chosen = []
        for j in plan.order:
            remaining = [x for x in range(4) if x not in chosen]

            def score(c):
                v = stat.rates[c]
                for k in chosen:
                    if (min(k, c), max(k, c)) in pred_pairs:
                        v *= stat.sel[k, c]
                return v
            assert j == min(remaining, key=lambda c: (score(c), c))
            chosen.append(j)


def _all_interval_trees(lo, hi):
    if hi - lo == 1:
        yield TreeNode(leaf=lo)
        return
    for k in range(lo + 1, hi):
        for left in _all_interval_trees(lo, k):
            for right in _all_interval_trees(k, hi):
                yield TreeNode(left=left, right=right)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_zstream_dp_optimal_vs_enumeration(n):
    pat, jpat = pattern("seq", n, theta=0.1)
    for trial in range(3):
        stat = rand_stat(np.random.default_rng(100 + trial), n, jpat)
        plan, _ = plan_both(ZSTREAM, pat, jpat, stat)
        jplan, _ = ZSTREAM[1](jpat, stat)
        cost = tree_cost(plan.root, to_port(stat))
        assert float.hex(cost) == float.hex(jplans.tree_cost(jplan.root,
                                                             stat))
        best = min(_all_interval_trees(0, n),
                   key=lambda t: tree_cost(t, to_port(stat)))
        assert abs(cost - tree_cost(best, to_port(stat))) < 1e-9


def test_zstream_dcs_counts():
    n = 5
    pat, jpat = pattern("seq", n)
    stat = rand_stat(np.random.default_rng(7), n, jpat)
    _, dcs = plan_both(ZSTREAM, pat, jpat, stat)
    assert len(dcs) == n - 1
    for block, conds in dcs:
        lo, hi = block.split(":")[1].split("..")
        assert len(conds) == int(hi) - int(lo) + 1 - 2


def test_planners_deterministic():
    draws = prop_draws("test_planners", "test_planners_deterministic", 25,
                       n=("int", 2, 6), seed=("int", 0, 10_000))
    for ex in draws:
        n = ex["n"]
        rng = np.random.default_rng(ex["seed"])
        pat, jpat = pattern("and", n, theta=0.3)
        stat = rand_stat(rng, n, jpat)
        for planner in (GREEDY, ZSTREAM):
            p1, _ = plan_both(planner, pat, jpat, stat)
            p2, _ = planner[0](pat, to_port(stat))
            assert p1 == p2


def test_deciding_conditions_hold_at_creation(rng):
    pat, jpat = pattern("seq", 5, theta=0.1)
    stat = rand_stat(rng, 5, jpat)
    for planner in (GREEDY, ZSTREAM):
        _, dcs = plan_both(planner, pat, jpat, stat)
        _, jdcs = planner[1](jpat, stat)
        for (_, conds), (_, jconds) in zip(dcs, jdcs):
            for c, jc in zip(conds, jconds):
                m = c.margin(to_port(stat))
                assert float.hex(m) == float.hex(jc.margin(stat))
                assert m >= -1e-9, str(c)


def test_expr_str_keeps_factors_with_scale():
    cases = [dict(rate_idx=(0, 2), sel_pairs=((0, 2),), scale=0.5),
             dict(rate_idx=(1,)), dict(const_add=2.0, scale=3.0), {}]
    got = [str(plans.Expr(**kw)) for kw in cases]
    assert got == [str(jplans.Expr(**kw)) for kw in cases]
    assert got == ["0.5*r0*r2*s02", "r1", "2 + 3", "1"]
