"""The port's order and tree engines against the JAX package's, on the CPU.

Every case feeds the same seeded stream, cut into chunks, through the JAX
engine's ``process_chunk`` and the port's (the plain kernel versions on
the CPU).  All five ``StepResult`` counters and the ring buffers must be
equal after every chunk, and the full-match totals must equal the
brute-force oracle.  The cases are those of ``tests/test_engine.py`` and
``tests/test_differential.py``: for order plans SEQ in any order, AND,
negation at every position, Kleene with and without a bound, a
four-position pattern and cases whose match set overflows; for tree
plans the three shapes of a four-position tree, the left-deep sweep over
n, negation, Kleene and overflows.  Each overflow runs once more with a
ring buffer of 40 and a match set of 48 rows, which are not multiples of
the join's 32-column bit words, so the survivors kept past capacity come
from a ragged last word.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.engine as jeng
import repro.core.patterns as jpat
import repro.core.plans as jplans
import repro_torch.core.engine as teng
import repro_torch.core.patterns as tpat
import repro_torch.core.plans as tplans
from repro_torch.core.ref_engine import brute_force_matches

EDGES = (0.0, 40.0, 70.0, 100.0)


def gen_stream(rng, n_types, n_events, n_attrs=1, t_end=100.0):
    ts = np.sort(rng.uniform(0, t_end, n_events)).astype(np.float32)
    tid = rng.integers(0, n_types, n_events).astype(np.int32)
    attr = rng.normal(size=(n_events, n_attrs)).astype(np.float32)
    return tid, ts, attr


def _seq_any(m, order):
    return m.seq_pattern([0, 1, 2], 30.0,
                         m.chain_predicates([0, 1, 2], theta=0.3))


def _and(m, order):
    return m.and_pattern([0, 1, 2], 20.0,
                         m.chain_predicates([0, 1, 2], theta=0.5))


def _seq4(m, order):
    return m.seq_pattern([0, 1, 2, 3], 30.0,
                         m.chain_predicates([0, 1, 2, 3], theta=0.4))


def _neg(pos, op_name):
    def build(m, order):
        return m.neg_pattern(
            [0, 1], 20.0, negated_type=2, negated_pos=pos,
            predicates=(m.Predicate(0, 1, m.PRED_LT, 0, 0, 0.5),),
            negated_predicates=(m.Predicate(2, 0, getattr(m, op_name), 0, 0,
                                            1.0),))
    return build


def _kleene(bound):
    def build(m, order):
        return m.kleene_pattern([0, 1, 2], 25.0, kleene_pos=1,
                                predicates=m.chain_predicates([0, 1, 2],
                                                              theta=0.9),
                                kleene_bound=bound)
    return build


def _overflow(m, order):
    return m.and_pattern([0, 1], 100.0)


# (name, pattern builder, order, n_types, n_events, b_cap, m_cap)
CASES = [
    ("seq-012", _seq_any, (0, 1, 2), 3, 60, 64, 512),
    ("seq-210", _seq_any, (2, 1, 0), 3, 60, 64, 512),
    ("seq-102", _seq_any, (1, 0, 2), 3, 60, 64, 512),
    ("and-201", _and, (2, 0, 1), 3, 50, 64, 1024),
    ("seq4-3210", _seq4, (3, 2, 1, 0), 4, 60, 64, 2048),
    ("neg-pos0", _neg(0, "PRED_GT"), (1, 0), 3, 60, 64, 1024),
    ("neg-pos1", _neg(1, "PRED_ABS_LE"), (1, 0), 3, 60, 64, 512),
    ("neg-pos2", _neg(2, "PRED_GT"), (0, 1), 3, 60, 64, 1024),
    ("kleene-unbounded", _kleene(None), (0, 1, 2), 3, 45, 64, 2048),
    ("kleene-bound1", _kleene(1), (2, 0, 1), 3, 45, 64, 2048),
    ("overflow", _overflow, (0, 1), 2, 120, 64, 64),
    # b_cap not a multiple of the 32-column bit words: ragged last word.
    ("overflow-b40", _overflow, (0, 1), 2, 120, 40, 48),
]


@pytest.mark.parametrize("name,build,order,n_types,n_events,b_cap,m_cap",
                         CASES, ids=[c[0] for c in CASES])
def test_order_engine_matches_jax(name, build, order, n_types, n_events,
                                  b_cap, m_cap, rng):
    tid, ts, attr = gen_stream(rng, n_types, n_events)
    jeng_ = jeng.OrderEngine(build(jpat, order),
                             jeng.EngineConfig(b_cap=b_cap, m_cap=m_cap))
    tpattern = build(tpat, order)
    teng_ = teng.OrderEngine(tpattern, teng.EngineConfig(
        b_cap=b_cap, m_cap=m_cap, device="cpu"))
    jstate, tstate = jeng_.init_state(), teng_.init_state()
    totals = np.zeros(5, np.int64)
    for t0, t1 in zip(EDGES[:-1], EDGES[1:]):
        m = (ts > t0) & (ts <= t1)
        chunk = (tid[m], ts[m], attr[m], np.ones(int(m.sum()), bool))
        jstate, jres = jeng_.process_chunk(
            jstate, jeng.Chunk(*map(jnp.asarray, chunk)),
            jplans.OrderPlan(order), t0, t1)
        tstate, tres = teng_.process_chunk(
            tstate, teng.Chunk(*chunk), tplans.OrderPlan(order), t0, t1)
        for f in teng.StepResult._fields:
            got = getattr(tres, f)
            assert got.dtype == teng.torch.int32 and got.shape == (1,)
            assert int(got[0]) == int(getattr(jres, f)), (f, t0)
        for f in teng.Buffers._fields:
            want = np.asarray(getattr(jstate, f))
            got = getattr(tstate, f)[0].numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        totals += [int(getattr(tres, f)[0]) for f in teng.StepResult._fields]
    if name.startswith("overflow"):
        assert totals[2] > 0  # the capacity really truncated
        return
    oracle = brute_force_matches(tpattern, tid, ts, attr, 0.0, 100.0)
    assert totals[0] == oracle.full_matches
    assert totals[4] == oracle.neg_rejected
    assert totals[3] == oracle.closure_expansions


def _tree(m, spec):
    """A TreePlan from a nested tuple of leaves, e.g. ((0, 1), 2)."""
    def node(x):
        if isinstance(x, int):
            return m.TreeNode(leaf=x)
        return m.TreeNode(left=node(x[0]), right=node(x[1]))
    return m.TreePlan(node(spec))


def _seq4_tree(m, tree):
    return m.seq_pattern([0, 1, 2, 3], 25.0,
                         m.chain_predicates([0, 1, 2, 3], theta=0.2))


def _seq_n(n):
    def build(m, tree):
        return m.seq_pattern(list(range(n)), 20.0,
                             m.chain_predicates(list(range(n)), theta=0.2))
    return build


def _left_deep(n):
    spec = 0
    for p in range(1, n):
        spec = (spec, p)
    return spec


# (name, pattern builder, tree, n_types, n_events, b_cap, m_cap)
TREE_CASES = [
    ("tree-balanced", _seq4_tree, ((0, 1), (2, 3)), 4, 48, 64, 1024),
    ("tree-right-deep", _seq4_tree, (0, (1, (2, 3))), 4, 48, 64, 1024),
    ("tree-left-deep", _seq4_tree, (((0, 1), 2), 3), 4, 48, 64, 1024),
    ("left-deep-n2", _seq_n(2), _left_deep(2), 2, 24, 128, 4096),
    ("left-deep-n3", _seq_n(3), _left_deep(3), 3, 36, 128, 4096),
    ("left-deep-n4", _seq_n(4), _left_deep(4), 4, 48, 128, 4096),
    ("tree-neg-pos1", _neg(1, "PRED_ABS_LE"), (0, 1), 3, 60, 64, 512),
    ("tree-kleene", _kleene(None), (0, (1, 2)), 3, 45, 64, 2048),
    ("tree-and", _and, ((0, 1), 2), 3, 50, 64, 1024),
    ("tree-overflow", _overflow, (0, 1), 2, 120, 64, 64),
    ("tree-overflow-b40", _overflow, (0, 1), 2, 120, 40, 48),
]


@pytest.mark.parametrize("name,build,tree,n_types,n_events,b_cap,m_cap",
                         TREE_CASES, ids=[c[0] for c in TREE_CASES])
def test_tree_engine_matches_jax(name, build, tree, n_types, n_events,
                                 b_cap, m_cap, rng):
    """Chunks are padded to one length with invalid events, so the JAX
    engine compiles once per case and the padding path is exercised."""
    tid, ts, attr = gen_stream(rng, n_types, n_events)
    jeng_ = jeng.TreeEngine(build(jpat, tree),
                            jeng.EngineConfig(b_cap=b_cap, m_cap=m_cap))
    tpattern = build(tpat, tree)
    teng_ = teng.TreeEngine(tpattern, teng.EngineConfig(
        b_cap=b_cap, m_cap=m_cap, device="cpu"))
    jstate, tstate = jeng_.init_state(), teng_.init_state()
    totals = np.zeros(5, np.int64)
    for t0, t1 in zip(EDGES[:-1], EDGES[1:]):
        m = np.nonzero((ts > t0) & (ts <= t1))[0]
        idx = np.concatenate([m, np.zeros(n_events - len(m), np.int64)])
        valid = np.arange(n_events) < len(m)
        chunk = (tid[idx], ts[idx], attr[idx], valid)
        jstate, jres = jeng_.process_chunk(
            jstate, jeng.Chunk(*map(jnp.asarray, chunk)),
            _tree(jplans, tree), t0, t1)
        tstate, tres = teng_.process_chunk(
            tstate, teng.Chunk(*chunk), _tree(tplans, tree), t0, t1)
        for f in teng.StepResult._fields:
            got = getattr(tres, f)
            assert got.dtype == teng.torch.int32 and got.shape == (1,)
            assert int(got[0]) == int(getattr(jres, f)), (f, t0)
        for f in teng.Buffers._fields:
            want = np.asarray(getattr(jstate, f))
            got = getattr(tstate, f)[0].numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        totals += [int(getattr(tres, f)[0]) for f in teng.StepResult._fields]
    if name.startswith("tree-overflow"):
        assert totals[2] > 0  # the capacity really truncated
        return
    oracle = brute_force_matches(tpattern, tid, ts, attr, 0.0, 100.0)
    assert totals[0] == oracle.full_matches
    assert totals[4] == oracle.neg_rejected
    assert totals[3] == oracle.closure_expansions


def test_order_and_tree_engines_agree(rng):
    """The two plan families find the same matches on one stream (and the
    same as the JAX order/tree pair), with different join work."""
    def pat(m):
        return m.seq_pattern([0, 1, 2, 3], 25.0,
                             m.chain_predicates([0, 1, 2, 3], theta=0.4))

    tid, ts, attr = gen_stream(rng, 4, 60)
    chunk = (tid, ts, attr, np.ones(len(ts), bool))
    cfg = teng.EngineConfig(b_cap=64, m_cap=2048, device="cpu")
    oe, te = teng.OrderEngine(pat(tpat), cfg), teng.TreeEngine(pat(tpat), cfg)
    _, r1 = oe.process_chunk(oe.init_state(), teng.Chunk(*chunk),
                             tplans.OrderPlan((3, 2, 1, 0)), 0.0, 200.0)
    tree = ((0, 1), (2, 3))
    _, r2 = te.process_chunk(te.init_state(), teng.Chunk(*chunk),
                             _tree(tplans, tree), 0.0, 200.0)
    jte = jeng.TreeEngine(pat(jpat), jeng.EngineConfig(b_cap=64, m_cap=2048))
    _, jr2 = jte.process_chunk(jte.init_state(),
                               jeng.Chunk(*map(jnp.asarray, chunk)),
                               _tree(jplans, tree), 0.0, 200.0)
    assert int(r1.full_matches[0]) == int(r2.full_matches[0]) == \
        int(jr2.full_matches) > 0
    assert int(r2.pm_created[0]) == int(jr2.pm_created)
    assert int(r1.pm_created[0]) != int(r2.pm_created[0])


def test_tree_plan_to_slots_matches_jax():
    """Every contiguous tree over four positions gives the reference's
    slot program; a non-contiguous or out-of-order tree is refused."""
    trees = [((0, 1), (2, 3)), (0, (1, (2, 3))), (((0, 1), 2), 3),
             ((0, (1, 2)), 3), (0, ((1, 2), 3))]
    for tree in trees:
        want = jeng.tree_plan_to_slots(_tree(jplans, tree))
        got = teng.tree_plan_to_slots(_tree(tplans, tree))
        assert got.dtype == want.dtype and np.array_equal(got, want), tree
    for bad in (((0, 2), (1, 3)), ((1, 0), (2, 3))):
        with pytest.raises(AssertionError):
            teng.tree_plan_to_slots(_tree(tplans, bad))
    with pytest.raises(ValueError, match="unknown engine kind"):
        teng._make_engine("nfa", _seq4_tree(tpat, None),
                          teng.EngineConfig(device="cpu"))


def test_order_strips_match_jax():
    """The host-derived predicate strips equal the JAX in-trace ones for
    every order of a four-position SEQ with chain predicates."""
    import itertools

    jspec = jeng.make_spec(_seq4(jpat, None))
    tspec = teng.make_spec(_seq4(tpat, None))
    assert teng.packed_row_count(tspec) == jeng.packed_row_count(jspec)
    assert np.array_equal(teng._packed_thetas(tspec),
                          np.asarray(jeng._packed_thetas(jspec)))
    for order in itertools.permutations(range(4)):
        want = jeng.build_order_strips(jspec, jnp.asarray(order, jnp.int32))
        got = teng.build_order_strips(tspec, np.asarray(order))
        for f in teng.PredicateStrips._fields:
            assert np.array_equal(np.asarray(getattr(want, f)),
                                  getattr(got, f)), (order, f)


def test_cuda_requested_without_gpu_raises():
    if teng.torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.OrderEngine(_and(tpat, None), teng.EngineConfig())
