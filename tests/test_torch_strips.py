"""The order engine's per-row predicate strips, on the CPU.

``OrderEngine.plan_operands`` keeps each order row's strips
(``build_order_strips``, held against the JAX package's in
``tests/test_torch_engine.py``) and stacks a plan matrix from them.  The
stack must equal a fresh per-row build field for field, dtype for dtype;
``engine.STRIP_COUNTS`` counts the rows derived and the rows served from
the memo; past ``_STRIPS_CAP`` rows the least recently used go.  Each
block of a meshed ``FleetEngine`` keeps its own rows, and tree plans
never look a row up.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import engine as teng
from repro_torch.core import fleet
from repro_torch.core.patterns import chain_predicates, seq_pattern
from repro_torch.distributed import Blocks, CepMesh

CPU = torch.device("cpu")
CFG = teng.EngineConfig(device="cpu")


def _seq(n):
    return seq_pattern(list(range(n)), 30.0,
                       chain_predicates(list(range(n)), theta=0.4))


def _orders(rng, k, n):
    return np.stack([rng.permutation(n) for _ in range(k)]).astype(np.int32)


def _assert_fresh(spec, rows, ops):
    """``ops`` equals the operands of a fresh per-row build of ``rows``."""
    rows = np.atleast_2d(np.asarray(rows, np.int64))
    want = [teng.build_order_strips(spec, r) for r in rows]
    assert ops.row.dtype == torch.int64
    assert torch.equal(ops.row, torch.as_tensor(rows))
    for f in teng.PredicateStrips._fields:
        w = torch.as_tensor(np.stack([getattr(s, f) for s in want]))
        g = getattr(ops.strips, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert torch.equal(g, w), f


@pytest.mark.parametrize("k", [1, 128])
@pytest.mark.parametrize("n", [3, 6, 8])
def test_memoised_operands_equal_fresh_build(n, k):
    """Cold, then over a second matrix that shares some rows with the
    first: both stacks equal fresh builds (K = 1 also as one (n,) row)."""
    rng = np.random.default_rng(1000 * n + k)
    eng = teng.OrderEngine(_seq(n), CFG)
    first = _orders(rng, k, n)
    second = first.copy()
    second[::2] = _orders(rng, len(second[::2]), n)
    for rows in (first, second, first[0] if k == 1 else first):
        _assert_fresh(eng.spec, rows, eng.plan_operands(rows))


def test_one_changed_row_builds_one_row():
    rng = np.random.default_rng(6)
    eng = teng.OrderEngine(_seq(6), CFG)
    rows = _orders(rng, 128, 6)
    eng.plan_operands(rows)
    seen = {r.tobytes() for r in rows}
    new = next(np.asarray(p, np.int32)
               for p in itertools.permutations(range(6))
               if np.asarray(p, np.int32).tobytes() not in seen)
    rows = rows.copy()
    rows[37] = new
    teng.reset_strip_counts()
    ops = eng.plan_operands(rows)
    assert teng.STRIP_COUNTS == {"built": 1, "reused": 127}
    _assert_fresh(eng.spec, rows, ops)


def test_earlier_matrix_builds_nothing():
    rng = np.random.default_rng(7)
    eng = teng.OrderEngine(_seq(6), CFG)
    a, b = _orders(rng, 128, 6), _orders(rng, 128, 6)
    eng.plan_operands(a)
    eng.plan_operands(b)
    teng.reset_strip_counts()
    ops = eng.plan_operands(a)
    assert teng.STRIP_COUNTS == {"built": 0, "reused": 128}
    _assert_fresh(eng.spec, a, ops)


def test_memo_stays_at_its_cap():
    """More distinct n = 8 orders than the cap: the memo holds the cap,
    the oldest rows go first, and every stack (evicted rows rebuilt)
    equals a fresh build."""
    rng = np.random.default_rng(8)
    eng = teng.OrderEngine(_seq(8), CFG)
    cap, k = eng._STRIPS_CAP, 128
    perms = np.asarray(list(itertools.permutations(range(8))), np.int32)
    orders = perms[rng.choice(len(perms), cap + k, replace=False)]
    teng.reset_strip_counts()
    for i in range(0, len(orders), k):
        _assert_fresh(eng.spec, orders[i:i + k],
                      eng.plan_operands(orders[i:i + k]))
    assert teng.STRIP_COUNTS == {"built": cap + k, "reused": 0}
    assert len(eng._strips) == cap
    assert orders[0].tobytes() not in eng._strips
    assert orders[-1].tobytes() in eng._strips
    teng.reset_strip_counts()
    _assert_fresh(eng.spec, orders[:k], eng.plan_operands(orders[:k]))
    assert teng.STRIP_COUNTS == {"built": k, "reused": 0}
    assert len(eng._strips) == cap


def test_mesh_blocks_keep_their_own_rows():
    """A meshed fleet at D = 2 (two CPU blocks of 64): each block's
    operands equal a fresh build of its rows; a replan in block 1 leaves
    block 0's cached operands as they were and derives one row."""
    rng = np.random.default_rng(2)
    eng = fleet.FleetEngine("order", _seq(6), 128, CFG,
                            mesh=CepMesh((CPU, CPU)))
    rows = _orders(rng, 128, 6)
    ops = eng.plan_operands(rows)
    assert isinstance(ops, Blocks) and len(ops) == 2
    for b, r, o in zip(eng.blocks, eng.layout.split(rows), ops):
        _assert_fresh(b.base.spec, r, o)
    seen = {r.tobytes() for r in rows}
    rows = rows.copy()
    rows[100] = next(np.asarray(p, np.int32)
                     for p in itertools.permutations(range(6))
                     if np.asarray(p, np.int32).tobytes() not in seen)
    teng.reset_strip_counts()
    again = eng.plan_operands(rows)
    assert teng.STRIP_COUNTS == {"built": 1, "reused": 63}
    assert again[0] is ops[0]
    for b, r, o in zip(eng.blocks, eng.layout.split(rows), again):
        _assert_fresh(b.base.spec, r, o)


def test_tree_plans_look_no_row_up():
    eng = teng.TreeEngine(_seq(4), CFG)
    slots = np.asarray([[0, 1], [4, 2], [5, 3]], np.int32)
    teng.reset_strip_counts()
    ops = eng.plan_operands(np.stack([slots] * 8))
    assert ops.shape == (8, 3, 2)
    assert teng.STRIP_COUNTS == {"built": 0, "reused": 0}
