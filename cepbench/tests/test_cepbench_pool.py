"""The pool: drawn from the seed, on its grids, replayed with shifted
timestamps."""

import numpy as np
import pytest

import _tiny  # noqa: F401  (paths)
from cepbench.pool import make_pool, partition_seeds

CONFIG = {"stream": {"kind": "traffic", "n_types": 4, "chunk_cap": 64,
                     "base_rate": 30.0},
          "quantum": {"ts": 2.0 ** -8, "attr": 2.0 ** -10},
          "session": {"partitions": 3}}


def test_same_seed_same_pool_and_seeds_differ():
    a, b = make_pool(CONFIG, 6, 2 ** 31 + 9), make_pool(CONFIG, 6, 2 ** 31 + 9)
    for f in ("type_id", "ts", "attr", "valid"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    c = make_pool(CONFIG, 6, 2 ** 31 + 10)
    assert not np.array_equal(a.ts, c.ts)
    assert len(set(partition_seeds(-5, 8))) == 8
    assert partition_seeds(2 ** 40, 2) == partition_seeds(2 ** 40, 2)


def test_grid_and_slices():
    pool = make_pool(CONFIG, 6, 11)
    q_ts, q_attr = 2.0 ** -8, 2.0 ** -10
    for j in range(pool.chunks):
        v = pool.valid[j]
        ts = pool.ts[j][v].astype(np.float64)
        assert np.all(ts > j) and np.all(ts <= j + 1)
        assert np.array_equal(ts / q_ts, np.round(ts / q_ts))
        a = pool.attr[j][v].astype(np.float64)
        assert np.array_equal(a / q_attr, np.round(a / q_attr))
        # order within a partition's chunk is kept
        for k in range(pool.partitions):
            t = pool.ts[j, k][pool.valid[j, k]]
            assert np.all(np.diff(t) >= 0)


@pytest.mark.parametrize("step", [0, 5, 6, 13, 6 * 40 + 2])
def test_replay_shifts_by_whole_spans(step):
    pool = make_pool(CONFIG, 6, 12)
    (tid, ts, attr, valid), (t0, t1) = pool.step(step)
    j, cycle = step % 6, step // 6
    assert (t0, t1) == (cycle * 6.0 + j, cycle * 6.0 + j + 1)
    assert np.array_equal(tid, pool.type_id[j])
    assert np.array_equal(attr, pool.attr[j])
    shifted = ts[valid].astype(np.float64) - cycle * 6.0
    assert np.array_equal(shifted, pool.ts[j][valid].astype(np.float64))
    assert np.all(ts[valid] > t0) and np.all(ts[valid] <= t1)
    assert pool.events()[j] == valid.sum()


def test_mirrored_pool_runs_back_in_time_on_the_grid():
    drawn = make_pool(CONFIG, 5, 2 ** 31 + 21)
    pool = make_pool({**CONFIG, "replay": "mirror"}, 5, 2 ** 31 + 21)
    assert pool.chunks == 10 and pool.span == 10.0
    q = 2.0 ** -8
    for f in ("type_id", "ts", "attr", "valid"):
        assert np.array_equal(getattr(pool, f)[:5], getattr(drawn, f))
    for j in range(5):
        src, dst = 4 - j, 5 + j
        for k in range(pool.partitions):
            v, w = drawn.valid[src, k], pool.valid[dst, k]
            n = v.sum()
            assert w.sum() == n and w[:n].all()
            assert np.array_equal(pool.type_id[dst, k][:n],
                                  drawn.type_id[src, k][:n][::-1])
            assert np.array_equal(pool.attr[dst, k][:n],
                                  drawn.attr[src, k][:n][::-1])
            off = drawn.ts[src, k][:n].astype(np.float64) - src
            back = pool.ts[dst, k][:n].astype(np.float64) - dst
            assert np.array_equal(back, (1.0 + q - off)[::-1])
            assert np.all(back > 0) and np.all(back <= 1.0)
            assert np.all(np.diff(back) >= 0)
            assert np.all(pool.ts[dst, k][n:] == 0)
            assert np.all(pool.type_id[dst, k][n:] == drawn.type_id[src, k][n:])
    with pytest.raises(ValueError):
        make_pool({**CONFIG, "replay": "shuffle"}, 2, 1)
