"""The chain reference equals a direct brute force (the enumeration of
``core/ref_engine.py`` with the engine's strict window) on tiny streams."""

import itertools

import numpy as np
import pytest

import _tiny  # noqa: F401  (paths)
from cepbench.harness import compare
from cepbench.pool import Pool, make_pool
from cepbench.patterns.seq import plain as plain_pattern
from cepbench.references import seq_chain


def brute(plain, tid, ts, attr, t0, t1):
    """Every combination of one event per position, checked one by one."""
    n, w = len(plain["types"]), plain["window"]
    keep = ts > t0 - w
    tid, ts, attr = tid[keep], ts[keep], attr[keep]
    idx = [np.nonzero(tid == t)[0] for t in plain["types"]]
    count = 0
    for combo in itertools.product(*idx):
        tt = ts[list(combo)]
        if not all(tt[q] < tt[q + 1] for q in range(n - 1)):
            continue
        if not tt.max() - tt.min() < w or not t0 < tt.max() <= t1:
            continue
        ok = True
        for (a, b, op, theta) in plain["predicates"]:
            x, y, th = attr[combo[a]], attr[combo[b]], float(np.float32(theta))
            ok &= {"lt": x < y + th, "gt": x > y - th,
                   "abs_le": abs(x - y) <= th}[op]
        count += bool(ok)
    return count


def replayed(pool, k, upto):
    parts = [pool.step(s)[0] for s in range(upto + 1)]
    v = [p[3][k] for p in parts]
    return (np.concatenate([p[0][k][m] for p, m in zip(parts, v)]),
            np.concatenate([p[1][k][m] for p, m in zip(parts, v)]
                           ).astype(np.float64),
            np.concatenate([p[2][k][m][:, 0] for p, m in zip(parts, v)]
                           ).astype(np.float64))


@pytest.mark.parametrize("replay", ["wrap", "mirror"])
@pytest.mark.parametrize("kind", ["traffic", "stocks"])
def test_reference_equals_brute_force_over_cycles(kind, replay):
    config = {"stream": {"kind": kind, "n_types": 4, "chunk_cap": 48,
                         "base_rate": 12.0},
              "quantum": {"ts": 2.0 ** -8, "attr": 2.0 ** -10},
              "session": {"partitions": 3}, "replay": replay}
    pool = make_pool(config, 4 if replay == "mirror" else 8, 2 ** 31 + 77)
    plain = plain_pattern({"set": "seq", "size": 4, "window": 3.0,
                           "theta": -0.3})
    steady, head = seq_chain.position_counts(plain, pool)
    total = 0
    for i in range(20):
        j, cycle = i % 8, i // 8
        want = head[j] if cycle == 0 and j < head.shape[0] else steady[j]
        t0, t1 = pool.edges(i)
        for k in range(3):
            got = brute(plain, *replayed(pool, k, i), t0, t1)
            assert got == want[k], (i, k)
            total += got
    assert total > 0


def test_window_is_strict_and_bfloat16_differs():
    """A span of exactly W is no match (the engine's ``max < min + W``);
    one grid step less is; the bfloat16 control loses the difference."""
    q = 2.0 ** -8
    ts = np.zeros((3, 2, 4), np.float32)
    tid = np.full((3, 2, 4), -1, np.int32)
    attr = np.zeros((3, 2, 4, 1), np.float32)
    valid = np.zeros((3, 2, 4), bool)
    for k, last in enumerate((2.5, 2.5 - q)):
        for pos, (t, a) in enumerate(((0.5, 0.0), (1.0, 1.0), (last, 2.0))):
            c = int(np.ceil(t)) - 1
            ts[c, k, pos], tid[c, k, pos] = t, pos
            attr[c, k, pos, 0], valid[c, k, pos] = a, True
    pool = Pool(tid, ts, attr, valid, duration=1.0, ts_quantum=q)
    plain = plain_pattern({"set": "seq", "size": 3, "window": 2.0,
                           "theta": -0.3})
    steady, head = seq_chain.position_counts(plain, pool)
    assert steady[2].tolist() == [0, 1]
    low, _ = seq_chain.position_counts(plain, pool, precision="bfloat16")
    assert compare(low[2:3], np.array([[0, 1]])).any()
