"""The plain reference for SEQ patterns whose predicates join adjacent
positions: exact full-match counts per chunk and partition.

Semantics (those of the program's data plane, ``core/engine.py``): a match
takes one event of each position's type with strictly increasing
timestamps, every predicate true, and a span (last timestamp minus first)
strictly below the window ``W`` (the engine's window rows are ``max < min
+ W`` and ``min > max - W``).  It is counted once, in the chunk ``(t0,
t1]`` that holds its last event, from events newer than ``t0 - W``.

Instead of enumerating every combination (the brute force of
``core/ref_engine.py``), the count is a product of 0/1 matrices: for
consecutive positions ``p-1, p``, ``M_p[a, b]`` says event ``a`` may
precede event ``b``; the chain product ``M_1 @ ... @ M_{n-1}`` counts the
chains from each first event to each last one, and the window and the
chunk pick the (first, last) pairs that count.  Counts are exact in
float64 (integers below 2**53).  With ``precision="bfloat16"`` the
timestamps, attributes and comparisons are in bfloat16 instead: the
control that a sound comparison must tell apart.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _pred(op, a, b, theta):
    if op == "lt":
        return a < b + theta
    if op == "gt":
        return a > b - theta
    if op == "abs_le":
        return (a - b).abs() <= theta
    raise ValueError(f"unknown predicate op {op!r}")


def _adjacent(plain):
    preds = {}
    for (a, b, op, theta) in plain["predicates"]:
        if abs(a - b) != 1:
            raise ValueError("seq_chain handles predicates of adjacent "
                             f"positions only, got ({a}, {b})")
        preds.setdefault(min(a, b), []).append(
            (op, a < b, float(np.float32(theta))))
    return preds


def _events(pool, j, wrap, hist):
    """Events of positions ``j - hist .. j`` in the time frame of the
    first cycle: ``(type, ts f64, attr f64, valid)`` of ``(K, L)``; with
    ``wrap`` the positions before 0 are the previous cycle's."""
    parts = []
    for idx in range(j - hist, j + 1):
        shift = 0.0
        if idx < 0:
            if not wrap:
                continue
            idx, shift = idx + pool.chunks, -pool.span
        parts.append((pool.type_id[idx], pool.ts[idx].astype(np.float64)
                      + shift, pool.attr[idx][..., 0].astype(np.float64),
                      pool.valid[idx]))
    return [np.concatenate([p[f] for p in parts], axis=1) for f in range(4)]


def _position_counts(plain, preds, pool, j, wrap, device, dtype):
    window = plain["window"]
    hist = int(math.ceil(window / pool.duration))
    t0 = j * pool.duration
    t1 = t0 + pool.duration
    tid, ts, attr, valid = (torch.as_tensor(x, device=device)
                            for x in _events(pool, j, wrap, hist))
    ts, attr = ts.to(dtype), attr.to(dtype)
    w = torch.tensor(window, dtype=dtype, device=device)
    lo = torch.tensor(t0 - window, dtype=dtype, device=device)
    keep = valid & (ts > lo)
    cols = []
    for t in plain["types"]:
        m = keep & (tid == t)
        n = m.sum(1)
        width = max(int(n.max()), 1)
        order = torch.argsort((~m).to(torch.int8), dim=1, stable=True)
        order = order[:, :width]
        live = torch.arange(width, device=device)[None, :] < n[:, None]
        cols.append((torch.gather(ts, 1, order), torch.gather(attr, 1, order),
                     live))
    chain = None
    for p in range(1, len(cols)):
        (ta, aa, va), (tb, ab, vb) = cols[p - 1], cols[p]
        ok = va[:, :, None] & vb[:, None, :] & (ta[:, :, None]
                                                < tb[:, None, :])
        for (op, forward, theta) in preds.get(p - 1, ()):
            x, y = aa[:, :, None], ab[:, None, :]
            th = torch.tensor(theta, dtype=dtype, device=device)
            ok = ok & (_pred(op, x, y, th) if forward else _pred(op, y, x, th))
        step = ok.to(torch.float64)
        chain = step if chain is None else torch.bmm(chain, step)
    (tf, _, vf), (tl, _, vl) = cols[0], cols[-1]
    hi = torch.tensor(t1, dtype=dtype, device=device)
    first = torch.tensor(t0, dtype=dtype, device=device)
    last_in = vl & (tl > first) & (tl <= hi)
    span_ok = (tl[:, None, :] - tf[:, :, None]) < w
    final = vf[:, :, None] & last_in[:, None, :] & span_ok
    counts = (chain * final.to(torch.float64)).sum(dim=(1, 2))
    return counts.round().to(torch.int64).cpu().numpy()


def position_counts(plain, pool, *, device="cpu", precision="exact"):
    """Full-match counts of every pool position, ``(P, K)`` int64, as the
    replay hands them over from the second cycle on, and ``(H, K)`` for
    the first ``H = ceil(W / duration)`` positions of the first cycle,
    whose history starts at time 0."""
    if plain["operator"] != "SEQ":
        raise ValueError("seq_chain counts SEQ patterns only")
    dtype = {"exact": torch.float64, "bfloat16": torch.bfloat16}[precision]
    preds = _adjacent(plain)
    hist = int(math.ceil(plain["window"] / pool.duration))
    steady = np.stack([_position_counts(plain, preds, pool, j, True, device,
                                        dtype)
                       for j in range(pool.chunks)])
    head = np.stack([_position_counts(plain, preds, pool, j, False, device,
                                      dtype)
                     for j in range(min(hist, pool.chunks))])
    return steady, head
