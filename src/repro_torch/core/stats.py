"""Sliding-window statistics estimation (paper §2.2, refs [14, 27]).

The monitored set ``Stat`` consists of per-type event arrival rates and
pairwise predicate selectivities.  We maintain both over a sliding window of
recent stream history using a ring of time buckets — a simplified (exact
count, bounded memory) variant of the exponential-histogram techniques of
Datar et al. [27]: the engine processes chunks, each chunk contributes one
bucket of per-type counts and per-pair (trials, successes) selectivity
samples, and the estimate is the aggregate over the last ``num_buckets``
buckets.  This costs O(n + n²) memory and O(1) amortized update time, which
matches the paper's "negligible system resources" requirement.

Two implementations of the same window semantics live here:

* ``SlidingWindowEstimator`` — the host (numpy) estimator used by the
  single-stream adaptation loop, fed by Monte-Carlo ``sample_selectivities``.
* ``MonitorState`` + the ``monitor_*`` functions — the **device** rings
  (torch tensors, one per fleet partition) used by the fused monitored
  step (`engine.make_monitored_process`), fed by exhaustive, RNG-free
  ``chunk_observations``.  The rings live on the device, so per-chunk
  monitoring costs no device→host transfer; the host pulls a partition's
  ``(rates, sel)`` snapshot only when that partition's invariant flag
  fired.  The numpy twin
  ``exhaustive_selectivities`` computes identical trials/hits on the host,
  which is what makes host-vs-device differential tests exact.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Stat:
    """A snapshot of the monitored statistic values.

    rates: (n,) arrival rate per pattern position [events / time unit].
    sel:   (n, n) predicate selectivity per position pair; 1.0 where no
           predicate is defined (paper §4.1).  ``sel[i, i]`` holds the
           selectivity of conditions defined solely on type i.
    """

    rates: np.ndarray
    sel: np.ndarray

    @property
    def n(self) -> int:
        return int(self.rates.shape[0])

    def values(self) -> np.ndarray:
        """Flat view of all monitored values (for threshold policies)."""
        iu = np.triu_indices(self.n)
        return np.concatenate([self.rates, self.sel[iu]])

    def copy(self) -> "Stat":
        return Stat(self.rates.copy(), self.sel.copy())


def uniform_stat(n: int, rate: float = 1.0, sel: float = 1.0) -> Stat:
    s = np.full((n, n), sel, np.float64)
    return Stat(np.full((n,), rate, np.float64), s)


class SlidingWindowEstimator:
    """Windowed arrival-rate + selectivity estimator.

    Parameters
    ----------
    n: number of pattern positions (event types) monitored.
    num_buckets: sliding-window length in chunks.
    laplace: additive smoothing for selectivity (avoids 0/0 on cold pairs).
    """

    def __init__(self, n: int, num_buckets: int = 16, laplace: float = 1.0):
        self.n = n
        self.num_buckets = num_buckets
        self.laplace = float(laplace)
        self._counts = np.zeros((num_buckets, n), np.float64)
        self._durations = np.zeros((num_buckets,), np.float64)
        self._sel_trials = np.zeros((num_buckets, n, n), np.float64)
        self._sel_hits = np.zeros((num_buckets, n, n), np.float64)
        self._head = 0
        self._filled = 0

    def update(
        self,
        counts: np.ndarray,
        duration: float,
        sel_trials: Optional[np.ndarray] = None,
        sel_hits: Optional[np.ndarray] = None,
    ) -> None:
        """Push one chunk worth of observations into the window."""
        h = self._head
        self._counts[h] = counts
        self._durations[h] = max(float(duration), 1e-9)
        self._sel_trials[h] = 0.0 if sel_trials is None else sel_trials
        self._sel_hits[h] = 0.0 if sel_hits is None else sel_hits
        self._head = (h + 1) % self.num_buckets
        self._filled = min(self._filled + 1, self.num_buckets)

    def snapshot(self) -> Stat:
        k = max(self._filled, 1)
        total_t = self._durations[:k].sum() if self._filled else 1.0
        # Use the whole ring; un-filled buckets are zero and do not bias sums.
        rates = self._counts.sum(axis=0) / max(total_t, 1e-9)
        trials = self._sel_trials.sum(axis=0)
        hits = self._sel_hits.sum(axis=0)
        lp = self.laplace
        sel = (hits + lp) / (trials + 2.0 * lp)
        # Pairs with no predicate ever sampled: selectivity 1 (paper §4.1).
        sel = np.where(trials > 0, sel, 1.0)
        return Stat(rates, sel)

    @property
    def ready(self) -> bool:
        return self._filled > 0


# ---------------------------------------------------------------------------
# Device-resident window estimator (used by the fused monitored step)
# ---------------------------------------------------------------------------


class MonitorState(NamedTuple):
    """Device twin of the fleet's sliding statistics windows.

    Same ring-of-buckets semantics as ``SlidingWindowEstimator`` (and one
    row of ``fleet.FleetEstimator`` per partition), held as torch tensors
    with a leading partition axis K and updated on the device inside the
    monitored step.
    """

    counts: "object"     # (K, buckets, n) f32 per-type counts per bucket
    durations: "object"  # (K, buckets)   f32 chunk durations
    trials: "object"     # (K, buckets, n, n) f32 predicate pair trials
    hits: "object"       # (K, buckets, n, n) f32 predicate pair hits
    head: "object"       # (K,) i32 ring head
    filled: "object"     # (K,) i32 buckets filled so far


def monitor_init(n: int, num_buckets: int = 16,
                 device="cuda") -> MonitorState:
    """One partition's empty ring (a fleet of one: K = 1)."""
    return fleet_monitor_init(1, n, num_buckets, device)


def fleet_monitor_init(k: int, n: int, num_buckets: int = 16,
                       device="cuda") -> MonitorState:
    """Stacked per-partition statistics rings: every field leads with K."""
    import torch

    f32 = dict(dtype=torch.float32, device=device)
    return MonitorState(
        counts=torch.zeros((k, num_buckets, n), **f32),
        durations=torch.zeros((k, num_buckets), **f32),
        trials=torch.zeros((k, num_buckets, n, n), **f32),
        hits=torch.zeros((k, num_buckets, n, n), **f32),
        head=torch.zeros((k,), dtype=torch.int32, device=device),
        filled=torch.zeros((k,), dtype=torch.int32, device=device),
    )


def monitor_update(state: MonitorState, counts, duration, trials,
                   hits) -> MonitorState:
    """Push one chunk of observations into every partition's ring (device
    mirror of ``SlidingWindowEstimator.update``).  ``counts`` (K, n),
    ``duration`` (K,), ``trials``/``hits`` (K, n, n)."""
    import torch

    k, buckets = state.durations.shape
    kidx = torch.arange(k, device=state.head.device)
    h = state.head.long()

    def put(field, value):
        out = field.clone()
        out[kidx, h] = value.to(out.dtype)
        return out

    return MonitorState(
        counts=put(state.counts, counts),
        durations=put(state.durations, torch.clamp(
            duration.to(torch.float32), min=1e-9)),
        trials=put(state.trials, trials),
        hits=put(state.hits, hits),
        head=((state.head + 1) % buckets).to(torch.int32),
        filled=torch.clamp(state.filled + 1, max=buckets).to(torch.int32),
    )


def monitor_snapshot(state: MonitorState, laplace: float = 1.0):
    """(rates (K, n), sel (K, n, n)) — device mirror of ``snapshot``."""
    import torch

    total_t = torch.where(state.filled > 0, state.durations.sum(dim=-1),
                          1.0)
    rates = state.counts.sum(dim=-2) / torch.clamp(total_t, min=1e-9)[:, None]
    trials = state.trials.sum(dim=-3)
    hits = state.hits.sum(dim=-3)
    lp = laplace
    sel = (hits + lp) / (trials + 2.0 * lp)
    sel = torch.where(trials > 0, sel, 1.0)
    return rates, sel


def _pred_ok(xp, op: int, theta: float, a, b):
    from .patterns import PRED_ABS_LE, PRED_GT, PRED_LT

    if op == PRED_LT:
        return a < b + theta
    if op == PRED_GT:
        return a > b - theta
    if op == PRED_ABS_LE:
        return xp.abs(a - b) <= theta
    raise ValueError(f"unexpected predicate op {op}")  # pragma: no cover


def chunk_observations(tid, attr, valid, type_ids: Sequence[int],
                       pred_tensors: dict):
    """Per-chunk monitored observations for K partitions, on the device.

    ``tid``/``valid`` (K, N), ``attr`` (K, N, A).  Returns (counts (K, n),
    trials (K, n, n), hits (K, n, n)).  Selectivities are **exhaustive**:
    for every pattern-position pair carrying a predicate, every cross pair
    of in-chunk events of the two types is evaluated — deterministic (no
    RNG), which is what lets the host verify the device flags bit for bit.
    All values are integers held in f32, so the sums are exact.
    """
    import torch

    from .patterns import PRED_NONE

    n = len(type_ids)
    k = tid.shape[0]
    op_t = np.asarray(pred_tensors["op"])
    a_attr = np.asarray(pred_tensors["a_attr"])
    b_attr = np.asarray(pred_tensors["b_attr"])
    theta = np.asarray(pred_tensors["theta"])

    masks = [valid & (tid == t) for t in type_ids]
    counts = torch.stack([m.sum(dim=1).to(torch.float32) for m in masks],
                         dim=1)
    trials = torch.zeros((k, n, n), dtype=torch.float32, device=tid.device)
    hits = torch.zeros_like(trials)
    for p in range(n):
        for q in range(p + 1, n):
            if op_t[p, q] == PRED_NONE:
                continue
            a = attr[:, :, a_attr[p, q]]
            b = attr[:, :, b_attr[p, q]]
            ok = _pred_ok(torch, int(op_t[p, q]), float(theta[p, q]),
                          a[:, :, None], b[:, None, :])
            pair_mask = masks[p][:, :, None] & masks[q][:, None, :]
            t_pq = counts[:, p] * counts[:, q]
            h_pq = (ok & pair_mask).sum(dim=(1, 2)).to(torch.float32)
            trials[:, p, q] = t_pq
            trials[:, q, p] = t_pq
            hits[:, p, q] = h_pq
            hits[:, q, p] = h_pq
    return counts, trials, hits


def exhaustive_selectivities(
    tid: np.ndarray,
    attrs: np.ndarray,
    pred_tensors: dict,
    type_ids: Sequence[int],
    n: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host numpy twin of ``chunk_observations``'s selectivity part.

    Same exhaustive pair counting over one (already valid-filtered) chunk;
    returns float64 (trials, hits) for the host estimator rings.  Used by
    differential tests and by host-side catch-up after a violation.
    """
    from .patterns import PRED_NONE

    op_t = np.asarray(pred_tensors["op"])
    a_attr = np.asarray(pred_tensors["a_attr"])
    b_attr = np.asarray(pred_tensors["b_attr"])
    theta = np.asarray(pred_tensors["theta"])
    trials = np.zeros((n, n), np.float64)
    hits = np.zeros((n, n), np.float64)
    masks = [tid == t for t in type_ids]
    for p in range(n):
        for q in range(p + 1, n):
            if op_t[p, q] == PRED_NONE:
                continue
            a = attrs[masks[p]][:, a_attr[p, q]]
            b = attrs[masks[q]][:, b_attr[p, q]]
            ok = _pred_ok(np, int(op_t[p, q]), float(theta[p, q]),
                          a[:, None], b[None, :])
            trials[p, q] = trials[q, p] = float(len(a) * len(b))
            hits[p, q] = hits[q, p] = float(np.sum(ok))
    return trials, hits


def sample_selectivities(
    rng: np.random.Generator,
    type_id: np.ndarray,
    attrs: np.ndarray,
    pred_tensors: dict,
    pos_of_type: dict,
    n: int,
    samples_per_pair: int = 64,
) -> tuple[np.ndarray, np.ndarray]:
    """Monte-Carlo selectivity sampling over one chunk (host-side, cheap).

    For every pattern-position pair (p, q) carrying a real predicate, draw up
    to ``samples_per_pair`` random event pairs of the corresponding types from
    the chunk and evaluate the predicate.  Returns (trials, hits) matrices of
    shape (n, n) — symmetric, filled on the upper triangle and mirrored.

    The planner needs selectivities for *all* predicate pairs, including ones
    the currently deployed plan never joins, so passive estimates from the
    live join matrices are not enough (paper §2.2 keeps estimation
    plan-independent for the same reason).
    """
    from .patterns import PRED_NONE

    op = pred_tensors["op"]
    a_attr = pred_tensors["a_attr"]
    b_attr = pred_tensors["b_attr"]
    theta = pred_tensors["theta"]
    trials = np.zeros((n, n), np.float64)
    hits = np.zeros((n, n), np.float64)

    idx_by_pos = {}
    for t, p in pos_of_type.items():
        idx_by_pos[p] = np.nonzero(type_id == t)[0]

    for p in range(n):
        for q in range(p + 1, n):
            if op[p, q] == PRED_NONE:
                continue
            ip, iq = idx_by_pos.get(p), idx_by_pos.get(q)
            if ip is None or iq is None or len(ip) == 0 or len(iq) == 0:
                continue
            m = samples_per_pair
            sa = attrs[rng.choice(ip, m), a_attr[p, q]]
            sb = attrs[rng.choice(iq, m), b_attr[p, q]]
            # Same dispatch as the device/exhaustive paths (_pred_ok), so
            # host Monte-Carlo and device statistics can never diverge in
            # predicate convention.
            ok = _pred_ok(np, int(op[p, q]), float(theta[p, q]), sa, sb)
            trials[p, q] = trials[q, p] = m
            hits[p, q] = hits[q, p] = float(ok.sum())
    return trials, hits
