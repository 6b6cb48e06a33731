"""Invariant-governed adaptive MoE expert placement.

Problem (the paper's shape, §4.3 "any greedy algorithm"):

* **statistics** — measured per-expert token loads (EMA over train steps);
  these play the role of the paper's event arrival rates.
* **plan** — an assignment of the ``E`` logical experts to the ``G``
  expert-parallel device groups (the ``model`` mesh axis).  A skewed
  assignment makes the hottest group the straggler of every MoE layer.
* **generator ``A``** — deterministic LPT (longest-processing-time) greedy:
  experts in decreasing load order, each to the currently lightest group.
  Every "group g is lighter than group g'" comparison that the winning
  group survives is a block-building comparison; its deciding condition
  ``sum(loads of g) < sum(loads of g')`` joins the step's DCS.  Sums of
  loads are exactly the ``ExprSum`` sides of ``core.invariants`` (each
  expert load is one product term ``rate[e]``), so the paper's machinery
  applies unchanged.
* **deployment cost** — relabeling experts means permuting the expert-
  indexed weight rows across devices (an all-to-all of expert weights) and
  re-entering the jitted step; this is why unconditional re-placement every
  step is exactly the over-adaptation failure mode of [36].

The governor verifies the invariant list every ``check_every`` steps and
triggers a re-placement only on violation (distance-``d`` damped).
Theorem 1 transfers: a violation guarantees LPT produces a *different*
assignment.

The port of ``repro.adaptive.placement``: the governor is the reference's
numpy host code over the port's ``core`` decision machinery;
``permute_expert_params`` moves tensors, in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.decision import InvariantPolicy
from ..core.invariants import DCSList, DecidingCondition
from ..core.plans import Expr
from ..core.stats import Stat


@dataclasses.dataclass(frozen=True)
class Placement:
    """perm[logical_expert] = physical slot; group = slot // (E // G)."""

    perm: Tuple[int, ...]
    groups: Tuple[Tuple[int, ...], ...]   # group -> logical expert ids

    @property
    def n_experts(self) -> int:
        return len(self.perm)


def _load_stat(loads: np.ndarray) -> Stat:
    """Wrap per-expert loads as the paper's Stat (rates only)."""
    e = loads.shape[0]
    return Stat(rates=np.asarray(loads, np.float64),
                sel=np.ones((e, e), np.float64))


def lpt_placement(loads: np.ndarray, n_groups: int
                  ) -> Tuple[Placement, DCSList]:
    """Deterministic LPT with BBC capture.

    Ties break toward the lower expert id / lower group id, keeping the
    generator a deterministic function of the statistics (Theorem 1's
    requirement).
    """
    e = loads.shape[0]
    assert e % n_groups == 0, (e, n_groups)
    cap = e // n_groups
    order = sorted(range(e), key=lambda i: (-float(loads[i]), i))
    group_members: List[List[int]] = [[] for _ in range(n_groups)]
    group_load = np.zeros(n_groups)
    dcs_list: DCSList = []

    # The descending sort is itself a sequence of block-building
    # comparisons (the paper's min-sort example, §3.1): the expert at rank
    # r beat every not-yet-ranked expert.  Omitting these conditions makes
    # order flips invisible — a false-negative class caught by
    # tests/test_adaptive.py::test_governor_reacts_to_shift.
    for r, ex in enumerate(order):
        block = f"rank{r}:e{ex}"
        conds = [
            DecidingCondition.make(
                (Expr(rate_idx=(j,)),), (Expr(rate_idx=(ex,)),), block)
            for j in order[r + 1:]
        ]
        dcs_list.append((block, conds))

    for step, ex in enumerate(order):
        open_groups = [g for g in range(n_groups)
                       if len(group_members[g]) < cap]
        win = min(open_groups,
                  key=lambda g: (float(group_load[g]), g))
        block = f"assign{step}:e{ex}->g{win}"
        win_sum = tuple(Expr(rate_idx=(i,)) for i in group_members[win]) \
            or (Expr(scale=0.0),)
        conds = []
        for g in open_groups:
            if g == win:
                continue
            other = tuple(Expr(rate_idx=(i,)) for i in group_members[g]) \
                or (Expr(scale=0.0),)
            conds.append(DecidingCondition.make(win_sum, other, block))
        dcs_list.append((block, conds))
        group_members[win].append(ex)
        group_load[win] += float(loads[ex])

    perm = [0] * e
    for g, members in enumerate(group_members):
        for slot, ex in enumerate(members):
            perm[ex] = g * cap + slot
    return Placement(tuple(perm),
                     tuple(tuple(m) for m in group_members)), dcs_list


def imbalance(loads: np.ndarray, placement: Placement) -> float:
    """max group load / mean group load (1.0 = perfect balance)."""
    gl = np.array([sum(loads[list(g)]) for g in placement.groups])
    mean = gl.mean()
    return float(gl.max() / mean) if mean > 0 else 1.0


class ExpertPlacementGovernor:
    """Detection-adaptation loop for expert placement (Algorithm 1 shape)."""

    def __init__(self, n_experts: int, n_groups: int, *, k: int = 1,
                 d: float = 0.1, ema: float = 0.9,
                 check_every: int = 1):
        self.n_experts = n_experts
        self.n_groups = n_groups
        self.ema = ema
        self.check_every = check_every
        self.policy = InvariantPolicy(k=k, d=d)
        self._loads: Optional[np.ndarray] = None
        self.placement: Optional[Placement] = None
        self._step = 0
        self.replans = 0
        self.deployments = 0
        self.false_positives = 0

    def _replan(self) -> Optional[Placement]:
        new_p, dcs = lpt_placement(self._loads, self.n_groups)
        self.policy.on_replan(new_p, dcs, _load_stat(self._loads))
        if self.placement is None or new_p.groups != self.placement.groups:
            self.placement = new_p
            self.deployments += 1
            return new_p
        self.false_positives += 1
        return None

    def observe(self, expert_load: np.ndarray) -> Optional[Placement]:
        """Feed one step's per-expert token counts (summed over layers).

        Returns a new Placement when (and only when) the invariant check
        demanded a re-plan that produced a different assignment.
        """
        expert_load = np.asarray(expert_load, np.float64)
        if self._loads is None:
            self._loads = expert_load + 1e-6
            self.replans += 1
            return self._replan()
        self._loads = self.ema * self._loads + (1 - self.ema) * expert_load
        self._step += 1
        if self._step % self.check_every:
            return None
        if self.policy.decide(_load_stat(self._loads)):
            self.replans += 1
            return self._replan()
        return None


@torch.no_grad()
def permute_expert_params(moe_params, perm):
    """Physically relocate expert weights to their new slots, in place.

    ``perm[old_slot] = new_slot``; the expert-major leaves (w_gate/w_up/
    w_down, expert axis -3) move so new slot ``perm[e]`` holds the expert
    previously at slot ``e``, and the router's output columns (axis -1)
    move with them (routing then addresses physical slots directly — no
    per-token indirection).  ``moe_params`` is one MoE layer's
    ``ParamTree`` or a dict of tensors (parameters, or an optimizer's
    moments of them); each tensor is overwritten, so a parameter keeps its
    identity.  Returns ``moe_params``.
    """
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    for k, axis in (("w_gate", -3), ("w_up", -3), ("w_down", -3),
                    ("router", -1)):
        t = moe_params[k]
        t.copy_(t.index_select(axis, torch.as_tensor(inv, device=t.device)))
    return moe_params


def relocation(cur_perm, new_perm) -> np.ndarray:
    """old physical slot -> new physical slot for a placement change."""
    cur = np.asarray(cur_perm)
    new = np.asarray(new_perm)
    inv_cur = np.empty_like(cur)
    inv_cur[cur] = np.arange(len(cur))
    return new[inv_cur]
