"""Shared harness of the PyTorch/CUDA port's benchmarks: the paper's five
pattern sets, both data regimes, all four decision policies, wall-clock
throughput measurement.

The twin of ``benchmarks/common.py`` over ``repro_torch``: the same
pattern sets, stream configuration, engine capacities (``b_cap=128``,
``m_cap=512``, adaptive match capacities in pow2 buckets within
``(256, 8192)``) and composite branches (seed ``seed + branch``, merged
with ``merge_metrics``).  Wall time ends in a device sync, so nothing is
left in flight at the timer stop.  ``device`` is "cuda" (the default;
without a GPU the port raises) or "cpu".

Every twin writes a ``device`` block (``device_block``) into its JSON:
torch's device and, on a GPU, the card's name and power limit from
``nvidia-smi``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import time
from typing import Optional

import torch

from repro_torch.core import AdaptiveRunner, EngineConfig, make_policy
from repro_torch.core.adaptation import merge_metrics
from repro_torch.core.engine import resolve_device
from repro_torch.core.patterns import (PRED_LT, CompositePattern, Predicate,
                                       and_pattern, chain_predicates,
                                       kleene_pattern, neg_pattern,
                                       seq_pattern)
from repro_torch.data.cep_streams import StreamConfig, make_stream

PATTERN_SETS = ["seq", "conj", "neg", "kleene", "composite"]

# run_one's engine: the reference's capacities and adaptive-cap bounds.
B_CAP, M_CAP = 128, 512
CAP_BOUNDS = (256, 8192)
CHUNK_CAP = 512


def build_pattern(set_name: str, size: int, window: float = 4.0,
                  theta: float = -0.3):
    """The paper's five pattern sets (§5.1), parametrized by size."""
    ids = list(range(size))
    preds = chain_predicates(ids, theta=theta)
    if set_name == "seq":
        return seq_pattern(ids, window, preds)
    if set_name == "conj":
        return and_pattern(ids, window, preds)
    if set_name == "neg":
        # negated event = extra type `size`, absence between pos 0 and 1.
        return neg_pattern(
            ids, window, negated_type=size, negated_pos=1,
            predicates=preds,
            negated_predicates=(Predicate(size, 0, PRED_LT, 0, 0, 0.0),))
    if set_name == "kleene":
        return kleene_pattern(ids, window, kleene_pos=size // 2,
                              predicates=preds)
    if set_name == "composite":
        # disjunction of three independent sequences of `size` events
        return CompositePattern(tuple(
            seq_pattern(list(range(b * size, (b + 1) * size)), window,
                        chain_predicates(
                            list(range(b * size, (b + 1) * size)),
                            theta=theta))
            for b in range(3)))
    raise ValueError(set_name)


def stream_types_needed(set_name: str, size: int) -> int:
    if set_name == "neg":
        return size + 1
    if set_name == "composite":
        return 3 * size
    return size


POLICIES = {
    "static": dict(),
    "unconditional": dict(),
    "threshold": dict(t=0.4),
    "invariant": dict(k=1, d=0.0),
}


@dataclasses.dataclass
class BenchResult:
    dataset: str
    algo: str
    pattern_set: str
    size: int
    policy: str
    d: float
    throughput: float          # events / s (wall)
    events: int
    matches: int
    pm_created: int
    replans: int
    deployments: int
    false_positives: int
    overhead: float            # (D+A time) / total
    wall_s: float

    def row(self) -> str:
        return (f"{self.dataset},{self.algo},{self.pattern_set},"
                f"{self.size},{self.policy},{self.d:g},"
                f"{self.throughput:.0f},{self.events},{self.matches},"
                f"{self.pm_created},{self.replans},{self.deployments},"
                f"{self.false_positives},{self.overhead:.4f},"
                f"{self.wall_s:.2f}")


HEADER = ("dataset,algo,set,size,policy,d,throughput_ev_s,events,matches,"
          "pm,replans,deploys,fp,overhead,wall_s")

# BenchResult fields that do not depend on the clock.
COUNT_FIELDS = ("events", "matches", "pm_created", "replans", "deployments",
                "false_positives")


def sync(device) -> None:
    """Wait for the queued work of every device of ``device``'s type (a
    meshed run's blocks may lie on several; a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def check_device(device: str) -> str:
    """``device`` if the port can run there; "cuda" without a GPU raises,
    as the package's entry points do."""
    resolve_device(device)
    return device


def device_block(device: str) -> dict:
    """The JSON ``device`` block: torch's device, and on a GPU the card's
    name and power limit as ``nvidia-smi`` gives them; "cpu" otherwise."""
    dev = torch.device(check_device(device))
    if dev.type != "cuda":
        return {"torch": "cpu", "name": "cpu", "power.limit": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {"torch": f"cuda:{torch.cuda.current_device()}",
            "kind": torch.cuda.get_device_name(0), "name": name,
            "power.limit": limit}


def seconds_gate(seconds: float, base_s: float, threshold: float,
                 slack_s: float, bound: str) -> dict:
    """A throughput gate between two timed sweeps, as the reference
    harnesses state it: ``bound`` "max" caps the overhead ``seconds /
    base_s - 1`` at ``threshold``, "min" holds the speedup ``base_s /
    seconds`` at ``threshold`` or more; either way with ``slack_s``
    seconds of absolute slack.  The record keeps both sweeps and the
    slack, so ``met`` follows from it alone."""
    if bound == "max":
        value, limit_s = seconds / base_s - 1.0, base_s * (1.0 + threshold)
    else:
        value, limit_s = base_s / seconds, base_s / threshold
    return {"value": round(value, 4), "threshold": threshold,
            "bound": bound, "seconds": seconds, "base_s": base_s,
            "slack_s": slack_s,
            "met": bool(seconds <= limit_s + slack_s)}


def write_json(path: str, payload) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")


def stream_config(set_name: str, size: int, n_chunks: int,
                  base_rate: float = 15.0, seed: int = 3) -> StreamConfig:
    return StreamConfig(
        n_types=stream_types_needed(set_name, size), n_attrs=1,
        n_chunks=n_chunks, chunk_cap=CHUNK_CAP, base_rate=base_rate,
        seed=seed,
        # ~4 regime shifts per traffic run regardless of run length
        shift_every=max(n_chunks / 4.0, 10.0))


def branch_streams(dataset: str, set_name: str, size: int, n_chunks: int,
                   base_rate: float = 15.0, seed: int = 3,
                   take: Optional[int] = None):
    """The stream of each branch of one run (seed ``seed + branch``; one
    branch unless the set is composite), cut to its first ``take`` chunks
    if given (the same stream: the regime shifts follow ``n_chunks``)."""
    scfg = stream_config(set_name, size, n_chunks, base_rate, seed)
    n_branches = 3 if set_name == "composite" else 1
    return [itertools.islice(make_stream(
        dataset, dataclasses.replace(scfg, seed=seed + b)), take)
        for b in range(n_branches)]


def run_metrics(dataset: str, algo: str, set_name: str, size: int,
                policy: str, d: Optional[float] = None, n_chunks: int = 120,
                base_rate: float = 15.0, seed: int = 3,
                policy_kw: Optional[dict] = None, device: str = "cuda",
                backend: Optional[str] = None, take: Optional[int] = None):
    """One run of the loop: an ``AdaptiveRunner`` per branch
    (``merge_metrics`` over a composite's three).  Returns the merged
    ``RunMetrics``, the wall seconds (ending in a device sync), the match
    capacities the runs built engines for, and the policy keywords.
    ``backend="ref"`` runs the plain kernel versions; ``take`` cuts the
    streams to their first chunks."""
    check_device(device)
    pat = build_pattern(set_name, size)
    kw = dict(POLICIES[policy])
    if policy_kw:
        kw.update(policy_kw)
    if d is not None and policy == "invariant":
        kw["d"] = d
    branches = (pat.branches if isinstance(pat, CompositePattern)
                else (pat,))
    ecfg = EngineConfig(b_cap=B_CAP, m_cap=M_CAP, device=device,
                        backend=backend)
    streams = branch_streams(dataset, set_name, size, n_chunks, base_rate,
                             seed, take)
    ms, caps = [], set()
    sync(device)
    t0 = time.perf_counter()
    for branch, stream in zip(branches, streams):
        runner = AdaptiveRunner(
            branch, planner=algo, policy=make_policy(policy, **kw),
            engine_cfg=ecfg, adaptive_caps=True, cap_bounds=CAP_BOUNDS)
        ms.append(runner.run(stream))
        caps |= set(runner._engines)
    sync(device)
    wall = time.perf_counter() - t0
    return merge_metrics(ms), wall, sorted(caps), kw


def warm_up(device: str) -> None:
    """One short untimed run per planner, so that the first timed run of
    a sweep does not pay the device's start-up and the kernels' build."""
    for algo in ("greedy", "zstream"):
        run_metrics("traffic", algo, "seq", 3, "static", n_chunks=4,
                    device=device)


def run_one(dataset: str, algo: str, set_name: str, size: int,
            policy: str, d: Optional[float] = None, n_chunks: int = 120,
            base_rate: float = 15.0, seed: int = 3,
            policy_kw: Optional[dict] = None,
            device: str = "cuda") -> BenchResult:
    metrics, wall, _, kw = run_metrics(
        dataset, algo, set_name, size, policy, d, n_chunks, base_rate, seed,
        policy_kw, device)
    return BenchResult(
        dataset=dataset, algo=algo, pattern_set=set_name, size=size,
        policy=policy, d=kw.get("d", 0.0),
        throughput=metrics.events / max(wall, 1e-9),
        events=metrics.events, matches=metrics.full_matches,
        pm_created=metrics.pm_created, replans=metrics.replans,
        deployments=metrics.deployments,
        false_positives=metrics.false_positives,
        overhead=metrics.adaptation_overhead, wall_s=wall)
