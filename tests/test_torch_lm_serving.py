"""The port's LM serving path against the JAX package's, on the CPU.

``repro_torch.serving.ServingEngine`` against ``repro.serving``'s (the
same reference weights loaded into each): the tokens of two slots' prefills
and their decode steps, a reset slot refilled, equal token for token for
olmo, deepseek-moe, mamba2 and zamba2 (``SMOKE``); the SSM engine's exact
bucket rule; slots independent of each other.  ``Scheduler`` over a
7-request stream: the completed order, every request's tokens and the
planner's counters equal JAX's.  ``AdaptiveBatchPlanner`` and
``greedy_batch_plan``: the plans, conditions, replans and deployments of
a drifting class-rate sequence are equal.  ``launch.serve.main`` with
``--smoke --device cpu`` serves the reference launcher's counts (its random
weights differ: each package draws its own).  Without a GPU the default
device raises.
"""

import jax
import numpy as np
import pytest
import torch

from repro.adaptive.batching import AdaptiveBatchPlanner as JPlanner
from repro.adaptive.batching import greedy_batch_plan as j_greedy_batch_plan
from repro.configs import get_smoke as jget_smoke
from repro.launch import serve as jserve
from repro.models.model import Model as JModel
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.adaptive.batching import (AdaptiveBatchPlanner,
                                           greedy_batch_plan)
from repro_torch.configs import get_smoke
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.serving import Request, Scheduler, ServingEngine

from test_torch_models import _one_torch_thread  # noqa: F401

CACHE_LEN = 64


def engines(arch, slots=2, seed=0):
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    params = JModel(jcfg, remat="none").init(jax.random.PRNGKey(seed))
    return (JEngine(jcfg, params, batch_slots=slots, cache_len=CACHE_LEN),
            ServingEngine(cfg, params, batch_slots=slots,
                          cache_len=CACHE_LEN, device="cpu"))


def drive(eng, prompts, refill, rounds=4):
    """Prefill ``prompts`` into slots 0.., decode ``rounds`` steps, reset
    slot 0 and prefill ``refill`` there, decode ``rounds`` more; returns
    every token produced."""
    toks = [eng.prefill_one(p, i) for i, p in enumerate(prompts)]
    out = [list(toks)]
    for r in range(2 * rounds):
        if r == rounds:
            eng.reset_slot(0)
            toks[0] = eng.prefill_one(refill, 0)
            out.append([toks[0]])
        toks = [int(t) for t in eng.decode(np.asarray(toks, np.int32))]
        out.append(toks)
    return out


@pytest.mark.parametrize("arch", ("olmo-1b", "deepseek-moe-16b",
                                  "mamba2-1.3b", "zamba2-1.2b"))
def test_engine_tokens_match_jax(arch):
    jeng, eng = engines(arch)
    rng = np.random.default_rng(11)
    exact = eng.cfg.family in ("ssm", "hybrid")
    lens = (16, 32, 16) if exact else (11, 16, 21)
    p0, p1, refill = (rng.integers(0, eng.cfg.vocab, n).astype(np.int32)
                      for n in lens)
    assert drive(eng, [p0, p1], refill) == drive(jeng, [p0, p1], refill)
    if exact:
        with pytest.raises(ValueError):
            eng.prefill_one(p0[:11], 1)
        with pytest.raises(ValueError):
            jeng.prefill_one(p0[:11], 1)


def test_engine_slots_independent():
    _, eng = engines("olmo-1b", slots=2)
    _, ref = engines("olmo-1b", slots=1)
    rng = np.random.default_rng(12)
    p1, p2 = (rng.integers(0, eng.cfg.vocab, 16).astype(np.int32)
              for _ in range(2))
    t1 = eng.prefill_one(p1, 0)
    t2 = eng.prefill_one(p2, 1)
    assert ref.prefill_one(p1, 0) == t1
    for _ in range(3):
        nxt = eng.decode(np.array([t1, t2], np.int32))
        ref_nxt = ref.decode(np.array([t1], np.int32))
        assert nxt[0] == ref_nxt[0]
        torch.testing.assert_close(eng.last_logits[0], ref.last_logits[0],
                                   rtol=0, atol=1e-5)
        t1, t2 = int(nxt[0]), int(nxt[1])


def run_scheduler(eng, request_cls, sched_cls, n=7, seed=13):
    sched = sched_cls(eng, class_tokens=[16, 32])
    rng = np.random.default_rng(seed)
    for rid in range(n):
        plen = int(rng.choice([12, 16, 30]))
        sched.submit(request_cls(
            rid=rid, prompt=rng.integers(0, eng.cfg.vocab, plen)
            .astype(np.int32), max_new=4))
    ticks = 0
    while sched.pending or any(s is not None for s in sched.slots):
        sched.tick()
        ticks += 1
        assert ticks < 500
    return ([(r.rid, r.out) for r in sched.completed], ticks,
            sched.planner.replans, sched.planner.deployments,
            sched.planner.plan)


def test_scheduler_stream_matches_jax():
    jeng, eng = engines("olmo-1b", slots=3)
    got = run_scheduler(eng, Request, Scheduler)
    want = run_scheduler(jeng, JRequest, JScheduler)
    assert got[:4] == want[:4]
    assert (got[4].order, got[4].quotas) == (want[4].order, want[4].quotas)
    assert len(got[0]) == 7 and all(len(o) >= 4 for _, o in got[0])


def test_batch_planner_matches_jax():
    rng = np.random.default_rng(14)
    classes = [16, 32, 64]
    counts = np.concatenate([
        rng.poisson([6.0, 2.0, 0.5], (15, 3)),
        rng.poisson([0.5, 1.0, 7.0], (15, 3)),
        rng.poisson([3.0, 3.0, 3.0], (10, 3))]).astype(np.float64)
    p = AdaptiveBatchPlanner(classes, token_budget=256, d=0.1, ema=0.6)
    jp = JPlanner(classes, token_budget=256, d=0.1, ema=0.6)
    for c in counts:
        got, want = p.observe(c), jp.observe(c)
        assert (got is None) == (want is None)
        assert (p.plan.order, p.plan.quotas) == (jp.plan.order,
                                                 jp.plan.quotas)
        assert (p.replans, p.deployments) == (jp.replans, jp.deployments)
    assert p.deployments > 1
    rates = np.array([10.0, 1.0, 5.0])
    plan, dcs = greedy_batch_plan(rates, classes, 1024)
    jplan, jdcs = j_greedy_batch_plan(rates, classes, 1024)
    assert (plan.order, plan.quotas) == (jplan.order, jplan.quotas)
    assert repr(dcs) == repr(jdcs)


def test_serve_main_matches_jax_counts(capsys):
    sched = serve.main(["--smoke", "--device", "cpu"])
    jsched = jserve.main(["--smoke"])
    got = capsys.readouterr().out.splitlines()
    assert [line.split(" in ")[0] for line in got] == \
        ["served 16 requests, 256 tokens"] * 2
    assert len(sched.completed) == len(jsched.completed) == 16
    assert sorted(len(r.out) for r in sched.completed) == \
        sorted(len(r.out) for r in jsched.completed)
    assert (sched.planner.replans, sched.planner.deployments) == \
        (jsched.planner.replans, jsched.planner.deployments)
    assert [r.rid for r in sched.completed] == \
        [r.rid for r in jsched.completed]


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke("olmo-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    model = Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, model, batch_slots=1, cache_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])
