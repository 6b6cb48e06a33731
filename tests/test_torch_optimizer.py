"""The port's AdamW (``repro_torch.train.optimizer``) against the JAX
package's, on the CPU.

The five cases of ``tests/test_optimizer.py`` run on the port; then the
schedule and the update are held to JAX's on the same numpy-seeded
parameters and gradients.  Tolerances: ``cosine_lr`` within one f32 ulp
of ``lr_peak`` of JAX's (``torch.cos`` and XLA's cos differ by an ulp at
a few steps, which the cancellation in ``1 + cos`` near the end of the
decay scales up to a few ulps of the smaller lr); parameters and
moments after ``apply_update`` within 1e-6 of JAX's, the pre-clip norm
within 1e-6 relative; a ``None`` gradient gives what JAX gives for a
zero gradient, bit for bit; bf16 masters within 1e-6 and the bf16
parameters rounded from them within one bf16 ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train.optimizer import (AdamWConfig, apply_update,
                                         cosine_lr, global_norm, init_state)

SHAPES = {"a": (5, 7), "b": (13,), "c": (3, 4, 2), "d": (6, 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jcfg(cfg):
    return jopt.AdamWConfig(**dataclasses.asdict(cfg))


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0, clip_norm=100.0)
    target = torch.tensor([3.0, -2.0, 0.5])
    params = {"w": torch.zeros(3, requires_grad=True)}
    state = init_state(cfg, params)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(200):
        params["w"].grad = None
        loss(params).backward()
        params, state, _ = apply_update(
            cfg, params, {"w": params["w"].grad}, state)
    assert float(loss(params).detach()) < 1e-3


def test_clip_norm():
    cfg = AdamWConfig(clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = init_state(cfg, params)
    g = {"w": torch.full((4,), 100.0)}
    _, _, m = apply_update(cfg, params, g, state)
    assert float(m["grad_norm"]) == 200.0  # pre-clip norm reported


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr_peak=1.0, warmup_steps=10, total_steps=100,
                      lr_min_ratio=0.1)
    lrs = [float(cosine_lr(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 1e-6
    assert abs(lrs[100] - 0.1) < 1e-6
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))


def test_bf16_master_params():
    cfg = AdamWConfig(use_master=True)
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    state = init_state(cfg, params)
    assert state.master["w"].dtype == torch.float32
    g = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
    p2, s2, _ = apply_update(cfg, params, g, state)
    assert p2["w"].dtype == torch.bfloat16
    # master accumulates at fp32 precision even for sub-bf16 updates
    assert float(s2.master["w"].abs().max()) > 0


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6


@pytest.mark.parametrize("cfg", [
    AdamWConfig(lr_peak=1.0, warmup_steps=10, total_steps=100,
                lr_min_ratio=0.1),
    AdamWConfig(),
    AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=30),
], ids=["unit", "default", "train-loop"])
def test_cosine_lr_matches_jax(cfg):
    want = np.array([np.float32(jopt.cosine_lr(jcfg(cfg), jnp.asarray(
        s, jnp.int32))) for s in range(101)])
    got = np.array([cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))
                    .item() for s in range(101)], np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=cfg.lr_peak * 2.0 ** -23)


def seeded(seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(dtype)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_apply_update_matches_jax(clip):
    """Five updates on random dict params and growing random gradients:
    parameters, moments, lr and the pre-clip norm equal JAX's."""
    cfg = AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=20,
                      clip_norm=clip)
    p0 = seeded(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init_state(jcfg(cfg), jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = init_state(cfg, tp)
    for i in range(5):
        g = seeded(10 + i, scale=i + 1.0)
        jp, js, jm = jopt.apply_update(
            jcfg(cfg), jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts, tm = apply_update(
            cfg, tp, {k: torch.tensor(v) for k, v in g.items()}, ts)
        assert int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]),
                                   rtol=0, atol=cfg.lr_peak * 2.0 ** -23)
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) \
            < 1e-6
        for k in SHAPES:
            for got, want in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                              (ts.v[k], js.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=0, atol=1e-6)


def test_none_gradient_is_zero():
    """A parameter without a gradient (``None``: the loss does not read
    it) is decayed and its moments updated as JAX does for a zero
    gradient, and it adds nothing to the norm."""
    cfg = AdamWConfig(lr_peak=1e-2, warmup_steps=1, total_steps=10)
    p0, g = seeded(1), seeded(2)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jg["b"] = jnp.zeros(SHAPES["b"], jnp.float32)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jp, js, jm = jopt.apply_update(jcfg(cfg), jp, jg,
                                   jopt.init_state(jcfg(cfg), jp))
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tg = {k: torch.tensor(v) for k, v in g.items()}
    tg["b"] = None
    tp, ts, tm = apply_update(cfg, tp, tg, init_state(cfg, tp))
    assert float(tm["grad_norm"]) == float(global_norm(
        {k: v for k, v in tg.items() if v is not None}))
    assert not np.array_equal(tp["b"].numpy(), p0["b"])  # weight decay
    assert np.array_equal(tp["b"].numpy(), np.asarray(jp["b"]))
    assert np.array_equal(ts.m["b"].numpy(), np.asarray(js.m["b"]))
    assert np.array_equal(ts.v["b"].numpy(), np.asarray(js.v["b"]))


def test_bf16_update_matches_jax():
    """bf16 parameters round from the f32 master as in JAX."""
    cfg = AdamWConfig(lr_peak=1e-2, warmup_steps=1, total_steps=10)
    p0, g = seeded(3), seeded(4)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    js = jopt.init_state(jcfg(cfg), jp)
    tp = {k: torch.tensor(v).to(torch.bfloat16) for k, v in p0.items()}
    ts = init_state(cfg, tp)
    for _ in range(3):
        jp, js, _ = jopt.apply_update(
            jcfg(cfg), jp, {k: jnp.asarray(v, jnp.bfloat16)
                            for k, v in g.items()}, js)
        tp, ts, _ = apply_update(
            cfg, tp, {k: torch.tensor(v).to(torch.bfloat16)
                      for k, v in g.items()}, ts)
    for k in SHAPES:
        np.testing.assert_allclose(ts.master[k].numpy(),
                                   np.asarray(js.master[k]), atol=1e-6)
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32),
                                   rtol=2 ** -7)
