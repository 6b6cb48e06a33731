"""The port's expert-placement governor (``repro_torch.adaptive.placement``)
against the JAX package's, on the CPU.

The six placement cases of ``tests/test_adaptive.py`` run on the port
and on JAX with the same numpy-seeded loads: LPT permutations, groups
and DCS block counts, governor replans, deployments and false positives
are equal; relocated weights equal JAX's ``permute_expert_params``
exactly; the MoE layer's output under a placement within 1e-4 as the
reference test holds it (the weights: JAX's, carried in).  Then
``launch.train`` with ``--adaptive-placement`` on the deepseek-moe
smoke config prints the same deployments as the JAX launcher, from the
same weights (JAX's init carried into the port's ``Model``).
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adaptive import placement as jpl
from repro.configs import get_smoke as jget_smoke
from repro.models.model import Model as JModel
from repro.models.moe import moe_defs as jmoe_defs
from repro.models.params import init_params as jinit_params
from repro_torch.adaptive import ExpertPlacementGovernor
from repro_torch.adaptive.placement import (_load_stat, imbalance,
                                            lpt_placement,
                                            permute_expert_params,
                                            relocation)
from repro_torch.configs import get_smoke
from repro_torch.core.invariants import InvariantSet, select_invariants
from repro_torch.launch import train
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import load_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def same_placement(got, want):
    assert got.perm == want.perm and got.groups == want.groups


def block_sizes(dcs):
    return [(block, len(conds)) for block, conds in dcs]


def test_lpt_balances(rng):
    loads = rng.uniform(1, 10, 16)
    placement, dcs = lpt_placement(loads, 4)
    assert sorted(placement.perm) == list(range(16))
    assert imbalance(loads, placement) < 1.35
    # block-building structure: E rank blocks (sort) + E assignment blocks
    assert len(dcs) == 32
    want, jdcs = jpl.lpt_placement(loads, 4)
    same_placement(placement, want)
    assert block_sizes(dcs) == block_sizes(jdcs)
    assert imbalance(loads, placement) == jpl.imbalance(loads, want)


def test_lpt_theorem1_style(rng):
    """No-FP property for the placement generator: whenever the invariant
    set fires, a fresh LPT run must produce a DIFFERENT assignment; every
    check and plan equals JAX's."""
    from repro.core.invariants import InvariantSet as JInvariantSet
    from repro.core.invariants import select_invariants as jselect

    loads = rng.uniform(1, 10, 16)
    p0, dcs = lpt_placement(loads, 4)
    jp0, jdcs = jpl.lpt_placement(loads, 4)
    iset = InvariantSet(
        select_invariants(dcs, _load_stat(loads), strategy="all"), d=0.0)
    jset = JInvariantSet(
        jselect(jdcs, jpl._load_stat(loads), strategy="all"), d=0.0)
    fired = changed = fp = 0
    for i in range(200):
        l2 = loads * np.exp(np.random.default_rng(i).normal(0, 0.4, 16))
        f = iset.check(_load_stat(l2))
        assert f == jset.check(jpl._load_stat(l2))
        p1, _ = lpt_placement(l2, 4)
        same_placement(p1, jpl.lpt_placement(l2, 4)[0])
        c = p1.groups != p0.groups
        fired += f
        changed += c
        if f and not c:
            fp += 1
    assert fp == 0, (fired, changed, fp)
    assert fired > 0  # the drift scale actually exercises the invariants


def run_governors(seq, **kw):
    """Feed both governors the same loads; every observation's result and
    the final counters must agree."""
    gov = ExpertPlacementGovernor(16, 4, **kw)
    jgov = jpl.ExpertPlacementGovernor(16, 4, **kw)
    got = []
    for loads in seq:
        p, jp = gov.observe(loads), jgov.observe(loads)
        assert (p is None) == (jp is None)
        if p is not None:
            same_placement(p, jp)
        got.append(p)
    assert (gov.replans, gov.deployments, gov.false_positives) == (
        jgov.replans, jgov.deployments, jgov.false_positives)
    np.testing.assert_array_equal(gov._loads, jgov._loads)
    return gov, got


def test_governor_stable_loads_no_replans(rng):
    loads = rng.uniform(1, 10, 16)
    seq = [loads] + [loads + rng.normal(0, 0.01, 16) for _ in range(30)]
    gov, got = run_governors(seq, d=0.05)
    assert all(p is None for p in got[1:])
    assert gov.replans == 1  # only the initial plan


def test_governor_reacts_to_shift(rng):
    loads = rng.uniform(1, 10, 16)
    shifted = loads.copy()
    shifted[np.argsort(loads)[:4]] += 40.0  # cold experts become hot
    gov, got = run_governors([loads] + [shifted] * 20, d=0.05)
    last = [p for p in got[1:] if p is not None]
    assert last
    assert imbalance(gov._loads, last[-1]) < 1.5


def test_permute_roundtrip(rng):
    E, D, F = 8, 4, 6
    prm = {k: rng.normal(size=s).astype(np.float32)
           for k, s in (("router", (D, E)), ("w_gate", (E, D, F)),
                        ("w_up", (E, D, F)), ("w_down", (E, F, D)))}
    perm = rng.permutation(E)
    tensors = {k: torch.tensor(v) for k, v in prm.items()}
    ids = {k: id(v) for k, v in tensors.items()}
    out = permute_expert_params(tensors, perm)
    assert {k: id(v) for k, v in out.items()} == ids  # in place
    for e in range(E):
        assert np.allclose(out["w_gate"][perm[e]].numpy(), prm["w_gate"][e])
        assert np.allclose(out["router"][:, perm[e]].numpy(),
                           prm["router"][:, e])
    want = jpl.permute_expert_params(
        {k: jnp.asarray(v) for k, v in prm.items()}, perm)
    for k in prm:
        assert np.array_equal(out[k].numpy(), np.asarray(want[k]))
    # relocation composition: applying rel after cur lands on new
    cur = rng.permutation(E)
    new = rng.permutation(E)
    rel = relocation(cur, new)
    assert (rel[cur] == new).all()
    assert np.array_equal(rel, jpl.relocation(cur, new))


def test_moe_output_invariant_under_placement(rng):
    """Relocating experts (weights + router columns) must not change the
    layer's function — only which device computes what."""
    from repro.models.moe import moe_ffn as jmoe_ffn

    cfg = get_smoke("deepseek-moe-16b")
    jcfg = jget_smoke("deepseek-moe-16b")
    jprm = jinit_params(jmoe_defs(jcfg), jax.random.PRNGKey(0), jnp.float32)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)

    def tree(p):
        return {k: tree(v) if isinstance(v, dict)
                else torch.tensor(np.array(v)) for k, v in p.items()}

    prm = tree(jprm)
    y0, _, load0 = moe_ffn(torch.tensor(x), prm, cfg)
    perm = rng.permutation(cfg.n_experts)
    y1, _, load1 = moe_ffn(torch.tensor(x), permute_expert_params(prm, perm),
                           cfg)
    assert float((y0 - y1).abs().max()) < 1e-4
    assert np.allclose(load0.numpy(), load1.numpy()[perm])
    jy, _, _ = jmoe_ffn(jnp.asarray(x),
                        jpl.permute_expert_params(jprm, perm), jcfg)
    assert float(np.abs(y1.numpy() - np.asarray(jy)).max()) < 1e-4


DEPLOYED = re.compile(r"step (\d+): expert re-placement deployed "
                      r"\(replans=(\d+)\)")


def deployments(out):
    return [tuple(map(int, m)) for m in DEPLOYED.findall(out)]


def test_launch_train_replans_match_jax(monkeypatch):
    """``launch.train`` with ``--adaptive-placement`` on the CPU deploys at
    the same steps with the same replan counts as the JAX launcher, from the
    same weights."""
    from repro.launch import train as jtrain

    argv = ["--arch", "deepseek-moe-16b", "--smoke", "--steps", "24",
            "--batch", "4", "--seq", "32", "--adaptive-placement",
            "--log-every", "100"]
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        jtrain.main(argv)
    jparams = JModel(jget_smoke("deepseek-moe-16b"), remat="none").init(
        jax.random.PRNGKey(0))

    class CarriedModel(train.Model):
        def init(self, generator):
            load_params(self, jparams)
            return self

    monkeypatch.setattr(train, "Model", CarriedModel)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, opt_state = train.main(argv + ["--device", "cpu"])
    assert deployments(jout.getvalue())
    assert deployments(out.getvalue()) == deployments(jout.getvalue())
    assert out.getvalue().rstrip().endswith("done")
    assert int(opt_state.step) == 24


def test_relocate_experts_moves_moments_with_weights():
    """``launch.train.relocate_experts`` moves every MoE layer's expert
    weights, router columns, and their m, v and master entries by one
    relocation, in place; the shared experts stay."""
    from repro_torch.train.optimizer import AdamWConfig, init_state

    cfg = get_smoke("deepseek-moe-16b")
    model = train.Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for p in params.values():
            p.copy_(p.to(torch.bfloat16))  # a master copy is allocated
    state = init_state(AdamWConfig(), {n: p.to(torch.bfloat16)
                                       for n, p in params.items()})
    gen = torch.Generator().manual_seed(1)
    for tree in (state.m, state.v, state.master):
        for t in tree.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    before = {(w, n): t.clone() for w, tree in (
        ("p", params), ("m", state.m), ("v", state.v),
        ("master", state.master)) for n, t in tree.items()}
    rel = np.random.default_rng(2).permutation(cfg.n_experts)
    train.relocate_experts(model, state, rel)
    inv = torch.as_tensor(np.argsort(rel))
    for (w, n), old in before.items():
        now = {"p": params, "m": state.m, "v": state.v,
               "master": state.master}[w][n]
        leaf = n.split(".")[-1]
        if ".moe." in n and ".shared." not in n and leaf in train.MOVED:
            axis = -1 if leaf == "router" else -3
            assert torch.equal(now, old.index_select(axis, inv)), (w, n)
        else:
            assert torch.equal(now, old), (w, n)
