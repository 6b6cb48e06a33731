"""The port's MoE, SSM and hybrid archs against the JAX package's, on
the CPU (the attention families are in ``test_torch_models.py``, whose
baseline and tolerance this file shares).

Per arch (deepseek-moe, dbrx, mamba2, zamba2 at their ``SMOKE`` configs,
JAX weights carried across): the forward's logits, ``loss``, ``aux_loss``
and ``expert_load``; ``prefill`` and three ``decode_step``s with every
cache field; ``prefill`` with ``true_lens`` (the MoE archs match JAX, the
SSM and hybrid archs raise ``ValueError`` on both sides).  Layer cases:
``moe_ffn`` with an ``expert_perm`` and with a ``capacity_factor`` small
enough to drop assignments, whose kept and dropped sets must be JAX's
exactly (the dispatch sorts stably); ``ssd_chunked`` at three chunk
lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models.moe import _local_dispatch as j_dispatch
from repro.models.moe import _moe_ffn_dense as j_moe_ffn
from repro.models.moe import capacity as jcapacity
from repro.models.moe import moe_defs as jmoe_defs
from repro.models.params import init_params as jinit_params
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.configs import get_smoke
from repro_torch.models.moe import capacity, dispatch, moe_ffn
from repro_torch.models.ssm import ssd_chunked

from test_torch_models import (check_forward, check_padded_prefill,
                               check_prefill_and_decode, close, equal)
from test_torch_models import archs  # noqa: F401  (module fixture)
from test_torch_models import _one_torch_thread  # noqa: F401

ARCHS = ("deepseek-moe-16b", "dbrx-132b", "mamba2-1.3b", "zamba2-1.2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, archs):  # noqa: F811
    check_forward(archs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, archs):  # noqa: F811
    check_prefill_and_decode(archs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_matches_jax(arch, archs):  # noqa: F811
    check_padded_prefill(archs(arch))


def moe_setup(capacity_factor=1.25):
    cfg = get_smoke("deepseek-moe-16b").with_(capacity_factor=capacity_factor)
    jcfg = jget_smoke("deepseek-moe-16b").with_(
        capacity_factor=capacity_factor)
    jp = jinit_params(jmoe_defs(jcfg), jax.random.PRNGKey(0), jnp.float32)
    p = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), jp)
    x = np.random.default_rng(5).normal(size=(4, 8, cfg.d_model)).astype(
        np.float32)
    return cfg, jcfg, p, jp, x


@pytest.mark.parametrize("case", ("plain", "expert_perm", "drop"))
def test_moe_ffn_matches_jax(case):
    cfg, jcfg, p, jp, x = moe_setup(0.25 if case == "drop" else 1.25)
    perm = None
    if case == "expert_perm":
        perm = np.random.default_rng(6).permutation(cfg.n_experts).astype(
            np.int32)
    out, aux, load = moe_ffn(torch.from_numpy(x), p, cfg,
                             None if perm is None else torch.from_numpy(perm))
    jout, jaux, jload = j_moe_ffn(jnp.asarray(x), jp, jcfg,
                                  None if perm is None else jnp.asarray(perm))
    close(out, jout, "out")
    close(aux, jaux, "aux")
    equal(load, jload, "expert_load")


def test_moe_dispatch_keeps_and_drops_what_jax_does():
    """With capacity below the load, both dispatches keep and drop the same
    (expert, token) assignments and fill the same buffer rows."""
    cfg, jcfg, p, jp, x = moe_setup(0.25)
    E, K = cfg.n_experts, cfg.top_k
    T = x.shape[0] * x.shape[1]
    C = capacity(cfg, T)
    assert C == jcapacity(jcfg, T)
    xt = x.reshape(T, -1)
    logits = xt @ np.asarray(jp["router"])
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    top_w, top_e = jax.lax.top_k(probs, K)
    jbuf, (jse, jst, jsw, jkeep, jdest) = j_dispatch(
        jnp.asarray(xt), probs, top_w, top_e, E, K, C, jnp.float32)
    buf, (se, st, sw, keep, dest) = dispatch(
        torch.from_numpy(xt), torch.from_numpy(np.array(top_w)),
        torch.from_numpy(np.array(top_e)).long(), E, K, C)
    assert not bool(np.asarray(jkeep).all()), "the case must drop"
    for got, want, what in ((se, jse, "experts"), (st, jst, "tokens"),
                            (keep, jkeep, "kept"), (dest, jdest, "rows"),
                            (sw, jsw, "weights")):
        equal(got, want, what)
    equal(buf, jbuf, "buffers")


@pytest.mark.parametrize("chunk", (4, 8, 16))
def test_ssd_chunked_matches_jax(chunk):
    rng = np.random.default_rng(7)
    b, s, h, p, n = 2, 16, 3, 4, 5
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    A = (-rng.uniform(0.1, 1.0, (h,))).astype(np.float32)
    Bm = rng.normal(size=(b, s, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, n)).astype(np.float32)
    y, hf = ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                        chunk)
    jy, jhf = j_ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                            chunk)
    close(y, jy, "y", tol=1e-5)
    close(hf, jhf, "final state", tol=1e-5)
    with pytest.raises(AssertionError):
        ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), 5)


@pytest.mark.parametrize("arch", ("deepseek-moe-16b", "dbrx-132b"))
def test_moe_runs_on_meta(arch):
    """The MoE ``SMOKE`` configs' loss, backward and ``decode_step`` run on
    ``meta`` tensors (the dry-run's placeholder device): the routing
    counts have a fixed length, where ``bincount``'s depends on the
    data and has no ``meta`` kernel."""
    from repro_torch.models.model import Model

    cfg = get_smoke(arch)
    model = Model(cfg, device="meta")
    tok = torch.empty((4, 16), dtype=torch.int32, device="meta")
    loss, metrics = model.loss({"tokens": tok, "labels": tok})
    loss.backward()
    assert metrics["expert_load"].shape == (cfg.n_layers, cfg.n_experts)
    assert all(p.grad is not None and p.grad.device.type == "meta"
               for n, p in model.named_parameters() if "router" in n)
    logits, cache = model.decode_step(model.init_cache(4, 16), tok[:, :1])
    assert logits.shape == (4, 1, cfg.vocab)
    assert cache.index.device.type == "meta"


@pytest.mark.parametrize("seed", range(4))
def test_routing_stats_equal_bincount_bit_for_bit(seed):
    """``routing_stats``' fixed-length count gives the ``frac`` and ``aux``
    that ``bincount`` gave, bit for bit, on random routings (experts
    left unrouted included)."""
    from repro_torch.models.moe import _chain_table, routing_stats

    rng = np.random.default_rng(seed)
    t, e, k = 64 + 7 * seed, 8 + seed, 2 + seed % 3
    probs = torch.from_numpy(rng.dirichlet(np.ones(e), t).astype(np.float32))
    top_e = torch.from_numpy(rng.integers(0, e - 1, (t, k)))
    aux, frac = routing_stats(probs, top_e, e, k)
    want = _chain_table(t * k, probs.device)[
        torch.bincount(top_e.reshape(-1), minlength=e)]
    assert torch.equal(frac, want)
    assert torch.equal(aux, e * torch.sum(want * probs.mean(dim=0)))
