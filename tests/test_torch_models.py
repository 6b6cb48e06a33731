"""The port's LM stack against the JAX package's, on the CPU.

Each test runs a function of ``repro.models`` and its port on the same
numpy-seeded inputs, with the JAX weights carried across
(``repro_torch.models.params.load_params``), at the ``SMOKE`` configs.
This file holds the attention families (dense, vlm, audio) and the
layer-level cases; ``test_torch_models_moe_ssm.py`` holds the MoE, SSM
and hybrid archs.  Per arch: the forward's logits, ``loss`` and
``aux_loss``; ``prefill`` with and without ``true_lens`` (its logits and
every cache field, ``pos`` and ``index`` exactly); three ``decode_step``s
from each side's own prefill.  Layer cases: flash equals direct attention
in the port and against JAX's ``attention`` for four (prefix, window)
pairs; a decode at ``index == cache_len`` (the reference drops the
write); ``param_count`` / ``count_params`` on every ``FULL`` config.

Tolerance: f32 end to end on both sides, so a float compares within
``TOL`` = 1e-4 of the largest magnitude on the reference side (at least
1); integers compare exactly.  One JAX baseline per arch is computed once
per module (``jax.jit``), and torch runs on one thread.  On a GPU the
``gpu``-marked case holds each family on the card to the port's CPU run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models.config import ModelConfig as JModelConfig
from repro.models.layers import attention as jattention
from repro.models.layers import attn_defs as jattn_defs
from repro.models.model import Model as JModel
from repro.models.params import count_params as jcount_params
from repro.models.params import init_params as jinit_params
from repro.models.params import param_bytes as jparam_bytes
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.models import Model
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention
from repro_torch.models.model import cache_to_torch, param_defs
from repro_torch.models.params import count_params, load_params, param_bytes

TOL = 1e-4
B, S = 2, 16
CACHE_LEN = 24
DECODE_STEPS = 3
TRUE_LENS = (11, 16)
ARCHS = ("phi3-mini-3.8b", "olmo-1b", "yi-34b", "stablelm-12b",
         "paligemma-3b", "musicgen-large")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def close(got, want, what, tol=TOL):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    bound = tol * max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def equal(got, want, what):
    got = np.asarray(got.cpu() if torch.is_tensor(got) else got)
    assert np.array_equal(got, np.asarray(want)), what


def same_cache(got, want, what):
    """Every field of a port ``Cache`` against a JAX ``Cache``: floats
    within ``TOL``, positions and the write index exactly."""
    equal(got.index, want.index, f"{what}: index")
    assert (got.kv == ()) == (want.kv == ()), what
    if want.kv != ():
        close(got.kv.k, want.kv.k, f"{what}: kv.k")
        close(got.kv.v, want.kv.v, f"{what}: kv.v")
        equal(got.kv.pos, want.kv.pos, f"{what}: kv.pos")
    assert (got.ssm == ()) == (want.ssm == ()), what
    if want.ssm != ():
        close(got.ssm.conv, want.ssm.conv, f"{what}: ssm.conv")
        close(got.ssm.ssd, want.ssm.ssd, f"{what}: ssm.ssd")


def make_batch(cfg, rng, s=S):
    batch = {}
    if cfg.family == "vlm":
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.frontend_is_embedding:
        batch["embeds"] = rng.normal(size=(B, s, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    return batch


def step_inputs(cfg, rng, n):
    if cfg.frontend_is_embedding:
        return [rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
                for _ in range(n)]
    return [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
            for _ in range(n)]


def jax_tree(x):
    return jax.tree.map(jnp.asarray, x)


class Arch:
    """One arch's JAX baseline (computed once) and its port."""

    def __init__(self, arch):
        seed = list_archs().index(arch)
        rng = np.random.default_rng(seed)
        self.cfg = get_smoke(arch)
        self.jcfg = jget_smoke(arch)
        self.jm = JModel(self.jcfg, remat="none")
        self.params = self.jm.init(jax.random.PRNGKey(seed))
        self.batch = make_batch(self.cfg, rng)
        self.labels = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        self.steps = step_inputs(self.cfg, rng, DECODE_STEPS)
        self.model = Model(self.cfg, device="cpu")
        load_params(self.model, self.params)
        self.attn = self.cfg.family not in ("ssm", "hybrid")
        self._runs = {}

    def jax(self, what):
        if what not in self._runs:
            self._runs[what] = getattr(self, "_jax_" + what)()
        return self._runs[what]

    def _jax_forward(self):
        jb = jax_tree(self.batch)
        logits, metrics = jax.jit(self.jm.forward)(self.params, jb)
        loss, lm = jax.jit(self.jm.loss)(
            self.params, dict(jb, labels=jnp.asarray(self.labels)))
        return logits, metrics, loss, lm

    def _jax_decode(self, true_lens=None, cache_len=CACHE_LEN, steps=None):
        jb = jax_tree(self.batch)
        prefill = jax.jit(functools.partial(self.jm.prefill,
                                            cache_len=cache_len))
        tl = None if true_lens is None else jnp.asarray(true_lens, jnp.int32)
        logits, cache = prefill(self.params, jb, true_lens=tl)
        out = [(logits, cache)]
        decode = jax.jit(self.jm.decode_step)
        for x in (self.steps if steps is None else steps):
            logits, cache = decode(self.params, cache, jnp.asarray(x))
            out.append((logits, cache))
        return out

    def _jax_padded(self):
        return self._jax_decode(true_lens=TRUE_LENS, steps=self.steps[:1])

    def port_decode(self, true_lens=None, cache_len=CACHE_LEN, steps=None):
        logits, cache = self.model.prefill(self.batch, cache_len,
                                           true_lens=true_lens)
        out = [(logits, cache)]
        for x in (self.steps if steps is None else steps):
            logits, cache = self.model.decode_step(cache, x)
            out.append((logits, cache))
        return out


@pytest.fixture(scope="module")
def archs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = Arch(arch)
        return cache[arch]
    return get


def check_forward(a):
    jl, jmet, jloss, jlmet = a.jax("forward")
    logits, metrics = a.model.forward(a.batch)
    close(logits, jl, "logits")
    close(metrics["aux_loss"], jmet["aux_loss"], "aux_loss")
    loss, lmet = a.model.loss(dict(a.batch, labels=a.labels))
    close(loss, jloss, "loss")
    close(lmet["ce"], jlmet["ce"], "ce")
    assert ("expert_load" in metrics) == ("expert_load" in jmet)
    if "expert_load" in jmet:
        close(metrics["expert_load"], jmet["expert_load"], "expert_load")


def check_prefill_and_decode(a):
    want = a.jax("decode")
    got = a.port_decode()
    for i, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        what = "prefill" if i == 0 else f"decode step {i}"
        close(gl, wl, f"{what}: logits")
        same_cache(gc, wc, what)


def check_padded_prefill(a):
    if not a.attn:
        with pytest.raises(ValueError):
            a.jm.prefill(a.params, jax_tree(a.batch), CACHE_LEN,
                         true_lens=jnp.asarray(TRUE_LENS, jnp.int32))
        with pytest.raises(ValueError):
            a.model.prefill(a.batch, CACHE_LEN,
                            true_lens=np.asarray(TRUE_LENS, np.int32))
        return
    want = a.jax("padded")
    got = a.port_decode(true_lens=np.asarray(TRUE_LENS, np.int32),
                        steps=a.steps[:1])
    for i, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        what = "padded prefill" if i == 0 else "decode after it"
        close(gl, wl, f"{what}: logits")
        same_cache(gc, wc, what)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, archs):
    check_forward(archs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, archs):
    check_prefill_and_decode(archs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_matches_jax(arch, archs):
    check_padded_prefill(archs(arch))


@pytest.mark.parametrize("arch", ("olmo-1b", "paligemma-3b"))
def test_decode_past_the_cache_drops_the_write(arch, archs):
    """A decode whose write index reaches ``cache_len`` (no window): JAX
    drops the out-of-bounds scatter and attends over the old cache; so
    does the port (torch would raise on the CPU and assert on the
    card)."""
    a = archs(arch)
    s = S + (a.cfg.n_frontend_tokens if a.cfg.family == "vlm" else 0)
    want = a._jax_decode(cache_len=s, steps=a.steps[:2])
    got = a.port_decode(cache_len=s, steps=a.steps[:2])
    assert int(got[0][1].index[0]) == s
    for i, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        close(gl, wl, f"step {i}: logits")
        same_cache(gc, wc, f"step {i}")
    # The prefilled cache is unchanged by the dropped writes.
    for f in ("k", "v", "pos"):
        equal(getattr(got[2][1].kv, f), getattr(got[0][1].kv, f), f)


def test_cache_to_torch_carries_a_jax_cache(archs):
    """Decoding on from a JAX prefill cache carried across equals JAX."""
    a = archs("olmo-1b")
    (_, jcache), (jl, jc) = a.jax("decode")[:2]
    cache = cache_to_torch(jcache, device="cpu")
    same_cache(cache, jcache, "carried")
    logits, cache = a.model.decode_step(cache, a.steps[0])
    close(logits, jl, "logits")
    same_cache(cache, jc, "decode")


FLASH_CASES = [(0, 0), (7, 0), (0, 20), (5, 13)]


@pytest.mark.parametrize("prefix,window", FLASH_CASES)
def test_flash_equals_direct_and_jax(prefix, window):
    kw = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab=64, attn_kv_block=16)
    cfg, jcfg = ModelConfig(**kw), JModelConfig(**kw)
    rng = np.random.default_rng(3)
    jp = jinit_params(jattn_defs(jcfg), jax.random.PRNGKey(0), jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = rng.normal(size=(B, 50, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(50, dtype=np.int32), (B, 50))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos.copy())
    outs = {}
    for name, direct_max in (("direct", 4096), ("flash", 1)):
        outs[name], _ = attention(tx, p, cfg.with_(attn_direct_max=direct_max),
                                  tpos, prefix_len=prefix, window=window)
        want, _ = jattention(jnp.asarray(x), jp,
                             jcfg.with_(attn_direct_max=direct_max),
                             jnp.asarray(pos), prefix_len=prefix,
                             window=window)
        close(outs[name], want, f"{name} vs JAX", tol=1e-5)
    close(outs["flash"], outs["direct"].numpy(), "flash vs direct", tol=1e-5)


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_match_on_full_configs(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    defs, jdefs = param_defs(cfg), JModel(jcfg).param_defs()
    assert count_params(defs) == cfg.param_count() == jcount_params(jdefs)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert param_bytes(defs, cfg.pdtype) == jparam_bytes(jdefs, jcfg.pdtype)


def test_load_params_rejects_a_mismatched_tree(archs):
    a = archs("olmo-1b")
    bad = jax.tree.map(lambda x: x, a.params)
    bad["embed"] = dict(bad["embed"], extra=bad["embed"]["tok"])
    with pytest.raises(ValueError):
        load_params(a.model, bad)
    bad = dict(a.params, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError):
        load_params(a.model, bad)
    load_params(a.model, a.params)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("olmo-1b", "deepseek-moe-16b",
                                  "paligemma-3b", "musicgen-large",
                                  "mamba2-1.3b", "zamba2-1.2b"))
def test_cuda_family_matches_cpu(arch, cuda_device):
    """The forward, prefill and three decode steps on the card equal the
    port's CPU run (same weights) within ``TOL``."""
    cfg = get_smoke(arch)
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    batch, steps = make_batch(cfg, rng), step_inputs(cfg, rng, DECODE_STEPS)
    with torch.no_grad():
        close(gpu.forward(batch)[0], cpu.forward(batch)[0].numpy(), "fwd")
    (gl, gc), (cl, cc) = (m.prefill(batch, CACHE_LEN) for m in (gpu, cpu))
    close(gl, cl.numpy(), "prefill")
    for x in steps:
        (gl, gc), (cl, cc) = gpu.decode_step(gc, x), cpu.decode_step(cc, x)
        close(gl, cl.numpy(), "decode")
