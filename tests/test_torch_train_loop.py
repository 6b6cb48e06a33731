"""The port's training path against the JAX package's, on the CPU.

``repro_torch.data.lm_data``, ``Model.loss`` + autograd,
``train.train_step`` and ``train.optimizer`` run beside ``repro``'s on
the ``SMOKE`` configs, with JAX's weights carried in
(``models.params.load_params``) and JAX's parameters and optimizer state
read back through ``params_to_tree`` / ``opt_state_from_tree``.

Tolerances (f32 on both sides, different reduction orders): per-leaf
gradients within 1e-4 of the leaf's largest JAX gradient (a parameter
the loss does not read has no gradient in torch and zeros in JAX); over
5 train steps, ``ce`` within 1e-5, ``grad_norm`` within 1e-4 relative,
``lr`` within one f32 ulp of ``lr_peak``, and the final parameters
within 1e-4 (AdamW's step is ~``lr`` per element whatever the
gradient's size, so this is ~3% of one step).  Batches are array-equal;
the port's own resume, and its remat modes, are bit for bit.  One JAX
baseline per arch is computed once per module, and torch runs on one
thread.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jget_smoke
from repro.data import lm_data as jdata
from repro.models.model import Model as JModel
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_smoke
from repro_torch.data.lm_data import DataConfig, make_batch
from repro_torch.models import Model
from repro_torch.models.params import (_tree_key, load_params,
                                       opt_state_from_tree, params_to_tree)
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import batch_to, make_train_step

FAMILIES = ("olmo-1b", "deepseek-moe-16b", "paligemma-3b",
            "musicgen-large", "mamba2-1.3b", "zamba2-1.2b")
GRAD_TOL = 1e-4
STEPS = 5
OPT = dict(lr_peak=3e-3, warmup_steps=5, total_steps=30, use_master=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def leaf_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_items(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def close_trees(got, want, atol, what):
    want = dict(leaf_items(want))
    got = dict(leaf_items(got))
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= atol, f"{what} {k}: max |diff| {err} > {atol}"


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_data_deterministic():
    cfg = get_smoke("olmo-1b")
    d = DataConfig(batch=4, seq=32, seed=5)
    b1 = make_batch(cfg, d, 7)
    b2 = make_batch(cfg, d, 7)
    assert (b1["tokens"] == b2["tokens"]).all()
    b3 = make_batch(cfg, d, 8)
    assert not (b1["tokens"] == b3["tokens"]).all()


@pytest.mark.parametrize("arch", FAMILIES)
def test_make_batch_matches_jax(arch):
    d = dict(batch=3, seq=24, seed=11)
    for step in (0, 5):
        got = make_batch(get_smoke(arch), DataConfig(**d), step)
        want = jdata.make_batch(jget_smoke(arch), jdata.DataConfig(**d), step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


class Arch:
    """One arch's JAX weights, batch and gradients (computed once)."""

    def __init__(self, arch):
        self.cfg, self.jcfg = get_smoke(arch), jget_smoke(arch)
        self.jm = JModel(self.jcfg, remat="none")
        self.params = self.jm.init(jax.random.PRNGKey(0))
        self.batch = make_batch(self.cfg, DataConfig(batch=2, seq=32), 0)
        (self.loss, _), self.grads = jax.jit(jax.value_and_grad(
            self.jm.loss, has_aux=True))(self.params, jbatch(self.batch))

    def model(self, remat="none"):
        m = Model(self.cfg, device="cpu", remat=remat)
        load_params(m, self.params)
        return m


@pytest.fixture(scope="module")
def archs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = Arch(arch)
        return cache[arch]
    return get


def port_grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_match_jax(arch, archs):
    a = archs(arch)
    model = a.model()
    loss, grads = port_grads(model, a.batch)
    assert abs(float(loss.detach()) - float(a.loss)) <= 1e-5 * max(
        1.0, abs(float(a.loss)))
    want = dict(leaf_items(a.grads))
    none = {n for n, g in grads.items() if g is None}
    filled = {n: torch.zeros_like(p) if grads[n] is None else grads[n]
              for n, p in model.named_parameters()}
    got = dict(leaf_items(params_to_tree(model, filled)))
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= GRAD_TOL * scale, \
            f"{arch} {k}: {err} > {GRAD_TOL} * {scale}"
    # torch's "no gradient" is JAX's exact zeros
    for n in none:
        assert not want["/".join(_tree_key(n)[0])].any(), n


@pytest.mark.parametrize("arch", ("olmo-1b", "deepseek-moe-16b",
                                  "zamba2-1.2b"))
def test_remat_modes_give_equal_gradients(arch, archs):
    """``full`` and ``dots`` recompute what ``none`` keeps: the gradients
    are bit for bit those of ``none`` (the hybrid's shared attention call
    and SSM layer are one recomputed body)."""
    a = archs(arch)
    _, want = port_grads(a.model("none"), a.batch)
    for mode in ("full", "dots"):
        _, got = port_grads(a.model(mode), a.batch)
        for n, g in want.items():
            assert (g is None) == (got[n] is None), (mode, n)
            if g is not None:
                assert torch.equal(got[n], g), (mode, n)


def test_unknown_remat_mode_raises():
    with pytest.raises(ValueError):
        Model(get_smoke("olmo-1b"), device="cpu", remat="most")


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ("olmo-1b", "deepseek-moe-16b"))
def test_train_steps_match_jax(arch, archs):
    a = archs(arch)
    dcfg = DataConfig(batch=4, seq=32)
    jparams = a.params
    jopt = jinit_state(JAdamWConfig(**OPT), jparams)
    jstep = jax.jit(jmake_train_step(a.jm, JAdamWConfig(**OPT)))
    model = a.model()
    opt = init_state(AdamWConfig(**OPT), dict(model.named_parameters()))
    step = make_train_step(model, AdamWConfig(**OPT))
    for s in range(STEPS):
        batch = make_batch(a.cfg, dcfg, s)
        jparams, jopt, jm = jstep(jparams, jopt, jbatch(batch))
        model, opt, m = step(model, opt, batch_to(batch, "cpu"))
        assert abs(float(m["ce"]) - float(jm["ce"])) <= 1e-5, s
        assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) \
            <= 1e-4, s
        assert abs(float(m["lr"]) - float(jm["lr"])) <= OPT["lr_peak"] \
            * 2.0 ** -23, s
        assert set(m) == set(jm), s
        if "expert_load" in jm:
            assert np.array_equal(m["expert_load"].numpy(),
                                  np.asarray(jm["expert_load"])), s
    assert int(opt.step) == int(jopt.step) == STEPS
    close_trees(params_to_tree(model), jparams, 1e-4, f"{arch} params")
    close_trees(params_to_tree(model, opt.m), jopt.m, 1e-4, f"{arch} m")


def test_train_step_continues_from_a_jax_state(archs):
    """One step from JAX's parameters and optimizer state after two JAX
    steps (carried by ``load_params`` and ``opt_state_from_tree``) equals
    JAX's third step."""
    a = archs("olmo-1b")
    dcfg = DataConfig(batch=4, seq=32)
    jstep = jax.jit(jmake_train_step(a.jm, JAdamWConfig(**OPT)))
    jparams, jopt = a.params, jinit_state(JAdamWConfig(**OPT), a.params)
    for s in range(2):
        jparams, jopt, _ = jstep(jparams, jopt,
                                 jbatch(make_batch(a.cfg, dcfg, s)))
    model = Model(a.cfg, device="cpu", remat="none")
    load_params(model, jparams)
    opt = opt_state_from_tree(model, jopt)
    assert int(opt.step) == 2
    batch = make_batch(a.cfg, dcfg, 2)
    jparams, jopt, jm = jstep(jparams, jopt, jbatch(batch))
    model, opt, m = make_train_step(model, AdamWConfig(**OPT))(
        model, opt, batch_to(batch, "cpu"))
    assert abs(float(m["ce"]) - float(jm["ce"])) <= 1e-5
    close_trees(params_to_tree(model), jparams, 1e-4, "params")
    close_trees(params_to_tree(model, opt.v), jopt.v, 1e-4, "v")


def _train(arch="olmo-1b", steps=30, seed=0, model=None, opt=None,
           start_step=0):
    cfg = get_smoke(arch)
    opt_cfg = AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=steps,
                          use_master=False)
    dcfg = DataConfig(batch=4, seq=32, seed=seed)
    if model is None:
        model = Model(cfg, device="cpu", remat="none").init(
            torch.Generator().manual_seed(seed))
    opt = opt or init_state(opt_cfg, dict(model.named_parameters()))
    step_fn = make_train_step(model, opt_cfg)
    losses = []
    for s in range(start_step, steps):
        model, opt, m = step_fn(model, opt,
                                batch_to(make_batch(cfg, dcfg, s), "cpu"))
        losses.append(float(m["ce"]))
    return model, opt, losses


def test_loss_decreases():
    _, _, losses = _train(steps=30)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_resume_bit_exact(tmp_path):
    """10 straight steps == 5 steps + a checkpoint + a restart into a
    fresh model + 5 steps (same data, same optimizer state) — the
    fault-tolerance contract, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager

    mA, _, _ = _train(steps=10)
    m5, o5, _ = _train(steps=5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, (dict(m5.named_parameters()), o5))
    fresh = Model(get_smoke("olmo-1b"), device="cpu", remat="none")
    params, opt = mgr.restore((dict(fresh.named_parameters()), o5))
    with torch.no_grad():
        for n, p in fresh.named_parameters():
            p.copy_(params[n])
    mB, _, _ = _train(steps=10, model=fresh, opt=opt, start_step=5)
    for (n, a), b in zip(mA.named_parameters(), mB.parameters()):
        assert torch.equal(a, b), n


def test_gradients_repeat_bit_for_bit_on_threads():
    """Two backwards of one batch give the same gradients bit for bit with
    four intra-op threads: the embedding's backward is ``F.embedding``'s
    ordered sum (indexing's accumulating backward adds a token's rows
    atomically, which broke the resume contract run to run)."""
    cfg = get_smoke("olmo-1b")
    model = Model(cfg, device="cpu", remat="none").init(
        torch.Generator().manual_seed(0))
    batch = batch_to(make_batch(cfg, DataConfig(batch=8, seq=128), 0), "cpu")
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [port_grads(model, batch)[1] for _ in range(4)]
    finally:
        torch.set_num_threads(before)
    for n, g in runs[0].items():
        for r in runs[1:]:
            assert (g is None and r[n] is None) or torch.equal(g, r[n]), n


def test_moe_gradients_repeat_bit_for_bit_on_threads():
    """The same for deepseek-moe: the combine sums each token's expert
    outputs in order and the dispatch gathers through a permutation, so
    nothing adds atomically (``index_add_`` and the backward of indexing
    by token did)."""
    cfg = get_smoke("deepseek-moe-16b")
    model = Model(cfg, device="cpu", remat="none").init(
        torch.Generator().manual_seed(0))
    batch = batch_to(make_batch(cfg, DataConfig(batch=8, seq=128), 0), "cpu")
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [port_grads(model, batch)[1] for _ in range(4)]
    finally:
        torch.set_num_threads(before)
    for n, g in runs[0].items():
        for r in runs[1:]:
            assert (g is None and r[n] is None) or torch.equal(g, r[n]), n


def test_moe_train_returns_expert_loads():
    cfg = get_smoke("deepseek-moe-16b")
    model = Model(cfg, device="cpu", remat="none").init(
        torch.Generator().manual_seed(0))
    opt_cfg = AdamWConfig(total_steps=3, use_master=False)
    dcfg = DataConfig(batch=2, seq=16)
    opt = init_state(opt_cfg, dict(model.named_parameters()))
    step_fn = make_train_step(model, opt_cfg)
    model, opt, m = step_fn(model, opt,
                            batch_to(make_batch(cfg, dcfg, 0), "cpu"))
    loads = m["expert_load"].numpy()
    assert loads.shape == (cfg.n_layers, cfg.n_experts)
    # every routed token accounted for: sum = T * top_k per layer
    t = dcfg.batch * dcfg.seq
    assert np.allclose(loads.sum(-1), t * cfg.top_k, rtol=1e-5)


def test_microbatch_grad_accumulation_matches(archs):
    """2 microbatches must equal the single-shot gradient step (the
    reference test's 2e-5), and equal JAX's 2-microbatch step."""
    a = archs("olmo-1b")
    opt_cfg = dict(total_steps=2, use_master=False)
    batch = make_batch(a.cfg, DataConfig(batch=4, seq=16), 0)
    outs = {}
    for mb in (1, 2):
        model = a.model()
        opt = init_state(AdamWConfig(**opt_cfg),
                         dict(model.named_parameters()))
        fn = make_train_step(model, AdamWConfig(**opt_cfg), microbatches=mb)
        model, _, m = fn(model, opt, batch_to(batch, "cpu"))
        outs[mb] = params_to_tree(model)
    close_trees(outs[2], outs[1], 2e-5, "microbatches 2 vs 1")
    jfn = jax.jit(jmake_train_step(a.jm, JAdamWConfig(**opt_cfg),
                                   microbatches=2))
    jp, _, jm = jfn(a.params, jinit_state(JAdamWConfig(**opt_cfg), a.params),
                    jbatch(batch))
    close_trees(outs[2], jp, 1e-4, "microbatches 2 vs JAX")
    assert abs(float(m["loss_out"]) - float(jm["loss_out"])) <= 1e-5


class _ModelAxisOnly:
    """A mesh without a "data" axis (only ``shape`` is read)."""

    shape = {"model": 2}


def test_compressed_grads_over_a_mesh_is_not_ported():
    """``compressed_grads`` compresses over a mesh's "data" axis only (the
    reference's condition; the compressed all-reduce itself is
    tests/test_torch_collectives.py): without a mesh, or over a mesh with
    no "data" axis, the step is the uncompressed one bit for bit and the
    residuals stay as they were."""
    cfg = get_smoke("olmo-1b")
    batch = batch_to(make_batch(cfg, DataConfig(batch=2, seq=16), 0), "cpu")
    ocfg = AdamWConfig(**OPT, error_feedback=True)
    finals = []
    for kw in ({}, dict(compressed_grads=True),
               dict(compressed_grads=True, mesh=_ModelAxisOnly())):
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        opt = init_state(ocfg, dict(model.named_parameters()))
        ef = opt.ef
        model, opt, _ = make_train_step(model, ocfg, **kw)(model, opt, batch)
        assert opt.ef is ef and all(not e.any() for e in ef.values())
        finals.append(params_to_tree(model))
    for f in finals[1:]:
        for (k, a), (_, b) in zip(leaf_items(f), leaf_items(finals[0])):
            assert np.array_equal(a, b), k


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def test_cuda_is_the_default():
    """Without a card, the default device raises (the port never falls
    back to the CPU on its own); with one, the model lands there."""
    from repro_torch.launch import train

    cfg = get_smoke("olmo-1b")
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "olmo-1b", "--smoke", "--steps", "1"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_moe_gradients_repeat_bit_for_bit(cuda_device):
    """Two deepseek-moe backwards of one batch on the card give the same
    gradients, leaf for leaf, bit for bit (the MoE combine and dispatch
    add nothing atomically)."""
    cfg = get_smoke("deepseek-moe-16b")
    model = Model(cfg, device=cuda_device, remat="none").init(
        torch.Generator(device=cuda_device).manual_seed(0))
    batch = batch_to(make_batch(cfg, DataConfig(batch=8, seq=128), 0),
                     cuda_device)
    runs = [port_grads(model, batch)[1] for _ in range(2)]
    for n, g in runs[0].items():
        assert (g is None and runs[1][n] is None) or torch.equal(
            g, runs[1][n]), n


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("olmo-1b", "deepseek-moe-16b"))
def test_cuda_train_step_matches_cpu(arch, cuda_device):
    """From the same weights, the card's gradients equal the port's CPU
    run per leaf within ``GRAD_TOL`` of the leaf's largest, and remat
    full equals none there bit for bit.  Over three train steps ce
    compares within 1e-5 and grad_norm within 1e-3 relative, and the
    parameters' updates within 1e-2 in L2: AdamW's first step moves each
    element by lr times its gradient's sign, so elements whose gradient
    is within rounding of zero move opposite ways, and a token near a
    routing tie may pick another expert (MoE)."""
    cfg = get_smoke(arch)
    cpu = Model(cfg, device="cpu", remat="none").init(
        torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda_device, remat="none")
    gpu.load_state_dict(cpu.state_dict())
    start = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    batches = [make_batch(cfg, DataConfig(batch=4, seq=32), s)
               for s in range(3)]
    _, want = port_grads(cpu, batch_to(batches[0], "cpu"))
    _, got = port_grads(gpu, batch_to(batches[0], cuda_device))
    gpu.remat = "full"
    _, full = port_grads(gpu, batch_to(batches[0], cuda_device))
    for n, w in want.items():
        assert (w is None) == (got[n] is None), n
        if w is not None:
            err = float((got[n].cpu() - w).abs().max())
            assert err <= GRAD_TOL * float(w.abs().max()), n
            assert torch.equal(full[n], got[n]), n
    runs = []
    for model in (cpu, gpu):
        opt = init_state(AdamWConfig(**OPT), dict(model.named_parameters()))
        step = make_train_step(model, AdamWConfig(**OPT))
        ms = []
        for b in batches:
            model, opt, m = step(model, opt, batch_to(b, model.device))
            ms.append((float(m["ce"]), float(m["grad_norm"])))
        runs.append(ms)
    for (ce, gn), (gce, ggn) in zip(*runs):
        assert abs(gce - ce) <= 1e-5 and abs(ggn / gn - 1) <= 1e-3
    num = den = 0.0
    with torch.no_grad():
        for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
            num += float((q.cpu() - p).double().square().sum())
            den += float((p - start[n]).double().square().sum())
    assert (num / den) ** 0.5 <= 1e-2
