"""The port's compressed gradient all-reduce against the JAX package's, on
4 gloo ranks (the CPU) and 4 JAX host devices.

``repro_torch.distributed.collectives.compressed_psum_tree`` runs on 4
ranks spawned once for the module; ``repro.distributed.collectives`` runs
once in a JAX subprocess with 4 host devices, its ``compressed_psum_tree``
jitted so the ``shard_map`` compiles once.  The arithmetic is elementwise
f32 with an exact max and round-half-to-even, so the outputs and the
residuals are bit-equal: on the reference's replicated input, on
distinct per-rank inputs (JAX's ``_compressed_allreduce`` under a
``shard_map`` with ``P("data")`` specs), and over 20 error-feedback
rounds, which converge within the reference's 1.2 quantization steps.
Only int8 tensors reach ``all_to_all_single`` and the all-gather.

The ``SMOKE`` olmo compressed train step on a ``data=4`` mesh, with the
same batch on every rank, is held against JAX's ``make_train_step(
compressed_grads=True)`` on 4 host devices, the gradients each step
compresses sent to the host by a callback.  The int8 grid is a step
function of the gradient: the two frameworks' gradients agree within
``test_torch_train_loop``'s 1e-4 of a leaf's largest, not bit for bit,
and an element within that rounding of a grid boundary lands on the
neighbouring level (on this batch, 2.8% of the elements move by the
learning rate in one framework and not the other).  So the port's own
backward is held to JAX's gradients within that tolerance, and the
step itself -- compression, error feedback carried into the next step,
AdamW -- is held to JAX's from JAX's gradients, within
``test_torch_train_loop``'s tolerances.

``run_ranks`` itself: a rank that raises or hangs fails the call within
its limit, and NCCL's one rank per GPU is enforced (a world larger than
the GPU count is refused, with a stubbed count).  The ``gpu`` test
``test_cuda_multi_gpu_compressed_psum_equals_gloo`` runs the collective
on one NCCL rank per GPU against as many gloo ranks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import (finish_jax, flat, nest, one_rank_mesh, run_ranks,
                         start_jax)
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_state as jinit_state
from repro_torch.configs import get_smoke
from repro_torch.data.lm_data import DataConfig, make_batch
from repro_torch.models import Model
from repro_torch.models.model import param_defs
from repro_torch.models.params import (_tree_key, init_scale,
                                       opt_state_from_tree)

WORLD = 4
ROUNDS = 20
STEPS = 2
OPT = dict(lr_peak=3e-3, warmup_steps=5, total_steps=30, use_master=False,
           error_feedback=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def numpy_params(cfg, seed=0):
    """A parameter tree of ``cfg`` drawn with numpy at the reference's
    scales (both packages load it)."""
    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        return (rng.normal(size=d.shape) * init_scale(d)).astype(np.float32)

    def walk(defs):
        return {k: (walk(v) if isinstance(v, dict) else draw(v))
                for k, v in defs.items()}
    return walk(param_defs(cfg))


def make_inputs():
    rng = np.random.default_rng(0)
    inp = {"rep/w": rng.normal(size=(64, 32)).astype(np.float32),
           "rep/b": rng.normal(size=(128,)).astype(np.float32)}
    rng = np.random.default_rng(1)
    # 130 elements: the all_to_all pads to a multiple of the 4 ranks.
    for name, shape in (("w", (64, 32)), ("b", (130,))):
        inp[f"dist/{name}"] = rng.normal(size=(WORLD,) + shape).astype(
            np.float32)
        inp[f"dist/e{name}"] = (0.01 * rng.normal(size=(WORLD,) + shape)
                                ).astype(np.float32)
    cfg = get_smoke("olmo-1b")
    for k, v in flat(numpy_params(cfg)).items():
        inp[f"params/{k}"] = v
    for s in range(STEPS):
        for k, v in make_batch(cfg, DataConfig(batch=4, seq=16), s).items():
            inp[f"batch{s}/{k}"] = v
    return inp


JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_smoke
from repro.distributed.collectives import (_compressed_allreduce,
                                           compressed_psum_tree)
from repro.models.model import Model
from repro.train.optimizer import AdamWConfig, init_state
from repro.train.train_step import make_train_step
inp = dict(np.load(IN))
mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
res = {}

def nest(prefix):
    out = {}
    for key, v in inp.items():
        if key.startswith(prefix):
            node = out
            parts = key[len(prefix):].split("/")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = jnp.asarray(v)
    return out

g = nest("rep/")
first = jax.jit(lambda g: compressed_psum_tree(g, (), mesh, "data"))
again = jax.jit(lambda g, e: compressed_psum_tree(g, e, mesh, "data"))
out, ef = first(g)
acc = jax.tree.map(lambda a, x: a + x / ROUNDS, jax.tree.map(jnp.zeros_like,
                                                             g), out)
e = ef
for _ in range(ROUNDS - 1):
    o, e = again(g, e)
    acc = jax.tree.map(lambda a, x: a + x / ROUNDS, acc, o)
for k in g:
    res[f"rep/out/{k}"] = np.asarray(out[k])
    res[f"rep/ef/{k}"] = np.asarray(ef[k])
    res[f"rep/acc/{k}"] = np.asarray(acc[k])
    res[f"rep/ef_last/{k}"] = np.asarray(e[k])

def body(w, b, ew, eb):
    ow, nw = _compressed_allreduce(w[0], ew[0], "data", 4)
    ob, nb = _compressed_allreduce(b[0], eb[0], "data", 4)
    return ow[None], ob[None], nw[None], nb[None]
f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * 4,
                      out_specs=(P("data"),) * 4, check_rep=False))
d = nest("dist/")
ow, ob, nw, nb = f(d["w"], d["b"], d["ew"], d["eb"])
res.update({"dist/out/w": np.asarray(ow), "dist/out/b": np.asarray(ob),
            "dist/ef/w": np.asarray(nw), "dist/ef/b": np.asarray(nb)})

import repro.train.train_step as ts
seen = []
real_psum = ts.compressed_psum_tree

def stash(grads, ef, mesh, axis="data"):
    jax.debug.callback(lambda g: seen.append(jax.tree.map(np.array, g)),
                       grads)
    return real_psum(grads, ef, mesh, axis)

ts.compressed_psum_tree = stash
cfg = get_smoke("olmo-1b")
jm = Model(cfg)
ocfg = AdamWConfig(**OPT)
step = jax.jit(make_train_step(jm, ocfg, compressed_grads=True, mesh=mesh))
params = nest("params/")
st = init_state(ocfg, params)

def flat(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + "/" + k)
    else:
        yield prefix, np.asarray(tree)

for s in range(STEPS):
    params, st, m = step(params, st, nest(f"batch{s}/"))
    jax.effects_barrier()
    for k in ("ce", "grad_norm", "lr"):
        res[f"train/{s}/{k}"] = np.asarray(m[k])
    res.update(dict(flat(seen[-1], f"grads{s}")))  # one call per device
    seen.clear()
res.update(dict(flat(params, "train/params")))
res.update(dict(flat(st.ef, "train/ef")))
np.savez(OUT, **res)
"""


def rank_main(rank, world, in_path, jax_path):
    """Everything the module checks, on one rank."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import compressed_psum_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import load_params, params_to_tree
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import batch_to, make_train_step

    inp = dict(np.load(in_path))
    mesh = make_host_mesh(data=world, model=1, device="cpu")
    try:
        make_host_mesh(data=world, model=2, device="cpu")
        too_big = None
    except RuntimeError as e:
        too_big = str(e)
    wire = []
    real = {n: getattr(dist, n) for n in (
        "all_to_all_single", "all_gather_into_tensor", "all_reduce")}

    def recording(name):
        def call(*args, **kw):
            t = args[1] if name != "all_reduce" else args[0]
            wire.append((name, str(t.dtype), t.numel() * t.element_size()))
            return real[name](*args, **kw)
        return call

    def tree(prefix):
        return {k[len(prefix):]: torch.from_numpy(v) for k, v in inp.items()
                if k.startswith(prefix)}

    res = {"too_big": too_big, "shape": mesh.shape,
           "coordinate": mesh.coordinate}
    g = tree("rep/")
    for n in real:
        setattr(dist, n, recording(n))
    try:
        out, ef = compressed_psum_tree(g, (), mesh, "data")
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)
    res["wire"] = wire
    acc = {k: torch.zeros_like(v) + o / ROUNDS for (k, v), o in
           zip(g.items(), out.values())}
    e = ef
    for _ in range(ROUNDS - 1):
        o, e = compressed_psum_tree(g, e, mesh, "data")
        acc = {k: acc[k] + o[k] / ROUNDS for k in acc}
    for k in g:
        res[f"rep/out/{k}"] = out[k].numpy()
        res[f"rep/ef/{k}"] = ef[k].numpy()
        res[f"rep/acc/{k}"] = acc[k].numpy()
        res[f"rep/ef_last/{k}"] = e[k].numpy()

    d = tree("dist/")
    out, ef = compressed_psum_tree(
        {"w": d["w"][rank], "b": d["b"][rank]},
        {"w": d["ew"][rank], "b": d["eb"][rank]}, mesh, "data")
    for k in ("w", "b"):
        res[f"dist/out/{k}"] = out[k].numpy()
        res[f"dist/ef/{k}"] = ef[k].numpy()

    from repro_torch.models.params import _named_leaves
    from repro_torch.train import train_step as ts

    jax_out = dict(np.load(jax_path))
    cfg = get_smoke("olmo-1b")
    model = Model(cfg, device="cpu")
    load_params(model, nest({k: v.numpy() for k, v in
                             tree("params/").items()}))
    ocfg = AdamWConfig(**OPT)
    batches = [batch_to({k: v.numpy() for k, v in
                         tree(f"batch{s}/").items()}, "cpu")
               for s in range(STEPS)]
    _, _, own = ts._grads(model, batches[0])
    res.update({f"own/{k}": v for k, v in flat(params_to_tree(model, {
        n: torch.zeros(p.shape) if own[n] is None else own[n]
        for n, p in model.named_parameters()})).items()})

    # The step from the gradients JAX's step compressed.
    real_grads, step_no = ts._grads, []

    def jax_grads(model, batch):
        loss, metrics, _ = real_grads(model, batch)
        tree_ = nest({k[len(f"grads{len(step_no)}/"):]: v
                      for k, v in jax_out.items()
                      if k.startswith(f"grads{len(step_no)}/")})
        step_no.append(1)
        return loss, metrics, {n: torch.from_numpy(np.array(a)) for n, a in
                               _named_leaves(model, tree_).items()}

    opt = init_state(ocfg, dict(model.named_parameters()))
    step = make_train_step(model, ocfg, compressed_grads=True, mesh=mesh)
    ts._grads = jax_grads
    try:
        for s in range(STEPS):
            model, opt, m = step(model, opt, batches[s])
            for k in ("ce", "grad_norm", "lr"):
                res[f"train/{s}/{k}"] = float(m[k])
    finally:
        ts._grads = real_grads
    res.update({f"train/params/{k}": v for k, v in
                flat(params_to_tree(model)).items()})
    res.update({f"train/ef/{k}": v for k, v in
                flat(params_to_tree(model, opt.ef)).items()})
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    in_path, out = str(d / "inputs.npz"), str(d / "jax.npz")
    inp = make_inputs()
    np.savez(in_path, **inp)
    code = (f"IN = {in_path!r}\nROUNDS = {ROUNDS}\nSTEPS = {STEPS}\n"
            f"OPT = {OPT!r}\n" + JAX_CODE)
    want = finish_jax(start_jax(code, WORLD, out), out)
    return inp, run_ranks(rank_main, WORLD, in_path, out,
                          backend="gloo"), want


def bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
        f"{what}: {int((got != want).sum())} elements differ, max |diff| " \
        f"{float(np.abs(got - want).max())}"


@pytest.mark.parametrize("what", ("out", "ef", "acc", "ef_last"))
def test_replicated_input_is_bit_equal_to_jax(runs, what):
    """The reference test's input on every rank: outputs and residuals of
    the first round, and after 20 error-feedback rounds, bit for bit on
    every rank."""
    _, ranks, want = runs
    for r, res in enumerate(ranks):
        for k in ("w", "b"):
            bits(res[f"rep/{what}/{k}"], want[f"rep/{what}/{k}"],
                 f"rank {r} {what} {k}")


@pytest.mark.parametrize("what", ("out", "ef"))
def test_distinct_inputs_are_bit_equal_to_jax(runs, what):
    """Each rank its own gradient and residual (the b leaf pads 130 to
    132): the group mean on every rank and each rank's new residual."""
    _, ranks, want = runs
    for r, res in enumerate(ranks):
        for k in ("w", "b"):
            bits(res[f"dist/{what}/{k}"], want[f"dist/{what}/{k}"][r],
                 f"rank {r} {what} {k}")


def test_reference_bounds_hold(runs):
    """The reference test's bounds: replicated input -> the mean is the
    input within 3 quantization steps, the residual within 2, and the
    average of 20 error-feedback rounds within 1.2 steps."""
    inp, ranks, _ = runs
    for res in ranks:
        for k in ("w", "b"):
            g = inp[f"rep/{k}"]
            scale = float(np.abs(g).max()) / 127.0
            assert float(np.abs(res[f"rep/out/{k}"] - g).max()) <= 3 * scale
            assert float(np.abs(res[f"rep/ef/{k}"]).max()) <= 2 * scale
            assert float(np.abs(res[f"rep/acc/{k}"] - g).max()) < 1.2 * scale


def test_host_mesh_over_the_ranks(runs):
    """``make_host_mesh(data=4)`` spans the 4 ranks, one coordinate each;
    asking for more ranks than the group has raises, as the reference
    does for devices."""
    _, ranks, _ = runs
    assert [r["shape"] for r in ranks] == [{"data": WORLD, "model": 1}] * 4
    assert sorted(r["coordinate"]["data"] for r in ranks) == list(
        range(WORLD))
    assert all(r["too_big"] == f"need {2 * WORLD} ranks, have {WORLD}"
               for r in ranks)


def test_only_int8_on_the_wire(runs):
    """Per leaf: one f32 scalar all-reduce per scale (the shared max), and
    int8 for the all_to_all and the all-gather: 1 byte per (padded)
    element each, a quarter of an f32 payload."""
    inp, ranks, _ = runs
    for res in ranks:
        wire = res["wire"]
        payload = [(n, dt, b) for n, dt, b in wire if n != "all_reduce"]
        assert [dt for _, dt, _ in payload] == ["torch.int8"] * 4
        sizes = {k: inp[f"rep/{k}"].size for k in ("w", "b")}
        assert [b for _, _, b in payload] == [
            sizes["w"], sizes["w"] // WORLD, sizes["b"], sizes["b"] // WORLD]
        scalars = [(dt, b) for n, dt, b in wire if n == "all_reduce"]
        assert scalars == [("torch.float32", 4)] * 4


def test_own_gradients_match_jax(runs):
    """Each rank's own backward of the first step, leaf by leaf, within
    1e-4 of JAX's largest (test_torch_train_loop's tolerance); a leaf
    the loss does not read has no gradient in torch (zeros here) and
    zeros in JAX."""
    _, ranks, want = runs
    for r, res in enumerate(ranks):
        for key in (k for k in want if k.startswith("grads0/")):
            w = want[key]
            got = res["own/" + key[len("grads0/"):]]
            err = float(np.abs(got - w).max())
            assert err <= 1e-4 * float(np.abs(w).max()), \
                f"rank {r} {key}: {err}"


def test_compressed_train_step_matches_jax(runs):
    """Two compressed train steps from JAX's gradients, the residuals of
    the first carried into the second: parameters within 1e-4, residuals
    within 1e-4 of the leaf's largest (XLA fuses the jitted step's
    arithmetic its own way, so they agree to rounding, not bit for bit as
    the collective alone does), ce within 1e-5, grad_norm (of the
    compressed gradients) within 1e-4 relative, lr within one f32 ulp."""
    _, ranks, want = runs
    for r, res in enumerate(ranks):
        for s in range(STEPS):
            ce, gn = res[f"train/{s}/ce"], res[f"train/{s}/grad_norm"]
            assert abs(ce - float(want[f"train/{s}/ce"])) <= 1e-5
            assert abs(gn / float(want[f"train/{s}/grad_norm"]) - 1) <= 1e-4
            assert abs(res[f"train/{s}/lr"] - float(want[f"train/{s}/lr"])
                       ) <= float(np.spacing(np.float32(OPT["lr_peak"])))
        for key in (k for k in want if k.startswith("train/params/")):
            err = float(np.abs(res[key] - want[key]).max())
            assert err <= 1e-4, f"rank {r} {key}: {err}"
        for key in (k for k in want if k.startswith("train/ef/")):
            err = float(np.abs(res[key] - want[key]).max())
            assert err <= 1e-4 * float(np.abs(want[key]).max()), \
                f"rank {r} {key}: {err}"


def test_ef_is_carried_through_opt_state_from_tree():
    """A reference optimizer state with error-feedback residuals converts
    to the port's, residual for residual."""
    cfg = get_smoke("olmo-1b")
    tree = numpy_params(cfg, seed=3)
    jstate = jinit_state(JAdamWConfig(**OPT),
                         {k: v for k, v in tree.items()})
    rng = np.random.default_rng(4)
    ef = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), jstate.ef)
    state = opt_state_from_tree(Model(cfg, device="cpu"),
                                jstate._replace(ef=ef))
    assert set(state.ef) == {n for n, _ in Model(cfg, "cpu")
                             .named_parameters()}
    for name, got in state.ef.items():
        key, layer = _tree_key(name)
        node = ef
        for k in key:
            node = node[k]
        want = np.asarray(node if layer is None else node[layer])
        assert np.array_equal(got.numpy(), want), name


@pytest.mark.gpu
def test_cuda_compressed_psum_equals_cpu():
    """The same inputs through the card (NCCL) and the CPU (gloo) of one
    group: means and residuals bit-equal (elementwise IEEE ops, an exact
    max, round half to even, the residual rounded once), the reference
    test's leaves and a 2048 x 2048 one."""
    from repro_torch.distributed.collectives import compressed_psum_tree

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    inp = make_inputs()
    g = {"w": torch.from_numpy(inp["rep/w"]),
         "b": torch.from_numpy(inp["rep/b"]),
         "big": torch.from_numpy(np.random.default_rng(2).normal(
             size=(2048, 2048)).astype(np.float32))}
    with one_rank_mesh("cuda") as mesh:
        cpu = compressed_psum_tree(g, (), mesh)
        card = compressed_psum_tree({k: v.cuda() for k, v in g.items()}, (),
                                    mesh)
    for want, got in zip(cpu, card):
        for k in g:
            bits(got[k].cpu().numpy(), want[k].numpy(), k)


def _fail_on_rank_one(rank, world, how):
    """Rank 1 raises or hangs; rank 0 returns and waits for it."""
    import time

    if rank == 1:
        if how == "raises":
            raise ValueError("rank 1 fails on purpose")
        time.sleep(3600)
    return rank


@pytest.mark.parametrize("how", ("raises", "hangs"))
def test_run_ranks_fails_within_its_limit(how):
    """A rank that raises fails ``run_ranks`` with its error, and a rank
    that hangs fails it with ``TimeoutError`` once the limit has passed;
    either way within the limit (plus the stop), with no rank left
    running."""
    import multiprocessing
    import time

    limit = 120.0 if how == "raises" else 10.0
    t = time.monotonic()
    with pytest.raises(Exception) as info:
        run_ranks(_fail_on_rank_one, 2, how, backend="gloo",
                  timeout=limit)
    assert time.monotonic() - t < limit + 15
    if how == "raises":
        assert "rank 1 fails on purpose" in str(info.value)
    else:
        assert info.type is TimeoutError
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("entry", ("make_host_mesh", "run_ranks",
                                   "hosts_of_two"))
def test_cuda_world_larger_than_the_gpus_is_refused(monkeypatch, entry):
    """NCCL takes one rank per GPU: a mesh on ``cuda`` in a world of 4
    ranks on one host of 2 GPUs raises (never two ranks on one card), and
    so does ``run_ranks`` asked for 4 NCCL ranks (a stubbed GPU count and
    group, so it runs without a GPU).  Across hosts the rule is per host:
    with ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` set as torchrun sets them,
    rank 5 of 8 on hosts of 2 ranks takes ``cuda:1`` of its 2 GPUs, and 4
    ranks on such a host are refused."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    refused = "4 ranks on a host with 2 GPUs"
    if entry == "run_ranks":
        with pytest.raises(RuntimeError, match=refused):
            mesh_mod.run_ranks(_fail_on_rank_one, 4, "raises",
                               backend=mesh_mod.GPU_BACKEND)
        return
    monkeypatch.setattr(mesh_mod, "resolve_device", torch.device)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 3)
    if entry == "hosts_of_two":
        monkeypatch.setattr(dist, "get_world_size", lambda *a: 8)
        monkeypatch.setattr(dist, "get_rank", lambda *a: 5)
        monkeypatch.setenv("LOCAL_RANK", "1")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        assert mesh_mod.local_ranks() == (1, 2)
        assert mesh_mod.local_gpu(*mesh_mod.local_ranks()) == \
            torch.device("cuda", 1)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match=refused):
        mesh_mod.make_host_mesh(4, 1, device="cuda")


@pytest.mark.gpu
def test_cuda_multi_gpu_compressed_psum_equals_gloo():
    """One NCCL rank per GPU (4, or 2 on a 2- or 3-GPU host; skips with
    fewer) against as many gloo ranks on the CPU, on this module's inputs
    (the replicated leaves, each rank's own row of the distinct ones with
    its residual, and a 2048 x 2048 leaf), through ``chip_smoke.py``'s
    "dist4 collective" rank body (``dist_collective_pair``): every group
    on NCCL for CUDA tensors and gloo for CPU ones, int8 the only
    payload, means and residuals bit-equal rank for rank; the replicated
    means within the reference's 3 quantization steps of the input."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        pytest.skip("needs two CUDA devices (chip_smoke.py --dist on a "
                    "multi-GPU host)")
    import chip_smoke

    world = 4 if count >= 4 else 2
    inp = make_inputs()
    rep = {"w": inp["rep/w"], "b": inp["rep/b"],
           "big": np.random.default_rng(2).normal(
               size=(2048, 2048)).astype(np.float32)}
    own, ef = ({k: inp[f"dist/{e}{k}"] for k in ("w", "b")}
               for e in ("", "e"))
    cards, _ = chip_smoke.dist_collective_pair(world, "multi-GPU psum",
                                               (rep, own, ef))
    assert [c["device"] for c in cards] == [f"cuda:{r}"
                                            for r in range(world)]
    for card in cards:
        assert len([k for k in card if " mean " in k]) == 5
        for k, x in rep.items():
            scale = float(np.abs(x).max()) / 127.0
            got = card[f"replicated mean {k}"]
            assert float(np.abs(got - x).max()) <= 3 * scale
