"""The dry-run's lowering (``train.train_step.lower_train_step`` /
``lower_serve_step``) and ``launch.dryrun`` against the JAX package's.

One JAX subprocess (8 host devices, a (2, 4) ("data", "model") mesh)
lowers the reference's steps for the ``SMOKE`` configs of olmo-1b,
deepseek-moe-16b, zamba2-1.2b and mamba2-1.3b in bf16 -- train (plain,
``zero1``, ``compressed_grads``) on the reference test's "t" shape (8 x
64), prefill on a "p" shape (8 x 64) and decode on "d" -- and resolves
the full configs' trees on the two production meshes.  Eight spawned
gloo ranks on a (2, 4) mesh record what the port's own collectives put
on the wire.  Held exactly:

* argument, output and alias bytes of each lowered step equal the sums
  of JAX's ``NamedSharding.shard_shape`` bytes over the same trees
  (arguments: parameters, optimizer state and batch, or cache and
  tokens; outputs: parameters and optimizer state, or the last
  position's logits and the cache; donated outputs alias);
* ``fallbacks`` equal JAX's, string for string, on the smoke cells
  (after lowering) and on all 10 archs x 4 shapes x 2 production meshes
  (``MeshRules.resolve`` over the same leaves in the same order), with
  the eight ``long_500k`` skips equal;
* ``params``, ``active_params`` and ``model_flops`` equal the reference's
  formulas on every cell;
* the compressed all-reduce's bytes (int8 all-to-all and all-gather, the
  f32 scale maxima) and expert parallelism's all-to-all bytes equal the
  output bytes the gloo ranks hand to ``torch.distributed``;
* ``unroll_layers`` changes neither the forward, the loss nor the FLOP
  count; flash attention counts the same FLOPs at ``attn_kv_block`` and
  twice it (the reference's flash correction is 0); the SSD count is
  linear in the chunk size (the reference's quadratic fit finds no
  loop-body term).

Stated bands, measured on two smoke train cells and pinned (``BANDS``):
the port's per-rank FLOPs over XLA's per-device ``flops``
(FlopCounterMode counts matrix products only), and the port's total
collective bytes over XLA's HLO total.  One full-size
cell (olmo-1b / train_4k, single pod) runs through ``run_cell``.
"""

import json

import numpy as np
import pytest
import torch

from _torch_dist import finish_jax, run_ranks, start_jax
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.launch import dryrun, shapes as SL
from repro_torch.launch.cost import flop_count
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (ShapeMesh, lower_serve_step,
                                          lower_train_step)

WORLD, MESH = 8, {"data": 2, "model": 4}
ARCHS = ("olmo-1b", "deepseek-moe-16b", "zamba2-1.2b", "mamba2-1.3b")
# (case name, shape, lower_train_step keywords or None for serving)
CASES = (("train", "t", {}), ("zero1", "t", {"zero1": True}),
         ("compressed", "t", {"compressed_grads": True}),
         ("prefill", "p", None), ("decode", "d", None))
# Bands per cell, pinned around the ratios measured here: FLOPs over
# XLA's 0.7543 (olmo) and 0.3846 (deepseek-moe: XLA also counts the
# elementwise work of the MoE dispatch); collective bytes over XLA's HLO
# total 0.1779 and 0.1621.
BANDS = {("olmo-1b", "train"): ((0.72, 0.79), (0.16, 0.20)),
         ("deepseek-moe-16b", "train"): ((0.36, 0.41), (0.14, 0.18))}
BAND_CELLS = tuple(BANDS)
SHAPES = {"t": SL.ShapeSpec("t", "train", 64, 8),
          "p": SL.ShapeSpec("p", "prefill", 64, 8),
          "d": SL.ShapeSpec("d", "decode", 64, 8)}

JAX_CODE = """
import json, math
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs import get_config, get_smoke, list_archs
from repro.distributed.sharding import DEFAULT_RULES, MeshRules, use_rules
from repro.launch import shapes as SL
from repro.launch.dryrun import collective_bytes, memory_stats
from repro.models.model import Model
from repro.train.optimizer import AdamWConfig, init_state
from repro.train.train_step import (_opt_axes, lower_serve_step,
                                    lower_train_step, tree_shardings)

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
for name, (kind, seq, batch) in SHAPES.items():
    SL.SHAPES[name] = SL.ShapeSpec(name, kind, seq, batch)
res = {}
OPT = AdamWConfig(total_steps=10000)


def nbytes(structs, shardings):
    return int(sum(jax.tree.leaves(jax.tree.map(
        lambda s, sh: math.prod(sh.shard_shape(s.shape)) * s.dtype.itemsize,
        structs, shardings, is_leaf=lambda x: hasattr(x, "shape")))))


for arch in ARCHS:
    cfg = get_smoke(arch).with_(param_dtype="bf16", dtype="bf16")
    model = Model(cfg, remat="full", unroll_layers=True)
    params = model.abstract()
    for case, shape, kw in CASES:
        key = f"{arch}/{case}"
        if kw is not None:
            # The compressed step carries its residuals in the state.
            opt_cfg = AdamWConfig(total_steps=10000, error_feedback=bool(
                kw.get("compressed_grads")))
            lowered, rules = lower_train_step(model, opt_cfg, mesh, shape,
                                              **kw)
            over = {"embed": None} if kw.get("zero1") else None
            with use_rules(mesh, over) as r:
                opt = jax.eval_shape(lambda p: init_state(opt_cfg, p),
                                     params)
                batch, b_axes = SL.input_specs(cfg, shape)
                ps = nbytes(params, tree_shardings(r, params, model.axes()))
                os_ = nbytes(opt, tree_shardings(
                    r, opt, _opt_axes(model, opt_cfg,
                                      zero1=kw.get("zero1", False))))
                bs = nbytes(batch, tree_shardings(r, batch, b_axes))
            mem = (ps + os_ + bs, ps + os_, ps + os_)
        else:
            lowered, rules = lower_serve_step(model, mesh, shape)
            spec = SL.SHAPES[shape]
            with use_rules(mesh) as r:
                ps = nbytes(params, tree_shardings(r, params, model.axes()))
                lg = jax.ShapeDtypeStruct((spec.global_batch, 1, cfg.vocab),
                                          cfg.adtype)
                ls = nbytes(lg, tree_shardings(r, lg,
                                               ("batch", None, "vocab")))
                if spec.kind == "prefill":
                    batch, b_axes = SL.input_specs(cfg, shape)
                    cache, c_axes = SL.cache_specs(cfg, spec.global_batch,
                                                   spec.seq)
                    bs = nbytes(batch, tree_shardings(r, batch, b_axes))
                    cs = nbytes(cache, tree_shardings(r, cache, c_axes))
                    mem = (ps + bs, ls + cs, 0)
                else:
                    (cache, tok), (c_axes, t_axes) = SL.input_specs(cfg,
                                                                    shape)
                    cs = nbytes(cache, tree_shardings(r, cache, c_axes))
                    ts = nbytes(tok, tree_shardings(r, tok, t_axes))
                    mem = (ps + cs + ts, ls + cs, cs)
        res[key + "/mem"] = np.array(mem, dtype=np.int64)
        res[key + "/fallbacks"] = np.array(json.dumps(rules.fallbacks))
        if (arch, case) in BAND_CELLS:
            compiled = lowered.compile()
            res[key + "/flops"] = np.float64(compiled.cost_analysis()["flops"])
            res[key + "/coll"] = np.float64(sum(collective_bytes(
                compiled.as_text()).values()))
            res[key + "/xla_args"] = np.int64(memory_stats(compiled)[
                "argument_size_in_bytes"])


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def resolved(rules, structs, axes):
    jax.tree.map(lambda s, ax: None if ax in ((), None) else
                 rules.resolve(s.shape, ax, tag=str(ax)),
                 structs, axes, is_leaf=lambda x: hasattr(x, "shape"))


full = {}
for arch in list_archs():
    cfg = get_config(arch, param_dtype="bf16", dtype="bf16")
    model = Model(cfg)
    params = model.abstract()
    full[f"{arch}/params"] = [cfg.param_count(), cfg.active_param_count()]
    for shape, spec in list(SL.SHAPES.items())[:4]:
        ok, why = SL.applicable(cfg, shape)
        for mname, mshape in (("single", {"data": 16, "model": 16}),
                              ("multi", {"pod": 2, "data": 16,
                                         "model": 16})):
            key = f"{arch}/{shape}/{mname}"
            if not ok:
                full[key] = ["skipped", why]
                continue
            rules = MeshRules(mesh=FakeMesh(mshape), rules=dict(DEFAULT_RULES))
            resolved(rules, params, model.axes())
            if spec.kind == "train":
                opt = jax.eval_shape(lambda p: init_state(OPT, p), params)
                resolved(rules, opt, _opt_axes(model, OPT))
                resolved(rules, *SL.input_specs(cfg, shape))
            elif spec.kind == "prefill":
                resolved(rules, *SL.input_specs(cfg, shape))
            else:
                (cache, tok), (c_axes, t_axes) = SL.input_specs(cfg, shape)
                resolved(rules, cache, c_axes)
                resolved(rules, tok, t_axes)
            full[key] = rules.fallbacks
res["full"] = np.array(json.dumps(full))
np.savez(OUT, **res)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _shapes(monkeypatch):
    for name, spec in SHAPES.items():
        monkeypatch.setitem(SL.SHAPES, name, spec)


def smoke(arch, dtype="bf16"):
    return get_smoke(arch).with_(param_dtype=dtype, dtype=dtype)


def lower(arch, case, dtype="bf16", mesh=MESH, remat="full"):
    _, shape, kw = next(c for c in CASES if c[0] == case)
    model = Model(smoke(arch, dtype), device="meta", remat=remat)
    if kw is None:
        return lower_serve_step(model, ShapeMesh(mesh), shape)
    opt_cfg = AdamWConfig(total_steps=10000, error_feedback=bool(
        kw.get("compressed_grads")))
    return lower_train_step(model, opt_cfg, ShapeMesh(mesh), shape, **kw)


def recording_collectives(log):
    """Patches ``torch.distributed``'s all_to_all_single,
    all_gather_into_tensor and all_reduce to add each call's output
    bytes to ``log`` by the reference's kind names."""
    import torch.distributed as dist

    kinds = {"all_to_all_single": "all-to-all",
             "all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce"}
    real = {n: getattr(dist, n) for n in kinds}

    def wrap(name):
        def call(out, *a, **kw):
            log[kinds[name]] = log.get(kinds[name], 0) + \
                out.numel() * out.element_size()
            return real[name](out, *a, **kw)
        return call
    for n in kinds:
        setattr(dist, n, wrap(n))
    return lambda: [setattr(dist, n, f) for n, f in real.items()]


def rank_main(rank, world):
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.optimizer import init_state
    from repro_torch.train.train_step import make_train_step

    for name, spec in SHAPES.items():
        SL.SHAPES[name] = spec
    mesh = make_host_mesh(MESH["data"], MESH["model"], device="cpu")
    rng = np.random.default_rng(0)
    out = {}
    for arch, compressed in (("olmo-1b", True), ("deepseek-moe-16b", False)):
        cfg = smoke(arch, "f32")
        model = Model(cfg, device="cpu", remat="full").init(
            torch.Generator().manual_seed(0))
        opt_cfg = AdamWConfig(total_steps=10000, error_feedback=compressed)
        state = init_state(opt_cfg, dict(model.named_parameters()))
        tok = rng.integers(0, cfg.vocab, (8, 65))
        batch = {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
                 "labels": torch.from_numpy(tok[:, 1:].astype(np.int32))}
        step = make_train_step(model, opt_cfg, compressed_grads=compressed,
                               mesh=mesh)
        log = {}
        undo = recording_collectives(log)
        try:
            if compressed:
                step(model, state, batch)
            else:
                with use_rules(mesh):
                    step(model, state, batch)
        finally:
            undo()
        out[arch] = log
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "jax.npz")
    shapes = {k: (v.kind, v.seq, v.global_batch) for k, v in SHAPES.items()}
    proc = start_jax(f"ARCHS = {ARCHS!r}\nCASES = {CASES!r}\n"
                     f"SHAPES = {shapes!r}\nBAND_CELLS = {BAND_CELLS!r}\n"
                     + JAX_CODE, WORLD, out)
    try:
        ranks = run_ranks(rank_main, WORLD)
        cell = dryrun.run_cell("olmo-1b", "train_4k", False)
    finally:
        want = finish_jax(proc, out)
    return ranks, cell, want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_lowered_bytes_and_fallbacks_equal_jax(runs, arch, case):
    want = runs[2]
    lowered, rules = lower(arch, case)
    mem = lowered.memory_analysis()
    got = [mem["argument_size_in_bytes"], mem["output_size_in_bytes"],
           mem["alias_size_in_bytes"]]
    assert got == want[f"{arch}/{case}/mem"].tolist()
    assert rules.fallbacks == json.loads(str(want[f"{arch}/{case}/fallbacks"]))
    assert mem["temp_size_in_bytes"] > 0
    if (arch, case) in BAND_CELLS:
        print(f"{arch} {case}: argument bytes {got[0]} (shard sum) vs XLA "
              f"{int(want[f'{arch}/{case}/xla_args'])}")


@pytest.mark.parametrize("arch,case", BAND_CELLS)
def test_flops_and_collectives_within_their_bands(runs, arch, case):
    want = runs[2]
    lowered, _ = lower(arch, case)
    flops = lowered.cost_analysis()["flops"] / float(
        want[f"{arch}/{case}/flops"])
    coll = sum(lowered.collectives().values()) / float(
        want[f"{arch}/{case}/coll"])
    print(f"{arch} {case}: FLOPs / XLA {flops:.4f}, collective bytes / XLA "
          f"{coll:.4f}")
    (f_lo, f_hi), (c_lo, c_hi) = BANDS[(arch, case)]
    assert f_lo <= flops <= f_hi
    assert c_lo <= coll <= c_hi


def test_full_config_fallbacks_and_skips_equal_jax(runs):
    full = json.loads(str(runs[2]["full"]))
    n_ok = n_skip = 0
    for arch in list_archs():
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            for multi in (False, True):
                want = full[f"{arch}/{shape}/{'multi' if multi else 'single'}"]
                cfg = get_config(arch, param_dtype="bf16", dtype="bf16")
                ok, why = SL.applicable(cfg, shape)
                if not ok:
                    assert want == ["skipped", why]
                    n_skip += 1
                    continue
                model = Model(cfg, device="meta")
                mesh = ShapeMesh(production_mesh_shape(multi))
                if SL.SHAPES[shape].kind == "train":
                    _, rules = lower_train_step(
                        model, AdamWConfig(total_steps=10000), mesh, shape)
                else:
                    _, rules = lower_serve_step(model, mesh, shape)
                assert rules.fallbacks == want, (arch, shape, multi)
                n_ok += 1
    assert (n_ok, n_skip) == (64, 16)


def test_model_flops_and_params_equal_the_reference(runs):
    full = json.loads(str(runs[2]["full"]))
    for arch in list_archs():
        cfg = get_config(arch, param_dtype="bf16", dtype="bf16")
        n, active = full[f"{arch}/params"]
        assert (cfg.param_count(), cfg.active_param_count()) == (n, active)
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            spec = SL.SHAPES[shape]
            tokens = spec.global_batch * (spec.seq if spec.kind != "decode"
                                          else 1)
            mult = 6 if spec.kind == "train" else 2
            assert dryrun.model_flops(cfg, spec) == mult * active * tokens


def test_port_collectives_equal_the_bytes_on_the_wire(runs):
    ranks = runs[0]
    for log in ranks:
        assert log == ranks[0]
    compressed, _ = lower("olmo-1b", "compressed", dtype="f32")
    assert compressed.exact_collectives() == ranks[0]["olmo-1b"]
    ep, _ = lower("deepseek-moe-16b", "train", dtype="f32")
    assert ep.exact_collectives() == {
        "all-to-all": ranks[0]["deepseek-moe-16b"]["all-to-all"]}


def test_full_size_cell_has_the_reference_keys(runs):
    cell = runs[1]
    assert cell["status"] == "ok", cell.get("error")
    keys = {"arch", "shape", "mesh", "status", "n_chips", "t_compile_s",
            "hlo_flops", "hlo_bytes", "collectives", "collective_bytes",
            "corrections", "memory", "fallbacks", "params", "active_params",
            "model_flops", "useful_flops_ratio", "compute_s", "memory_s",
            "collective_s", "dominant", "fits"}
    assert set(cell) == keys
    assert cell["n_chips"] == 256 and cell["corrections"] == {}
    assert cell["params"] == cell["active_params"] == 1279854592
    assert set(cell["memory"]) == {"argument_size_in_bytes",
                                   "output_size_in_bytes",
                                   "temp_size_in_bytes",
                                   "alias_size_in_bytes"}
    assert cell["fits"] == (cell["memory"]["argument_size_in_bytes"]
                            + cell["memory"]["temp_size_in_bytes"]
                            <= dryrun.HBM_BYTES)


def loss_and_flops(cfg, unroll, batch):
    model = Model(cfg, device="cpu", remat="none",
                  unroll_layers=unroll).init(torch.Generator().manual_seed(0))
    logits, _ = model.forward(batch)
    loss, _ = model.loss(batch)
    meta = Model(cfg, device="meta", remat="full", unroll_layers=unroll)
    mb = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
          for k, v in batch.items()}
    return logits, loss, flop_count(lambda: meta.loss(mb)[0].backward())


def token_batch(cfg, b, s):
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(tok[:, 1:].astype(np.int32))}


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b"])
def test_unroll_layers_changes_nothing(arch):
    cfg = get_smoke(arch)
    batch = token_batch(cfg, 2, 32)
    a, b = (loss_and_flops(cfg, u, batch) for u in (False, True))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[2] == b[2] > 0


def test_flash_counts_every_kv_block():
    """A flash cell (S > attn_direct_max) counts the same FLOPs at
    ``attn_kv_block`` and twice it: the reference's probe correction,
    (probe - main) / blk * (T - blk), is 0."""
    cfg = get_smoke("olmo-1b").with_(attn_direct_max=16, attn_kv_block=16)
    batch = token_batch(cfg, 2, 64)
    blk = cfg.attn_kv_block
    main = loss_and_flops(cfg, True, batch)[2]
    probe = loss_and_flops(cfg.with_(attn_kv_block=2 * blk), True, batch)[2]
    assert (probe - main) / blk * (64 - blk) == 0.0


def test_ssd_count_is_linear_in_the_chunk():
    """The port counts every SSD chunk, so its count at chunk q is
    base + a S q + b S, linear in q: the reference's fit over q, 2q, 4q
    (``dryrun.py:253-262``) finds a quadratic coefficient of 0 (to f64
    rounding).  The reference's correction assumes a count that holds
    one chunk's body, so it is not applied (``corrections`` is {})."""
    cfg = get_smoke("mamba2-1.3b")
    batch = token_batch(cfg, 2, 128)
    q1 = 16
    f1, f2, f3 = (float(loss_and_flops(cfg.with_(ssm_chunk=q), True,
                                       batch)[2]) for q in (q1, 2 * q1,
                                                            4 * q1))
    a = (f3 - 3 * f2 + 2 * f1) / (6 * q1 * q1)
    assert abs(a) <= 1e-12 * f1
    assert f2 > f1
