"""The port's logical-axis rules, axes trees, abstract inputs and launch
shapes against the JAX package's.

``repro_torch.distributed.sharding`` resolves logical axes with the
reference's divisibility and duplicate-axis fallbacks: the six
``FakeMesh`` cases of ``tests/test_sharding.py`` give the same specs and
the same fallback strings.  ``Model.axes`` / ``Model.abstract``,
``params.logical_axes`` / ``abstract_params``,
``optimizer.state_logical_axes`` and ``train_step._opt_axes`` equal
JAX's trees leaf for leaf (a layer's parameter takes its stacked leaf
less the ``layers`` axis), for every config's ``SMOKE``;
``launch.shapes``' abstract inputs (``meta`` tensors) have JAX's shapes,
dtypes and axes for every (arch, shape), and ``applicable`` skips the
same eight.  ``train_step.tree_shardings``' DTensor placements cut every
parameter and optimizer leaf to the shard shape JAX's ``NamedSharding``
gives on a real (2, 4) mesh (one JAX subprocess with 8 host devices).
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_dist import finish_jax, start_jax
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.distributed.sharding import DEFAULT_RULES as JRULES
from repro.distributed.sharding import MeshRules as JMeshRules
from repro.launch import shapes as jshapes
from repro.models.layers import prefill_kv_cache as jprefill_kv_cache
from repro.models.model import Model as JModel
from repro.models.params import abstract_params as jabstract_params
from repro.models.params import logical_axes as jlogical_axes
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import state_logical_axes as jstate_axes
from repro.train.train_step import _opt_axes as jopt_axes
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (DEFAULT_RULES, MeshRules,
                                              current_rules, use_rules)
from repro_torch.kernels import ops
from repro_torch.launch import shapes
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import Model
from repro_torch.models.layers import prefill_kv_cache
from repro_torch.models.model import param_defs
from repro_torch.models.params import _tree_key, abstract_params, logical_axes
from repro_torch.train.optimizer import AdamWConfig, state_logical_axes
from repro_torch.train.train_step import _opt_axes, tree_shardings

ARCH_NAMES = list_archs()
OPT_CFGS = {"plain": {}, "ef": dict(error_feedback=True),
            "bf16": dict(error_feedback=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeMesh:
    """Just enough of a mesh for the resolvers (shape dict lookups)."""

    def __init__(self, shape):
        self.shape = shape


# (shape, logical, mesh shape): tests/test_sharding.py's six cases.
RESOLVE_CASES = {
    "divisible": ((64, 32), ("embed", "heads"), None),
    "indivisible": ((64, 7), ("embed", "heads"), None),
    "duplicate_axis": ((16, 64, 128), ("experts", "embed", "ff"), None),
    "missing_mesh_axis": ((32,), ("batch",), {"data": 4, "model": 8}),
    "multi_axis_batch": ((32, 128), ("batch", "seq"),
                         {"pod": 2, "data": 4, "model": 8}),
    "unknown_name": ((10,), ("no_such_axis",), None),
}


@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_resolve_matches_jax(case):
    shape, logical, mesh = RESOLVE_CASES[case]
    mesh = mesh or {"data": 4, "model": 8}
    got = MeshRules(FakeMesh(mesh), dict(DEFAULT_RULES))
    want = JMeshRules(FakeMesh(mesh), dict(JRULES))
    spec = got.resolve(shape, logical, case)
    assert tuple(spec) == tuple(want.resolve(shape, logical, case))
    assert got.fallbacks == want.fallbacks
    assert DEFAULT_RULES == JRULES


def test_use_rules_nests_and_is_thread_local():
    seen = {}

    def other():
        seen["thread"] = current_rules()

    assert current_rules() is None
    with use_rules(FakeMesh({"data": 2})) as outer:
        assert current_rules() is outer
        with use_rules(FakeMesh({"model": 4}), {"heads": None}) as inner:
            assert current_rules() is inner
            assert inner.rules["heads"] is None
            assert outer.rules["heads"] == "model"
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        assert current_rules() is outer
    assert current_rules() is None and seen["thread"] is None
    assert sharding.logical_sharding((4,), ("batch",)) is None
    x = torch.zeros(3)
    assert sharding.logical_constraint(x, "batch") is x


def same_axes(got, want_tree, model):
    """``got`` (by parameter name) against a reference tree (stacked
    layer leaves): a layer's parameter takes its leaf less ``layers``."""
    for name, _ in model.named_parameters():
        key, layer = _tree_key(name)
        w = want_tree
        for k in key:
            w = w[k]
        if layer is not None:
            assert w[0] == "layers", name
            w = w[1:]
        assert got[name] == tuple(w), name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_axes_and_abstract_params_match_jax(arch):
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    jm = JModel(jcfg)
    assert logical_axes(param_defs(cfg)) == jlogical_axes(jm.param_defs())
    abstract = abstract_params(param_defs(cfg), cfg.pdtype)
    jabs = jabstract_params(jm.param_defs(), jcfg.pdtype)
    want = dict(leaf_paths(jabs))
    assert {p for p, _ in leaf_paths(abstract)} == set(want)
    for path, a in leaf_paths(abstract):
        b = want[path]
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
    model = Model(cfg, device="meta")
    same_axes(model.axes(), jm.axes(), model)
    for name, t in model.abstract().items():
        p = dict(model.named_parameters())[name]
        assert t.device.type == "meta" and t.shape == p.shape, name
    for opt, kw in OPT_CFGS.items():
        low = opt == "bf16"
        ocfg, jocfg = AdamWConfig(**kw), JAdamWConfig(**kw)
        got = state_logical_axes(model.axes(), ocfg, low)
        want = jstate_axes(jm.axes(), jocfg, low)
        assert got.step == want.step == ()
        for f in ("m", "v", "master", "ef"):
            if getattr(want, f) == ():
                assert getattr(got, f) == (), (opt, f)
            else:
                same_axes(getattr(got, f), getattr(want, f), model)
        for zero1 in (False, True):
            got, want = _opt_axes(model, ocfg, zero1), jopt_axes(
                jm, jocfg, zero1)
            for f in ("m", "v", "master", "ef"):
                if getattr(want, f) == ():
                    assert getattr(got, f) == (), (opt, f, zero1)
                else:
                    same_axes(getattr(got, f), getattr(want, f), model)


def leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, prefix + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from leaf_paths(v, prefix + (k,))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_jax(arch):
    """Every assigned shape: the abstract batch, or the decode cache and
    tokens, with JAX's shapes, dtypes and axes; ``applicable`` skips
    long_500k for the eight full-attention archs, as JAX's does."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, spec in shapes.SHAPES.items():
        assert spec == shapes.ShapeSpec(**vars(jshapes.SHAPES[name]))
        ok, why = shapes.applicable(cfg, name)
        assert (ok, why) == jshapes.applicable(jcfg, name)
        if not ok:
            with pytest.raises(ValueError, match="sub-quadratic"):
                shapes.input_specs(cfg, name)
            continue
        got, got_axes = shapes.input_specs(cfg, name)
        want, want_axes = jshapes.input_specs(jcfg, name)
        g, w = list(leaf_paths(got)), list(leaf_paths(want))
        assert [p for p, _ in g] == [p for p, _ in w], name
        for (path, a), (_, b) in zip(g, w):
            assert a.device.type == "meta", path
            assert tuple(a.shape) == tuple(b.shape), (name, path)
            assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        assert axes_list(got_axes) == axes_list(want_axes), name


def axes_list(axes):
    if isinstance(axes, dict):
        return [(k, axes_list(v)) for k, v in axes.items()]
    if isinstance(axes, tuple) and hasattr(axes, "_fields"):
        return [(k, axes_list(v)) for k, v in zip(axes._fields, axes)]
    return axes


def test_prefill_kv_cache_matches_jax():
    cfg = get_smoke("olmo-1b")
    rng = np.random.default_rng(0)
    k = rng.normal(size=(2, 5, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    got = prefill_kv_cache(cfg, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(pos))
    want = jprefill_kv_cache(jget_smoke("olmo-1b"), jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(pos))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_backend_names(monkeypatch):
    """``default_backend`` / ``set_backend`` / ``get_backend`` over the
    port's "ref" | "cuda": the environment override read and validated
    as in the reference, else the tensor's device; an explicit per-call
    backend still wins, and "cuda" on a CPU tensor raises."""
    x = torch.zeros(3)
    monkeypatch.delenv("REPRO_KERNEL_BACKEND", raising=False)
    assert ops.default_backend(x) == ops.get_backend(x) == "ref"
    assert ops.default_backend(torch.device("cuda")) == "cuda"
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "pallas")
    with pytest.raises(ValueError, match="REPRO_KERNEL_BACKEND"):
        ops.default_backend(x)
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "cuda")
    assert ops.get_backend(x) == "cuda"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.resolve_backend(None, x)
    assert ops.resolve_backend("ref", x) == "ref"
    monkeypatch.delenv("REPRO_KERNEL_BACKEND")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.set_backend("interpret")
    try:
        ops.set_backend("cuda")
        assert ops.get_backend(x) == "cuda"
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.resolve_backend(None, x)
    finally:
        ops.set_backend(None)
    assert ops.get_backend(x) == "ref"


def test_meshes_need_ranks():
    """Without a process group, a mesh raises; the production meshes need
    256 / 512 ranks, as the reference's need that many devices."""
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(1, 1, device="cpu")
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks, found 1"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")


SHARD_CODE = """
import numpy as np, jax
from jax.sharding import AxisType
from repro.configs import get_smoke
from repro.distributed.sharding import use_rules
from repro.models.model import Model
from repro.train.optimizer import AdamWConfig, init_state
from repro.train.train_step import _opt_axes, tree_shardings
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
res = {}
for arch in ARCHS:
    m = Model(get_smoke(arch))
    ocfg = AdamWConfig(error_feedback=True)
    for zero1 in (False, True):
        with use_rules(mesh, {"embed": None} if zero1 else None) as rules:
            structs = m.abstract()
            opt = jax.eval_shape(lambda p: init_state(ocfg, p), structs)
            trees = (("params", structs, m.axes()),
                     ("opt", opt, _opt_axes(m, ocfg, zero1)))
            for what, s, ax in trees:
                sh = tree_shardings(rules, s, ax)
                flat_s = jax.tree_util.tree_leaves_with_path(s)
                flat_h = jax.tree.leaves(sh)
                for (path, st), shd in zip(flat_s, flat_h):
                    key = "/".join(str(getattr(k, "key", getattr(k, "name",
                                   getattr(k, "idx", k)))) for k in path)
                    res[f"{arch}/{zero1}/{what}/{key}"] = np.asarray(
                        shd.shard_shape(st.shape))
np.savez(OUT, **res)
"""


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("shards") / "jax.npz")
    return finish_jax(start_jax(f"ARCHS = {ARCH_NAMES!r}\n" + SHARD_CODE,
                                8, out), out)


def local_shape(shape, placements, mesh_shape):
    out = list(shape)
    for p, n in zip(placements, mesh_shape.values()):
        if p.is_shard():
            out[p.dim] //= n
    return tuple(out)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_tree_shardings_cut_as_jax(arch, jax_shards):
    """Parameters and the AdamW state (residuals included; plain and
    ZeRO-1, whose rules replicate ``embed``) on a (2, 4) ("data",
    "model") mesh: each leaf's placements cut it to JAX's shard shape."""
    mesh = FakeMesh({"data": 2, "model": 4})
    model = Model(get_smoke(arch), device="meta")
    ocfg = AdamWConfig(error_feedback=True)
    structs = model.abstract()
    opt = type(_opt_axes(model, ocfg))(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        m=structs, v=structs, master=(), ef=structs)
    for zero1 in (False, True):
        with use_rules(mesh, {"embed": None} if zero1 else None) as rules:
            for what, s, ax in (("params", structs, model.axes()),
                                ("opt", opt, _opt_axes(model, ocfg, zero1))):
                sh = tree_shardings(rules, s, ax)
                for path, t in leaf_paths(s):
                    got = local_shape(t.shape, get(sh, path), mesh.shape)
                    if path == ("step",):
                        key, layer = ("step",), None
                    else:
                        key, layer = _tree_key(path[-1])
                        key = path[:-1] + key
                    want = jax_shards[f"{arch}/{zero1}/{what}/"
                                      + "/".join(key)]
                    if layer is not None:
                        want = want[1:]
                    assert got == tuple(want), (arch, zero1, path)


def get(tree, path):
    for k in path:
        tree = getattr(tree, k) if hasattr(tree, "_fields") else tree[k]
    return tree
