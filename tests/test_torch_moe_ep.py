"""The port's expert-parallel MoE on 2 x 4 gloo ranks against the dense
path of both packages.

``repro_torch.models.moe.moe_ffn`` under ``use_rules(mesh)`` on a
("data", "model") = (2, 4) mesh of gloo ranks (spawned once for the
module) runs the expert-parallel path: each rank routes its data
shard's tokens, two ``all_to_all_single``s over its ``model`` group
carry them to their expert's owner and back, and the outputs are
gathered over ``data``.  The dense path of the port (in this process)
and of the JAX package (one subprocess, jitted) see the same ``SMOKE``
deepseek-moe weights (E = 8 experts, top-2) and the same (4, 8, 64)
input, made with numpy.  Bounds are the reference test's
(``tests/test_moe_ep.py``): forward within 1e-4, per-expert load within
1e-3, aux within 0.05 (the EP aux is the mean of the data shards' local
estimates), and every rank's gradient of ``sum(y ** 2)`` within 2e-3 --
with and without ``moe_seq_shard`` and an ``expert_perm``.  Where the
reference falls back to dense (``E % model != 0``, ``B % n_dp != 0``),
so does the port, and its output equals the dense path's bit for bit.

The same spawn of 8 ranks also builds the two 4-rank meshes of the
cards, ("data", "model") = (1, 4) and (2, 2), over its first four ranks
(the other four hold no coordinate and skip), and runs every case there;
the JAX subprocess runs the reference's ``moe_ffn`` on the same two
meshes of its first four host devices.  Which cases go expert parallel
follows the mesh (``E % model``, ``B % data``); each is held to JAX's
run on its mesh and, unless a shard's capacity drops other assignments
than the whole batch's (``DROPS_DIFFER``), to both dense paths.  The
``gpu`` test runs the cases on one NCCL rank per GPU against as many
gloo ranks.
"""

import numpy as np
import pytest
import torch

from _torch_dist import (finish_jax, flat, nest, one_rank_mesh, run_ranks,
                         start_jax)
from repro_torch.configs import get_smoke
from repro_torch.models.moe import _moe_ffn_dense, moe_defs
from repro_torch.models.params import init_scale

WORLD, MESH = 8, (2, 4)
# (name, seq_shard, expert_perm, n_experts, batch, expert-parallel?)
CASES = (
    ("plain", False, False, 8, 4, True),
    ("seq_shard", True, False, 8, 4, True),
    ("perm", False, True, 8, 4, True),
    ("seq_shard_perm", True, True, 8, 4, True),
    ("experts_6", False, False, 6, 4, False),     # 6 % 4 != 0
    ("batch_3", False, False, 8, 3, False),       # 3 % 2 != 0
)
FWD_TOL, LOAD_TOL, AUX_TOL, GRAD_TOL = 1e-4, 1e-3, 0.05, 2e-3
# The cards' meshes: 4 ranks, one per GPU.
FOUR_RANK_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# A data shard routes with its own capacity (the reference's EP: per-shard
# T); at (2, 2) with 6 experts that is 8 slots per expert against 16 for
# the global batch, and the shards drop assignments the dense path keeps.
DROPS_DIFFER = {("2x2", "experts_6")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def case_config(n_experts, seq_shard):
    return get_smoke("deepseek-moe-16b").with_(n_experts=n_experts,
                                               moe_seq_shard=seq_shard)


def make_inputs():
    inp = {}
    for e in (8, 6):
        rng = np.random.default_rng(e)

        def walk(defs):
            return {k: walk(v) if isinstance(v, dict) else
                    (rng.normal(size=v.shape) * init_scale(v)).astype(
                        np.float32) for k, v in defs.items()}
        for k, v in flat(walk(moe_defs(case_config(e, False)))).items():
            inp[f"p{e}/{k}"] = v
    rng = np.random.default_rng(0)
    cfg = case_config(8, False)
    inp["x"] = rng.normal(size=(4, 8, cfg.d_model)).astype(np.float32)
    inp["perm"] = rng.permutation(8).astype(np.int32)
    return inp


JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke
from repro.models.moe import _moe_ffn_dense
inp = dict(np.load(IN))
res = {}

def tree(prefix):
    out = {}
    for key, v in inp.items():
        if key.startswith(prefix):
            node = out
            parts = key[len(prefix):].split("/")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = jnp.asarray(v)
    return out

for name, _, use_perm, e, b, _ in CASES:
    cfg = get_smoke("deepseek-moe-16b").with_(n_experts=e)
    p = tree(f"p{e}/")
    x = jnp.asarray(inp["x"][:b])
    perm = jnp.asarray(inp["perm"]) if use_perm else None
    fwd = jax.jit(lambda x_, p_: _moe_ffn_dense(x_, p_, cfg, perm))
    y, aux, load = fwd(x, p)
    g = jax.jit(jax.grad(lambda p_: jnp.sum(fwd(x, p_)[0] ** 2)))(p)
    res[f"{name}/y"], res[f"{name}/aux"] = np.asarray(y), np.asarray(aux)
    res[f"{name}/load"] = np.asarray(load)

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + "/" + k)
            else:
                res[prefix + "/" + k] = np.asarray(v)
    walk(g, f"{name}/grad")

# The reference's own path on the cards' 4-device meshes (the first four
# of the 8 host devices): expert parallel where it takes it.
from jax.sharding import AxisType
from repro.distributed.sharding import use_rules
from repro.models.moe import moe_ffn
for tag, shape in MESHES.items():
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    for name, seq_shard, use_perm, e, b, _ in CASES:
        cfg = get_smoke("deepseek-moe-16b").with_(n_experts=e,
                                                  moe_seq_shard=seq_shard)
        p = tree(f"p{e}/")
        x = jnp.asarray(inp["x"][:b])
        perm = jnp.asarray(inp["perm"]) if use_perm else None

        def fwd(x_, p_):
            with use_rules(mesh):
                return moe_ffn(x_, p_, cfg, perm)
        with mesh:
            y, aux, load = jax.jit(fwd)(x, p)
            g = jax.jit(jax.grad(lambda p_: jnp.sum(fwd(x, p_)[0] ** 2)))(p)
        key = f"{tag}/{name}"
        res[f"{key}/y"], res[f"{key}/aux"] = np.asarray(y), np.asarray(aux)
        res[f"{key}/load"] = np.asarray(load)
        walk(g, f"{key}/grad")
np.savez(OUT, **res)
"""


def leaves(p, prefix=""):
    for k, v in p.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def run_case(inp, name, seq_shard, use_perm, e, b, mesh=None,
             device="cpu"):
    """One case's (y, aux, load, {leaf: grad of sum(y ** 2)}) through
    ``moe_ffn`` (under the rules of ``mesh`` if given) or the dense
    path, on ``device``; numpy out."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models.moe import moe_ffn

    cfg = case_config(e, seq_shard)
    p = nest({k[len(f"p{e}/"):]:
              torch.from_numpy(v).to(device).requires_grad_()
              for k, v in inp.items() if k.startswith(f"p{e}/")})
    x = torch.from_numpy(inp["x"][:b]).to(device)
    perm = (torch.from_numpy(inp["perm"]).to(device) if use_perm
            else None)
    if mesh is None:
        y, aux, load = _moe_ffn_dense(x, p, cfg, perm)
    else:
        with use_rules(mesh):
            y, aux, load = moe_ffn(x, p, cfg, perm)
    names, params = zip(*leaves(p))
    grads = torch.autograd.grad((y ** 2).sum(), params)
    return (y.detach().cpu().numpy(), float(aux), load.cpu().numpy(),
            {n: g.cpu().numpy() for n, g in zip(names, grads)})


def rank_main(rank, world, in_path, meshes, device="cpu", dense=False):
    """One rank on ``device`` (the CPU over gloo, or its card over NCCL):
    every case on each mesh of ``meshes`` ({tag: (data, model)}; a rank
    off a mesh holds no coordinate there and skips it), with the path
    ``moe_ffn`` took, and with ``dense`` every case on the dense path on
    ``device`` too.  numpy out."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    inp = dict(np.load(in_path))
    taken = []
    real = {f: getattr(moe, f) for f in ("_moe_ffn_ep", "_moe_ffn_dense")}

    def recording(f):
        def call(*a, **kw):
            taken.append(f)
            return real[f](*a, **kw)
        return call

    for f in real:
        setattr(moe, f, recording(f))
    res = {}
    if dense:
        res["dense"] = {c[0]: run_case(inp, *c[:5], device=device)
                        for c in CASES}
    for tag, shape in meshes.items():
        mesh = make_host_mesh(*shape, device=device)
        res[f"{tag}/coordinate"] = mesh.coordinate
        if mesh.coordinate is None:
            continue
        for name, seq_shard, use_perm, e, b, _ in CASES:
            del taken[:]
            res[f"{tag}/{name}"] = run_case(inp, name, seq_shard, use_perm,
                                            e, b, mesh, device=mesh.device)
            res[f"{tag}/{name}/path"] = list(taken)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    in_path, out = str(d / "inputs.npz"), str(d / "jax.npz")
    inp = make_inputs()
    np.savez(in_path, **inp)
    proc = start_jax(f"IN = {in_path!r}\nCASES = {CASES!r}\n"
                     f"MESHES = {FOUR_RANK_MESHES!r}\n" + JAX_CODE, WORLD, out)
    try:
        ranks = run_ranks(rank_main, WORLD, in_path,
                          {"2x4": MESH, **FOUR_RANK_MESHES}, backend="gloo")
    finally:
        want = finish_jax(proc, out)
    dense = {c[0]: run_case(inp, *c[:5]) for c in CASES}
    return ranks, dense, want


def refs_of(dense, want, name, prefix=None):
    """(y, aux, load, {leaf: grad}) of case ``name``: the port's dense path
    and JAX's (``prefix`` None) or JAX's on the mesh ``prefix``."""
    grads = dense[name][3]
    key = name if prefix is None else f"{prefix}/{name}"
    jax_ref = (want[f"{key}/y"], float(want[f"{key}/aux"]),
               want[f"{key}/load"],
               {k: want[f"{key}/grad/{k}"] for k in grads})
    return [jax_ref] if prefix else [dense[name], jax_ref]


def check_against(ranks, refs, dense_y, ep, key):
    """Every rank's output, load, aux and gradients (``res[key]``) against
    each of ``refs``, at the reference's bounds; the path taken is the
    reference's (EP under its condition, else dense, whose output then
    equals the port's dense path ``dense_y`` bit for bit)."""
    for r, res in enumerate(ranks):
        y, aux, load, grads = res[key]
        path = res[f"{key}/path"]
        assert path == (["_moe_ffn_ep"] if ep else ["_moe_ffn_dense"]), \
            (r, path)
        if not ep:
            assert np.array_equal(y, dense_y), r
        for ref_y, ref_aux, ref_load, ref in refs:
            assert float(np.abs(y - ref_y).max()) < FWD_TOL, (r, key)
            assert np.allclose(load, ref_load, atol=LOAD_TOL), (r, load)
            assert abs(aux - ref_aux) < AUX_TOL, (r, aux, ref_aux)
            for k, g in grads.items():
                err = float(np.abs(g - ref[k]).max())
                assert err < GRAD_TOL, (r, key, k, err)


def check_ranks_agree(ranks, key):
    y0, aux0, load0, g0 = ranks[0][key]
    for res in ranks[1:]:
        y, aux, load, g = res[key]
        assert np.array_equal(y, y0) and aux == aux0, key
        assert np.array_equal(load, load0), key
        assert all(np.array_equal(g[k], g0[k]) for k in g0), key


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_on_the_mesh_matches_dense(runs, case):
    """Every rank of the 2 x 4 mesh against the dense paths
    (``check_against``)."""
    ranks, dense, want = runs
    name = case[0]
    assert float(np.abs(dense[name][0] - want[f"{name}/y"]).max()) <= FWD_TOL
    check_against(ranks, refs_of(dense, want, name), dense[name][0],
                  case[5], f"2x4/{name}")


def test_ranks_agree_bit_for_bit(runs):
    """The mesh's ranks are one replicated computation: outputs, aux, load
    and gradients equal on every rank, and every (data, model) coordinate
    of the 2 x 4 mesh present once."""
    ranks, _, _ = runs
    coords = sorted(tuple(r["2x4/coordinate"].values()) for r in ranks)
    assert coords == [(d, m) for d in range(MESH[0]) for m in range(MESH[1])]
    for name, *_ in CASES:
        check_ranks_agree(ranks, f"2x4/{name}")


def takes_ep(shape, n_experts, batch):
    """Whether the reference runs expert parallel on a (data, model)
    mesh of ``shape``."""
    data, model = shape
    return model > 1 and n_experts % model == 0 and batch % data == 0


@pytest.mark.parametrize("tag", FOUR_RANK_MESHES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_on_four_rank_meshes_matches_dense(runs, case, tag):
    """The cards' 4-rank meshes, (1, 4) and (2, 2), over ranks 0-3, on the
    path the mesh gives (at (1, 4) all but ``experts_6``, at (2, 2) all
    but ``batch_3`` go expert parallel): every case at the reference's
    bounds against JAX's ``moe_ffn`` on the same mesh, and against both
    dense paths -- except where a data shard's capacity drops other
    assignments than the global batch's (``DROPS_DIFFER``), where JAX's
    own mesh run leaves the dense path by more than the bound too."""
    ranks, dense, want = runs
    name, shape = case[0], FOUR_RANK_MESHES[tag]
    on_mesh = [res for res in ranks if res[f"{tag}/coordinate"] is not None]
    assert len(on_mesh) == 4
    refs = refs_of(dense, want, name, tag)
    jax_gap = float(np.abs(want[f"{tag}/{name}/y"] - dense[name][0]).max())
    if (tag, name) in DROPS_DIFFER:
        assert jax_gap > FWD_TOL, jax_gap
    else:
        refs += refs_of(dense, want, name)
    check_against(on_mesh, refs, dense[name][0],
                  takes_ep(shape, case[3], case[4]), f"{tag}/{name}")


@pytest.mark.parametrize("tag", FOUR_RANK_MESHES)
def test_four_rank_meshes_agree_bit_for_bit(runs, tag):
    """Ranks 0-3 hold each coordinate of the 4-rank mesh once, ranks 4-7
    none, and the four agree bit for bit on every case."""
    ranks, _, _ = runs
    data, model = FOUR_RANK_MESHES[tag]
    coords = [res[f"{tag}/coordinate"] for res in ranks]
    assert coords[4:] == [None] * 4
    assert sorted(tuple(c.values()) for c in coords[:4]) == [
        (d, m) for d in range(data) for m in range(model)]
    for name, *_ in CASES:
        check_ranks_agree(ranks[:4], f"{tag}/{name}")


@pytest.mark.gpu
def test_cuda_ep_at_one_rank_equals_dense():
    """On the card, the expert-parallel path over a one-rank NCCL group
    (n_ep = 1: the all_to_alls, the gathers and the gradient sums are
    identities) equals the dense path bit for bit: output, aux, load and
    every gradient, the ordered combine on both."""
    from repro_torch.models.moe import _moe_ffn_ep_global

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    inp = make_inputs()
    cfg = case_config(8, False)
    x = torch.from_numpy(inp["x"]).cuda()
    outs = []
    with one_rank_mesh("cuda") as mesh:
        for fn in (lambda p: _moe_ffn_dense(x, p, cfg),
                   lambda p: _moe_ffn_ep_global(x, p, cfg, mesh)):
            p = nest({k[3:]: torch.from_numpy(v).cuda().requires_grad_()
                      for k, v in inp.items() if k.startswith("p8/")})
            y, aux, load = fn(p)
            names, params = zip(*leaves(p))
            grads = torch.autograd.grad((y ** 2).sum() + aux, params)
            outs.append((y, aux, load) + tuple(grads))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_multi_gpu_ep_within_reference_bounds(tmp_path):
    """One NCCL rank per GPU (4, or 2 on a 2- or 3-GPU host; skips with
    fewer): every case on the (1, n) mesh, and at 4 GPUs on (2, 2), within
    the reference's bounds of as many gloo ranks on the CPU on the same
    mesh, and of the dense path on each rank's card (but where a shard's
    capacity drops differ, ``DROPS_DIFFER``); the ranks agree bit for
    bit, the dense path of every card too."""
    from repro_torch.launch.mesh import GPU_BACKEND

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        pytest.skip("needs two CUDA devices (chip_smoke.py --dist on a "
                    "multi-GPU host)")
    world = 4 if count >= 4 else 2
    meshes = {f"1x{world}": (1, world)}
    if world == 4:
        meshes["2x2"] = (2, 2)
    in_path = str(tmp_path / "inputs.npz")
    np.savez(in_path, **make_inputs())
    cards = run_ranks(rank_main, world, in_path, meshes, "cuda", True,
                      backend=GPU_BACKEND, timeout=300)
    cpus = run_ranks(rank_main, world, in_path, meshes, backend="gloo")
    for tag, shape in meshes.items():
        for case in CASES:
            name = case[0]
            key = f"{tag}/{name}"
            for card, cpu in zip(cards, cpus):
                refs = [cpu[key]]
                if (tag, name) not in DROPS_DIFFER:
                    refs.append(card["dense"][name])
                check_against([card], refs, card["dense"][name][0],
                              takes_ep(shape, case[3], case[4]), key)
            check_ranks_agree(cards, key)
            check_ranks_agree([res["dense"] for res in cards], name)
