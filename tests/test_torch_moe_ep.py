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
np.savez(OUT, **res)
"""


def leaves(p, prefix=""):
    for k, v in p.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def run_case(inp, name, seq_shard, use_perm, e, b, mesh=None):
    """One case's (y, aux, load, {leaf: grad of sum(y ** 2)}) through
    ``moe_ffn`` (under the rules of ``mesh`` if given) or the dense
    path."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models.moe import moe_ffn

    cfg = case_config(e, seq_shard)
    p = nest({k[len(f"p{e}/"):]: torch.from_numpy(v).requires_grad_()
              for k, v in inp.items() if k.startswith(f"p{e}/")})
    x = torch.from_numpy(inp["x"][:b])
    perm = torch.from_numpy(inp["perm"]) if use_perm else None
    if mesh is None:
        y, aux, load = _moe_ffn_dense(x, p, cfg, perm)
    else:
        with use_rules(mesh):
            y, aux, load = moe_ffn(x, p, cfg, perm)
    names, params = zip(*leaves(p))
    grads = torch.autograd.grad((y ** 2).sum(), params)
    return (y.detach().numpy(), float(aux), load.numpy(),
            {n: g.numpy() for n, g in zip(names, grads)})


def rank_main(rank, world, in_path):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    inp = dict(np.load(in_path))
    mesh = make_host_mesh(*MESH, device="cpu")
    taken = []
    real = {f: getattr(moe, f) for f in ("_moe_ffn_ep", "_moe_ffn_dense")}

    def recording(f):
        def call(*a, **kw):
            taken.append(f)
            return real[f](*a, **kw)
        return call

    for f in real:
        setattr(moe, f, recording(f))
    res = {"coordinate": mesh.coordinate}
    for name, seq_shard, use_perm, e, b, _ in CASES:
        del taken[:]
        res[name] = run_case(inp, name, seq_shard, use_perm, e, b, mesh)
        res[f"{name}/path"] = list(taken)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    in_path, out = str(d / "inputs.npz"), str(d / "jax.npz")
    inp = make_inputs()
    np.savez(in_path, **inp)
    proc = start_jax(f"IN = {in_path!r}\nCASES = {CASES!r}\n" + JAX_CODE,
                     WORLD, out)
    try:
        ranks = run_ranks(rank_main, WORLD, in_path)
    finally:
        want = finish_jax(proc, out)
    dense = {c[0]: run_case(inp, *c[:5]) for c in CASES}
    return ranks, dense, want


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_on_the_mesh_matches_dense(runs, case):
    """Every rank's output, load, aux and gradients against the port's
    and JAX's dense path, at the reference's bounds; the path taken is
    the reference's (EP under its condition, else dense, whose output
    then equals the port's dense path bit for bit)."""
    ranks, dense, want = runs
    name, ep = case[0], case[5]
    dy, daux, dload, dgrads = dense[name]
    assert float(np.abs(dy - want[f"{name}/y"]).max()) <= FWD_TOL
    for r, res in enumerate(ranks):
        y, aux, load, grads = res[name]
        path = res[f"{name}/path"]
        assert path == (["_moe_ffn_ep"] if ep else ["_moe_ffn_dense"]), \
            (r, path)
        if not ep:
            assert np.array_equal(y, dy), r
        for ref_y, ref_aux, ref_load, ref in (
                (dy, daux, dload, dgrads),
                (want[f"{name}/y"], float(want[f"{name}/aux"]),
                 want[f"{name}/load"],
                 {k: want[f"{name}/grad/{k}"] for k in dgrads})):
            assert float(np.abs(y - ref_y).max()) < FWD_TOL, (r, name)
            assert np.allclose(load, ref_load, atol=LOAD_TOL), (r, load)
            assert abs(aux - ref_aux) < AUX_TOL, (r, aux, ref_aux)
            for k, g in grads.items():
                err = float(np.abs(g - ref[k]).max())
                assert err < GRAD_TOL, (r, name, k, err)


def test_ranks_agree_bit_for_bit(runs):
    """The mesh's ranks are one replicated computation: outputs, aux, load
    and gradients equal on every rank, and every (data, model) coordinate
    of the 2 x 4 mesh present once."""
    ranks, _, _ = runs
    coords = sorted(tuple(r["coordinate"].values()) for r in ranks)
    assert coords == [(d, m) for d in range(MESH[0]) for m in range(MESH[1])]
    for name, *_ in CASES:
        y0, aux0, load0, g0 = ranks[0][name]
        for res in ranks[1:]:
            y, aux, load, g = res[name]
            assert np.array_equal(y, y0) and aux == aux0, name
            assert np.array_equal(load, load0), name
            assert all(np.array_equal(g[k], g0[k]) for k in g0), name


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
