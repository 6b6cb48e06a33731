"""Random ``P`` DSL trees through the port against the JAX package.

The twin of ``tests/test_dsl_prop.py``.  Its derandomized ``@given``
draws 12 seeds at K = 1 and 6 at K = 3; the draws of that file run alone
are fixed here (``benchmarks/torch_dsl_trees.py``: ``K1_SEEDS``,
``K3_SEEDS``) and each is a case of its own.  Per seed, the same tree and the same records are built through
both packages' DSL and stream generator, and ``cep.open(tree,
partitions=K, config=RuntimeConfig(buffer_capacity=64,
match_capacity=512)).run(...)`` must give every integer ``Telemetry``
field, the per-partition matches and each branch's counters equal to the
JAX session's, with no tolerance, and matches equal to the port's
``RefEngine`` summed per branch (per partition at K = 3).  The K = 3 seeds
run on the ``auto``, ``order`` and ``tree`` plans; a pattern that one
plan refuses must be refused by both packages with the same exception.
The generator copy is held to the test's own functions (same branches,
same records), and the DSL's validation errors to the reference's.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import test_dsl_prop as ref_prop  # noqa: E402
from benchmarks import torch_dsl_trees as trees  # noqa: E402
from benchmarks.torch_fleet_bench import INT_FIELDS  # noqa: E402
from repro import cep as jcep  # noqa: E402
from repro.cep import P as JP  # noqa: E402
from repro.cep import RuntimeConfig as JConfig  # noqa: E402
from repro.data.cep_streams import emit_chunk as j_emit_chunk  # noqa: E402
from repro_torch import cep  # noqa: E402
from repro_torch.cep import P, RefEngine, RuntimeConfig  # noqa: E402

CAPS = dict(buffer_capacity=64, match_capacity=512)
# Refusals a plan may raise at open or on its first chunk.
REFUSALS = (ValueError, TypeError, NotImplementedError)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def branch_strs(branches):
    return [str(b.build()) for b in branches]


@functools.lru_cache(maxsize=None)
def port_case(seed, k):
    return trees.case(seed, k)


@functools.lru_cache(maxsize=None)
def jax_case(seed, k):
    return trees.case(seed, k, JP, j_emit_chunk)


@functools.lru_cache(maxsize=None)
def oracle(seed, k):
    """The port's ``RefEngine``, summed over the branches, per partition."""
    _, branches, recs = port_case(seed, k)
    parts = [recs] if k == 1 else recs
    return [sum(RefEngine(b.build()).run(r).full_matches for b in branches)
            for r in parts]


def run(package, seed, k, plan):
    if package == "jax":
        tree, _, recs = jax_case(seed, k)
        return jcep.open(tree, partitions=k, plan=plan,
                         config=JConfig(**CAPS)).run(recs)
    tree, _, recs = port_case(seed, k)
    return cep.open(tree, partitions=k, plan=plan,
                    config=RuntimeConfig(device="cpu", **CAPS)).run(recs)


def assert_same_counters(got, want, what):
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(want, f), (what, f)
    assert got.per_partition_matches.tolist() == \
        want.per_partition_matches.tolist(), what


def check_case(seed, k, plan):
    _, branches, _ = port_case(seed, k)
    _, jbranches, _ = jax_case(seed, k)
    assert branch_strs(branches) == branch_strs(jbranches)
    try:
        want = run("jax", seed, k, plan)
    except REFUSALS as exc:
        with pytest.raises(type(exc)):
            run("port", seed, k, plan)
        return
    got = run("port", seed, k, plan)
    what = f"seed={seed} K={k} plan={plan}: " + " | ".join(
        branch_strs(branches))
    assert_same_counters(got, want, what)
    if want.branches is not None:
        assert len(got.branches) == len(want.branches)
        for i, (g, w) in enumerate(zip(got.branches, want.branches)):
            assert_same_counters(g, w, f"{what} branch {i}")
    assert got.per_partition_matches.tolist() == oracle(seed, k), what
    assert got.matches == sum(oracle(seed, k)), what


@pytest.mark.parametrize("seed", trees.K1_SEEDS)
def test_random_tree_session_equals_jax_and_oracle(seed):
    check_case(seed, 1, "auto")


@pytest.mark.parametrize("plan", ["auto", "order", "tree"])
@pytest.mark.parametrize("seed", trees.K3_SEEDS)
def test_random_tree_fleet_equals_jax_and_per_partition_oracle(seed, plan):
    check_case(seed, 3, plan)


@pytest.mark.parametrize("seed,k", [(s, 1) for s in trees.K1_SEEDS]
                         + [(s, 3) for s in trees.K3_SEEDS])
def test_generator_equals_the_reference_test_generator(seed, k):
    """``benchmarks/torch_dsl_trees.py`` with the JAX package's ``P`` and
    ``emit_chunk`` draws what ``tests/test_dsl_prop.py``'s own functions
    draw, and with the port's the same branches and record arrays."""
    rng = np.random.default_rng(seed if k == 1 else seed + trees.K3_OFFSET)
    tree, branches = ref_prop.random_tree(rng)
    recs = [ref_prop.random_records(rng) for _ in range(k)]
    _, jbranches, jrecs = jax_case(seed, k)
    _, pbranches, precs = port_case(seed, k)
    if k == 1:
        jrecs, precs = [jrecs], [precs]
    want = branch_strs(branches)
    assert branch_strs(jbranches) == want
    assert branch_strs(pbranches) == want
    assert str(jax_case(seed, k)[0].build()) == str(tree.build())
    for part, jpart, ppart in zip(recs, jrecs, precs):
        assert len(part) == len(jpart) == len(ppart) == trees.N_CHUNKS
        for r, jr, pr in zip(part, jpart, ppart):
            assert (r.t0, r.t1) == (jr.t0, jr.t1) == (pr.t0, pr.t1)
            for x in (jr, pr):
                assert np.array_equal(x.counts, r.counts)
                assert np.array_equal(x.true_rates, r.true_rates)
                for field in ("type_id", "ts", "attr", "valid"):
                    a = np.asarray(getattr(r.chunk, field))
                    b = np.asarray(getattr(x.chunk, field))
                    assert a.dtype == b.dtype and np.array_equal(a, b), field


MALFORMED = [
    ("< 2 primitives", ValueError, lambda P_: P_.seq(0).within(5.0).build()),
    ("duplicate type ids", ValueError,
     lambda P_: P_.seq(0, 0, 1).within(5.0).build()),
    ("neg + kleene", ValueError,
     lambda P_: P_.seq(0, P_.neg(2), P_.kleene(1)).within(5.0).build()),
    ("Cond is not a bool", TypeError,
     lambda P_: bool(P_.attr(0) < P_.attr(1))),
]


def test_dsl_validation_rejects_malformed_trees():
    """Each malformed tree of the reference test raises the same exception
    type with the same message in both packages."""
    for what, kind, build in MALFORMED:
        with pytest.raises(kind) as jexc:
            build(JP)
        with pytest.raises(jexc.type) as exc:
            build(P)
        assert str(exc.value) == str(jexc.value), what
