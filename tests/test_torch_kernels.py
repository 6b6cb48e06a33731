"""The port's join kernels against the JAX package's, on the CPU.

The plain PyTorch versions (``repro_torch.kernels.ref``) must be
bit-identical to the JAX references and to the Pallas kernels run in
interpret mode, over the cases of ``tests/test_packed_kernels.py`` and
``tests/test_kernels.py``: op codes 0-3, C up to 32, M and B that are not
tile multiples, the Pallas block grids, zero-padded validity, negative
thresholds, all-none op stacks (the pair count must not count padding),
and values on a coarse grid so that ties (``l == r + theta``) occur.  The
joins that feed the compaction also come as bit words plus row counts:
those must equal the JAX masks packed with numpy, and the survivor
selection must equal ``jnp.nonzero(size=out_cap, fill_value=m*b)``.  The
packed join and the row count also take a threshold row per batch
element (the rulebook's rules), held against the JAX references under
``jax.vmap``; the capture-safe survivor selection is held against the
``torch.nonzero`` loop it replaced.  The CUDA kernels themselves run only
on a GPU: the ``gpu``-marked tests skip here.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import window_join_packed_ref as jax_packed_ref
from repro.kernels.ref import window_join_ref as jax_join_ref
from repro.kernels.ref import window_join_rowcount_ref as jax_rowcount_ref
from repro.kernels.window_join import (window_join_count_pallas,
                                       window_join_packed_pallas,
                                       window_join_pallas,
                                       window_join_rowcount_pallas)
from repro_torch.kernels import ops, ref, window_join


def _coarse(rng, shape):
    return (rng.integers(-6, 7, size=shape) * 0.25).astype(np.float32)


def _case(rng, C, M, B):
    L = _coarse(rng, (C, M))
    R = _coarse(rng, (C, B))
    op = rng.integers(0, 4, size=(C,)).astype(np.int32)
    th = np.abs(_coarse(rng, (C,)))
    mv = (rng.random(M) > 0.3).astype(np.int8)
    bv = (rng.random(B) > 0.3).astype(np.int8)
    return L, R, op, th, mv, bv


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("C,M,B", [
    (1, 1, 1), (2, 7, 5), (4, 128, 128), (9, 130, 257),
    (16, 64, 300), (32, 256, 384),
])
def test_packed_plain_matches_jax(C, M, B, rng):
    L, R, op, th, mv, bv = _case(rng, C, M, B)
    op8 = op.astype(np.int8)
    want_ref = np.asarray(jax_packed_ref(L, R, op8, th, mv, bv))
    want_int = np.asarray(window_join_packed_pallas(
        L, R, op8, th, mv, bv, interpret=True))
    got = ref.window_join_packed_ref(*_t(L, R, op8, th, mv, bv)).numpy()
    assert got.dtype == np.bool_ and got.shape == (M, B)
    assert (got == want_ref).all()
    assert (got == want_int).all()
    # The dispatch sends a CPU tensor to the same plain version.
    got_ops = ops.window_join_packed(*_t(L, R, op8, th, mv, bv)).numpy()
    assert (got_ops == want_ref).all()


def test_packed_all_none_ops_respects_validity(rng):
    C, M, B = 3, 130, 129
    L, R, _, _, mv, bv = _case(rng, C, M, B)
    op8 = np.zeros(C, np.int8)
    th = np.zeros(C, np.float32)
    want = np.asarray(window_join_packed_pallas(L, R, op8, th, mv, bv,
                                                interpret=True))
    got = ref.window_join_packed_ref(*_t(L, R, op8, th, mv, bv)).numpy()
    assert (got == want).all()
    assert got.sum() == int(mv.sum()) * int(bv.sum())


def test_packed_ties_are_exercised(rng):
    """The coarse grid must actually produce l == r + theta ties on the
    active LT rows, or the exactness cases would not test them."""
    L, R, op, th, _, _ = _case(rng, 9, 130, 257)
    ties = (L[:, :, None] == R[:, None, :] + th[:, None, None])
    assert ties[op == 1].any()


@pytest.mark.parametrize("C,M,B", [
    (1, 1, 1), (2, 7, 5), (9, 130, 257), (32, 64, 300),
])
def test_rowcount_plain_matches_jax(C, M, B, rng):
    L, R, op, th, _, _ = _case(rng, C, M, B)
    want_ref = np.asarray(jax_rowcount_ref(L, R, op, th))
    want_int = np.asarray(window_join_rowcount_pallas(L, R, op, th,
                                                      interpret=True))
    got = ref.window_join_rowcount_ref(*_t(L, R, op, th)).numpy()
    assert got.dtype == np.int32 and got.shape == (M,)
    assert (got == want_ref).all()
    assert (got == want_int).all()
    got_ops = ops.window_join_rowcount(*_t(L, R, op, th)).numpy()
    assert (got_ops == want_ref).all()


def test_rowcount_unknown_op_codes_count_as_true(rng):
    """Op codes outside 0..3 (4 and -1) count as true in the row count, as
    in the JAX reference's ``cmp_op`` (its Pallas ``_rowcount_kernel``
    would select nothing; the engines never emit such codes).  With a K
    axis, per-partition ops."""
    K, C, M, B = 2, 4, 40, 70
    L = _coarse(rng, (K, C, M))
    R = _coarse(rng, (K, C, B))
    op = np.array([[4, 1, -1, 2], [-1, 4, 3, -1]], np.int32)
    th = _coarse(rng, (C,))  # negative thresholds included
    got_ref = ref.window_join_rowcount_ref(*_t(L, R, op, th)).numpy()
    got_ops = ops.window_join_rowcount(*_t(L, R, op, th)).numpy()
    for k in range(K):
        want = np.asarray(jax_rowcount_ref(L[k], R[k], op[k], th))
        assert (got_ref[k] == want).all() and (got_ops[k] == want).all()
    unknown = np.array([[4, -1, 4, -1]] * K, np.int32)
    got = ops.window_join_rowcount(*_t(L, R, unknown, th)).numpy()
    assert (got == np.asarray(jax_rowcount_ref(L[0], R[0], unknown[0],
                                               th))).all()
    assert (got == B).all()


def test_rowcount_all_none_ops_counts_true_extent(rng):
    C, M, B = 2, 130, 140
    L, R, _, _, _, _ = _case(rng, C, M, B)
    got = ref.window_join_rowcount_ref(
        *_t(L, R, np.zeros(C, np.int32), np.zeros(C, np.float32))).numpy()
    assert (got == B).all()


@pytest.mark.parametrize("C,M,B,bm,bb", [
    (3, 130, 140, 8, 128), (3, 130, 140, 128, 128), (3, 130, 140, 256, 128),
    (1, 1, 1, 8, 128), (9, 257, 129, 128, 128), (32, 64, 300, 8, 128),
])
def test_unpacked_plain_matches_jax(C, M, B, bm, bb, rng):
    """The tree engine's join and the pair count, with the block grids of
    ``tests/test_packed_kernels.py`` and thresholds of either sign."""
    L, R, op, _, _, _ = _case(rng, C, M, B)
    th = _coarse(rng, (C,))  # negative thresholds included
    want_ref = np.asarray(jax_join_ref(L, R, op, th))
    want_int = np.asarray(window_join_pallas(L, R, op, th, block_m=bm,
                                             block_b=bb, interpret=True))
    got = ref.window_join_ref(*_t(L, R, op, th)).numpy()
    assert got.dtype == np.bool_ and got.shape == (M, B)
    assert (got == want_ref).all()
    assert (got == want_int).all()
    assert (ops.window_join(*_t(L, R, op, th)).numpy() == want_ref).all()
    cnt = ref.window_join_count_ref(*_t(L, R, op, th))
    assert cnt.dtype == torch.int32 and cnt.shape == ()
    want_cnt = int(window_join_count_pallas(L, R, op, th, block_m=bm,
                                            block_b=bb, interpret=True))
    assert int(cnt) == want_cnt == int(want_ref.sum())
    assert int(ops.window_join_count(*_t(L, R, op, th))) == want_cnt


@pytest.mark.parametrize("C,M,B", [(2, 130, 140), (1, 9, 129), (3, 257, 5)])
def test_count_plain_padding_exact_all_ops(C, M, B, rng):
    """The cases of ``tests/test_kernels.py``: a stack of op-0 rows counts
    exactly M*B, and a mixed stack equals the interpret-mode kernel."""
    L, R, _, _, _, _ = _case(rng, C, M, B)
    zeros = np.zeros(C, np.int32), np.zeros(C, np.float32)
    got = ref.window_join_count_ref(*_t(L, R, *zeros))
    want = int(window_join_count_pallas(L, R, *zeros, interpret=True))
    assert int(got) == want == M * B
    op = rng.integers(0, 4, size=C).astype(np.int32)
    th = _coarse(rng, (C,))
    want = int(window_join_count_pallas(L, R, op, th, interpret=True))
    assert int(ref.window_join_count_ref(*_t(L, R, op, th))) == want


def test_batched_plain_versions_equal_per_partition_loop(rng):
    """A leading K axis (the fleet) changes nothing per partition; ops
    differ per partition, thresholds are shared."""
    K, C, M, B = 3, 6, 40, 33
    cases = [_case(rng, C, M, B) for _ in range(K)]
    th = cases[0][3]
    L, R, op, _, mv, bv = (np.stack([c[i] for c in cases])
                           for i in range(6))
    op8 = op.astype(np.int8)
    packed = ref.window_join_packed_ref(*_t(L, R, op8, th, mv, bv)).numpy()
    counts = ref.window_join_rowcount_ref(*_t(L, R, op, th)).numpy()
    joined = ref.window_join_ref(*_t(L, R, op, th)).numpy()
    totals = ref.window_join_count_ref(*_t(L, R, op, th))
    assert totals.dtype == torch.int32 and totals.shape == (K,)
    for k in range(K):
        assert (packed[k] == np.asarray(jax_packed_ref(
            L[k], R[k], op8[k], th, mv[k], bv[k]))).all()
        assert (counts[k] == np.asarray(jax_rowcount_ref(
            L[k], R[k], op[k], th))).all()
        want = np.asarray(jax_join_ref(L[k], R[k], op[k], th))
        assert (joined[k] == want).all()
        assert int(totals[k]) == int(want.sum())


@pytest.mark.parametrize("ops_rows", [
    [[1, 0, 2, 3, 1], [1, 2, 2, 0, 3], [1, 3, 2, 1, 0]],
    [[0, 5, 1, -1, 3], [0, 5, 2, 4, 3], [0, 5, 3, 1, 3]],
])
def test_plain_joins_shared_and_mixed_op_rows_match_jax(ops_rows, rng):
    """On the CPU a row whose op code every partition shares computes only
    that code's comparison: rows shared and mixed across K, codes outside
    0..3 included (the packed join selects nothing for them, the unpacked
    join and the row count count them as true), against the JAX package's
    plain versions per partition."""
    K, C, M, B = 3, 5, 70, 45
    L = _coarse(rng, (K, C, M))
    R = _coarse(rng, (K, C, B))
    op = np.array(ops_rows, np.int32)
    th = _coarse(rng, (K, C))  # per-partition, negative ones included
    mv = (rng.random((K, M)) > 0.3).astype(np.int8)
    bv = (rng.random((K, B)) > 0.3).astype(np.int8)
    op8 = op.astype(np.int8)
    packed = ref.window_join_packed_ref(*_t(L, R, op8, th, mv, bv)).numpy()
    joined = ref.window_join_ref(*_t(L, R, op, th)).numpy()
    counts = ref.window_join_rowcount_ref(*_t(L, R, op, th)).numpy()
    for k in range(K):
        assert (packed[k] == np.asarray(jax_packed_ref(
            L[k], R[k], op8[k], th[k], mv[k], bv[k]))).all()
        want = np.asarray(jax_join_ref(L[k], R[k], op[k], th[k]))
        assert (joined[k] == want).all()
        assert (counts[k] == np.asarray(jax_rowcount_ref(
            L[k], R[k], op[k], th[k]))).all()


@pytest.mark.parametrize("cells", [1, 64, 1000])
def test_plain_joins_in_row_blocks_equal_one_pass(cells, rng, monkeypatch):
    """The plain joins that count or pack their mask go over blocks of rows
    (``ref._JOIN_BLOCK_CELLS`` cells a pass; at the escalated widths a
    whole plane did not fit on the card): any block size gives the
    one-pass words and counts, equal to the JAX package's per partition."""
    K, C, M, B = 2, 4, 67, 45
    L = _coarse(rng, (K, C, M))
    R = _coarse(rng, (K, C, B))
    op = rng.integers(0, 4, size=(K, C)).astype(np.int32)
    th = _coarse(rng, (K, C))
    mv = (rng.random((K, M)) > 0.3).astype(np.int8)
    bv = (rng.random((K, B)) > 0.3).astype(np.int8)
    op8 = op.astype(np.int8)
    args = _t(L, R, op, th)
    packed_args = _t(L, R, op8, th, mv, bv)
    whole = (ref.window_join_bits_ref(*args),
             ref.window_join_packed_bits_ref(*packed_args),
             ref.window_join_rowcount_ref(*args),
             ref.window_join_count_ref(*args))
    monkeypatch.setattr(ref, "_JOIN_BLOCK_CELLS", cells)
    assert len(ref._row_blocks(args[0], args[1])) > 1
    blocked = (ref.window_join_bits_ref(*args),
               ref.window_join_packed_bits_ref(*packed_args),
               ref.window_join_rowcount_ref(*args),
               ref.window_join_count_ref(*args))
    for got, want in zip(blocked[:2], whole[:2]):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(blocked[2], whole[2])
    assert torch.equal(blocked[3], whole[3])
    for k in range(K):
        mask = np.asarray(jax_join_ref(L[k], R[k], op[k], th[k]))
        assert (ref.unpack_bits(blocked[0][0][k], B).numpy() == mask).all()
        assert (blocked[2][k].numpy() == mask.sum(-1)).all()
        assert int(blocked[3][k]) == int(mask.sum())
        pmask = np.asarray(jax_packed_ref(L[k], R[k], op8[k], th[k], mv[k],
                                          bv[k]))
        assert (ref.unpack_bits(blocked[1][0][k], B).numpy() == pmask).all()
        assert (blocked[1][1][k].numpy() == pmask.sum(-1)).all()


def test_dispatch_rules(rng):
    L, R, op, th, mv, bv = _t(*_case(rng, 3, 9, 7))
    before = dict(ops.LAUNCHES)
    ops.window_join_packed(L, R, op.to(torch.int8), th, mv, bv)
    ops.window_join_rowcount(L, R, op, th, backend="ref")
    ops.window_join(L, R, op, th)
    ops.window_join_count(L, R, op, th, backend="ref")
    assert ops.LAUNCHES == before  # the plain versions launch nothing
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.window_join_packed(L, R, op.to(torch.int8), th, mv, bv,
                               backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.window_join_rowcount(L, R, op, th, backend="cuda")
    for fn in (ops.window_join, ops.window_join_count):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(L, R, op, th, backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.window_join_rowcount(L, R, op, th, backend="pallas")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.window_join(L, R, op, th, backend="interpret")
    # The CUDA wrappers refuse a CPU tensor before they build anything.
    for fn in (window_join.window_join_rowcount_cuda,
               window_join.window_join_cuda,
               window_join.window_join_count_cuda):
        with pytest.raises(ValueError, match="CUDA kernel called on a cpu"):
            fn(L[None], R[None], op[None], th)
    assert ops.LAUNCHES == before


def test_validity_vectors_reach_the_kernel_as_bytes():
    """The packed kernel tests validity bytes for != 0; bool and int8
    vectors (the plain version's and the JAX package's dtypes) are viewed
    as those bytes, not copied or converted."""
    v = torch.tensor([0, 1, -1, 127, -128], dtype=torch.int8)
    for t in (v, v != 0):
        u = window_join._as_u8(t)
        assert u.dtype == torch.uint8 and u.data_ptr() == t.data_ptr()
        assert torch.equal(u != 0, v != 0)
    u8 = torch.tensor([0, 3], dtype=torch.uint8)
    assert window_join._as_u8(u8) is u8


def test_kernel_module_imports_without_nvcc():
    """Importing (and naming the build product) needs no compiler: the
    build runs at the first launch, never at import."""
    path = window_join.library_path()
    assert path.parent == window_join.BUILD_DIR
    assert path.name.startswith("window_join_") and path.suffix == ".so"
    assert window_join.BUILD_DIR.parts[-2:] == ("build",
                                                "repro_torch_kernels")
    assert set(window_join.LAUNCHES) == {"window_join_packed",
                                         "window_join_rowcount",
                                         "window_join", "window_join_count",
                                         "select_survivors"}


def _np_bits(mask):
    """A (..., M, B) bool mask as (..., M, ceil(B/32)) int32 words, packed
    by numpy: bit j of word w is column 32 w + j, tail bits 0."""
    b = mask.shape[-1]
    padded = np.zeros(mask.shape[:-1] + (-(-b // 32) * 32,), bool)
    padded[..., :b] = mask
    return np.packbits(padded, axis=-1, bitorder="little").view("<i4")


def _assert_bits(got, mask):
    bits, counts = got
    assert bits.dtype == torch.int32 and counts.dtype == torch.int32
    assert np.array_equal(bits.numpy(), _np_bits(mask))
    assert np.array_equal(counts.numpy(), mask.sum(-1))


def test_pack_bits_layout():
    """Bit j of word w is column 32 w + j (bit 31 is the sign bit), tail
    bits stay 0, and unpacking restores the mask at any width."""
    mask = torch.zeros((2, 70), dtype=torch.bool)
    mask[0, 31] = mask[0, 32] = mask[1, 69] = True
    bits = ref.pack_bits(mask)
    assert bits.tolist() == [[-(2 ** 31), 1, 0], [0, 0, 1 << 5]]
    rng = np.random.default_rng(3)
    for b in (1, 31, 32, 33, 64, 100):
        m = torch.from_numpy(rng.random((3, 5, b)) < 0.5)
        assert torch.equal(ref.unpack_bits(ref.pack_bits(m), b), m)
        assert np.array_equal(ref.pack_bits(m).numpy(), _np_bits(m.numpy()))


BIT_SHAPES = [(1, 1, 1), (3, 130, 140), (9, 257, 129), (32, 64, 300),
              (6, 40, 33), (4, 33, 64)]


@pytest.mark.parametrize("C,M,B", BIT_SHAPES)
def test_join_bits_plain_matches_jax(C, M, B, rng):
    """The tree join's bit words and row counts are the interpret-mode
    Pallas mask packed, and its row sums; an all-op-0 stack is all ones
    with 0 tail bits."""
    L, R, op, _, _, _ = _case(rng, C, M, B)
    th = _coarse(rng, (C,))  # negative thresholds included
    want = np.asarray(window_join_pallas(L, R, op, th, interpret=True))
    _assert_bits(ref.window_join_bits_ref(*_t(L, R, op, th)), want)
    _assert_bits(ops.window_join_bits(*_t(L, R, op, th)), want)
    zeros = np.zeros(C, np.int32)
    want = np.asarray(window_join_pallas(L, R, zeros, th, interpret=True))
    assert want.all()
    _assert_bits(ops.window_join_bits(*_t(L, R, zeros, th)), want)


@pytest.mark.parametrize("C,M,B", BIT_SHAPES)
def test_packed_bits_plain_matches_jax(C, M, B, rng):
    """The order join's bit words and row counts, validity vectors
    included, are the interpret-mode packed Pallas mask packed; an
    all-op-0 stack leaves exactly the valid cells."""
    L, R, op, th, mv, bv = _case(rng, C, M, B)
    op8 = op.astype(np.int8)
    want = np.asarray(window_join_packed_pallas(L, R, op8, th, mv, bv,
                                                interpret=True))
    _assert_bits(ref.window_join_packed_bits_ref(
        *_t(L, R, op8, th, mv, bv)), want)
    _assert_bits(ops.window_join_packed_bits(*_t(L, R, op8, th, mv, bv)),
                 want)
    zeros = np.zeros(C, np.int8)
    want = np.asarray(window_join_packed_pallas(L, R, zeros, th, mv, bv,
                                                interpret=True))
    assert want.sum() == int(mv.sum()) * int(bv.sum())
    _assert_bits(ops.window_join_packed_bits(
        *_t(L, R, zeros, th, mv, bv)), want)


def test_bits_batched_equal_per_partition(rng):
    """With a K axis each partition's words and counts are its own JAX
    mask packed; ops differ per partition, thresholds are shared."""
    K, C, M, B = 3, 6, 40, 45
    cases = [_case(rng, C, M, B) for _ in range(K)]
    th = cases[0][3]
    L, R, op, _, mv, bv = (np.stack([c[i] for c in cases])
                           for i in range(6))
    op8 = op.astype(np.int8)
    joined = np.stack([np.asarray(window_join_pallas(
        L[k], R[k], op[k], th, interpret=True)) for k in range(K)])
    packed = np.stack([np.asarray(window_join_packed_pallas(
        L[k], R[k], op8[k], th, mv[k], bv[k], interpret=True))
        for k in range(K)])
    _assert_bits(ops.window_join_bits(*_t(L, R, op, th)), joined)
    _assert_bits(ops.window_join_packed_bits(*_t(L, R, op8, th, mv, bv)),
                 packed)


# (K, M, B, survivor density, out_cap)
SELECT_CASES = [
    (2, 9, 40, 0.0, 16),      # zero survivors: all slots are the fill
    (2, 30, 70, 0.3, 50),     # overflow: more survivors than out_cap
    (3, 7, 33, 0.5, 300),     # out_cap > M*B
    (2, 64, 129, 0.02, 200),  # ragged B, sparse rows
    (1, 1, 1, 1.0, 3),
]


@pytest.mark.parametrize("K,M,B,density,out_cap", SELECT_CASES)
def test_select_plain_matches_jnp_nonzero(K, M, B, density, out_cap, rng):
    """The plain selection from bit words and row counts equals the
    reference's ``jnp.nonzero(flat, size=out_cap, fill_value=m*b)`` per
    partition, and so does the dispatch on a CPU tensor."""
    mask = rng.random((K, M, B)) < density
    bits = torch.from_numpy(_np_bits(mask))
    counts = torch.from_numpy(mask.sum(-1).astype(np.int32))
    got = ref.select_survivors_ref(bits, counts, B, out_cap)
    assert got.dtype == torch.int64 and got.shape == (K, out_cap)
    for k in range(K):
        want = jnp.nonzero(jnp.asarray(mask[k].reshape(-1)), size=out_cap,
                           fill_value=M * B)[0]
        assert np.array_equal(got[k].numpy(), np.asarray(want))
    assert torch.equal(ops.select_survivors(bits, counts, B, out_cap), got)
    # Without a K axis, one partition.
    assert torch.equal(ref.select_survivors_ref(bits[0], counts[0], B,
                                                out_cap), got[0])


def test_bits_dispatch_rules(rng):
    """The bit-word joins and the selection follow the dispatch rules of
    the bool joins: CPU tensors run the plain versions (no launch),
    ``backend="cuda"`` on the CPU raises, and the CUDA wrappers refuse a
    CPU tensor before they build anything."""
    L, R, op, th, mv, bv = _t(*_case(rng, 3, 9, 7))
    op8 = op.to(torch.int8)
    before = dict(ops.LAUNCHES)
    bits, counts = ops.window_join_bits(L, R, op, th)
    ops.window_join_packed_bits(L, R, op8, th, mv, bv, backend="ref")
    ops.select_survivors(bits, counts, 7, 5)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.window_join_bits(L, R, op, th, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.window_join_packed_bits(L, R, op8, th, mv, bv, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.select_survivors(bits, counts, 7, 5, backend="cuda")
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu"):
        window_join.window_join_bits_cuda(L[None], R[None], op[None], th)
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu"):
        window_join.window_join_packed_bits_cuda(
            L[None], R[None], op8[None], th, mv[None], bv[None])
    with pytest.raises(ValueError, match="on a CUDA device"):
        window_join.select_survivors_cuda(bits[None], counts[None], 7, 5)
    assert ops.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C,M,B", [(8, 1000, 333), (32, 257, 1030)])
def test_cuda_kernels_match_plain(C, M, B, cuda_device, rng):
    K = 3
    cases = [_case(rng, C, M, B) for _ in range(K)]
    L, R, op, _, mv, bv = (
        torch.from_numpy(np.stack([c[i] for c in cases])).to(cuda_device)
        for i in range(6))
    th = torch.from_numpy(cases[0][3]).to(cuda_device)
    op8, mv, bv = op.to(torch.int8), mv > 0, bv > 0
    assert torch.equal(ops.window_join_packed(L, R, op8, th, mv, bv),
                       ops.window_join_packed(L, R, op8, th, mv, bv,
                                              backend="ref"))
    assert torch.equal(ops.window_join_rowcount(L, R, op, th),
                       ops.window_join_rowcount(L, R, op, th,
                                                backend="ref"))
    assert torch.equal(ops.window_join(L, R, op, th),
                       ops.window_join(L, R, op, th, backend="ref"))
    assert torch.equal(ops.window_join_count(L, R, op, th),
                       ops.window_join_count(L, R, op, th, backend="ref"))


@pytest.mark.gpu
@pytest.mark.parametrize("C,M,B", [(3, 1000, 333), (1, 257, 1030)])
def test_cuda_count_all_none_ops_counts_true_extent(C, M, B, cuda_device,
                                                    rng):
    """Cells past the true extents never count: an op-0 stack at ragged
    extents totals exactly M*B per partition."""
    K = 2
    L = torch.from_numpy(_coarse(rng, (K, C, M))).to(cuda_device)
    R = torch.from_numpy(_coarse(rng, (K, C, B))).to(cuda_device)
    op = torch.zeros((K, C), dtype=torch.int32, device=cuda_device)
    th = torch.zeros((C,), dtype=torch.float32, device=cuda_device)
    assert ops.window_join_count(L, R, op, th).tolist() == [M * B] * K


@pytest.mark.gpu
@pytest.mark.parametrize("C,M,B", [(8, 1000, 333), (32, 257, 1030),
                                   (9, 65, 40)])
def test_cuda_bits_and_select_match_plain(C, M, B, cuda_device, rng):
    """The bit-word joins and the selection kernel against their plain
    versions at ragged shapes: overflow, a capacity past M*B, and zero
    survivors."""
    K = 3
    cases = [_case(rng, C, M, B) for _ in range(K)]
    L, R, op, _, mv, bv = (
        torch.from_numpy(np.stack([c[i] for c in cases])).to(cuda_device)
        for i in range(6))
    th = torch.from_numpy(cases[0][3]).to(cuda_device)
    op8 = op.to(torch.int8)
    zero = (torch.zeros((K, M, -(-B // 32)), dtype=torch.int32,
                        device=cuda_device),
            torch.zeros((K, M), dtype=torch.int32, device=cuda_device))
    for name, got, want in (
            ("join", ops.window_join_bits(L, R, op, th),
             ops.window_join_bits(L, R, op, th, backend="ref")),
            ("packed", ops.window_join_packed_bits(L, R, op8, th, mv, bv),
             ops.window_join_packed_bits(L, R, op8, th, mv, bv,
                                         backend="ref")),
            ("zero", zero, zero)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                            want[1]), name
        for cap in (1, 64, M * B + 5):
            assert torch.equal(
                ops.select_survivors(*got, B, cap),
                ops.select_survivors(*got, B, cap, backend="ref")), \
                (name, cap)


def _count_stacks(rng, K, C, M, B):
    """Operand stacks for the row and pair counts: mixed op codes 0-4 with
    thresholds of either sign; rows that are all true (codes 0 and 4) but
    the last, so the last register group decides; the same behind a
    leading validity row (as the engine's) that keeps only the first M/8
    rows, so every 32 x 32 tile past them dies at the first row; and
    all-op-0."""
    L = _coarse(rng, (K, C, M))
    R = _coarse(rng, (K, C, B))
    op = rng.integers(0, 5, size=(K, C)).astype(np.int32)
    th = _coarse(rng, (C,))
    late = rng.choice(np.array([0, 4], np.int32), size=(K, C))
    late[:, -1] = rng.integers(1, 4, size=K)
    gL, gR, gop, gth = L.copy(), R.copy(), late.copy(), th.copy()
    gL[:, 0] = np.arange(M) < M // 8
    gR[:, 0], gop[:, 0], gth[0] = 1.0, 2, 0.5  # valid > 1.0 - 0.5
    return [("mixed ops", (L, R, op, th)),
            ("last row decides", (L, R, late, th)),
            ("validity row first", (gL, gR, gop, gth)),
            ("all-op-0", (L, R, np.zeros((K, C), np.int32), th))]


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 15, 16, 17, 33, 64])
def test_cuda_counts_match_plain_across_edges(C, cuda_device, rng):
    """The row count and the pair count against their plain versions at
    shapes that cross the strip body's edges: C across the 16-row register
    groups, M across 32-row strips, B across 32-column words; an op-0
    stack counts B per row and M*B per partition."""
    K = 2
    for M in (1, 31, 33, 1000):
        for B in (1, 31, 32, 33, 1030):
            for what, arrays in _count_stacks(rng, K, C, M, B):
                args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
                for fn in (ops.window_join_rowcount, ops.window_join_count):
                    assert torch.equal(fn(*args), fn(*args, backend="ref")), \
                        (fn.__name__, M, B, what)
                if what == "all-op-0":
                    assert (ops.window_join_rowcount(*args) == B).all()
                    assert ops.window_join_count(*args).tolist() == \
                        [M * B] * K


# ---------------------------------------------------------------------------
# Thresholds per batch element (the rulebook's flattened (K, Qb) axis)
# ---------------------------------------------------------------------------


def _batch_case(rng, K, C, M, B):
    """K stacked cases whose threshold rows all differ (row k shifted by
    0.25 k on the 0.25 grid), op codes 0-3."""
    cases = [_case(rng, C, M, B) for _ in range(K)]
    L, R, op, th, mv, bv = (np.stack([c[i] for c in cases])
                            for i in range(6))
    th = (th + 0.25 * np.arange(K, dtype=np.float32)[:, None]).astype(
        np.float32)
    return L, R, op, th, mv, bv


@pytest.mark.parametrize("K,C,M,B", [(3, 10, 70, 33), (4, 6, 129, 64),
                                     (2, 1, 1, 1), (5, 16, 40, 97)])
def test_per_batch_thresholds_plain_match_jax_vmap(K, C, M, B, rng):
    """``(K, C)`` thresholds: the plain packed join (bool and bit words),
    row count, unpacked join and pair count equal the JAX references under
    ``jax.vmap`` over the batch, exactly, and each batch row equals the
    one-row call with its own threshold vector."""
    L, R, op, th, mv, bv = _batch_case(rng, K, C, M, B)
    op8 = op.astype(np.int8)
    want = np.asarray(jax.vmap(jax_packed_ref)(L, R, op8, th, mv, bv))
    got = ref.window_join_packed_ref(*_t(L, R, op8, th, mv, bv)).numpy()
    assert (got == want).all()
    _assert_bits(ops.window_join_packed_bits(*_t(L, R, op8, th, mv, bv)),
                 want)
    want_rc = np.asarray(jax.vmap(jax_rowcount_ref)(L, R, op, th))
    got_rc = ops.window_join_rowcount(*_t(L, R, op, th)).numpy()
    assert np.array_equal(got_rc, want_rc)
    want_join = np.asarray(jax.vmap(jax_join_ref)(L, R, op, th))
    _assert_bits(ops.window_join_bits(*_t(L, R, op, th)), want_join)
    assert np.array_equal(ops.window_join_count(*_t(L, R, op, th)).numpy(),
                          want_join.sum(axis=(1, 2)))
    for k in range(K):
        one = _t(L[k], R[k], op8[k], th[k], mv[k], bv[k])
        assert (ref.window_join_packed_ref(*one).numpy() == got[k]).all()
        assert np.array_equal(
            ref.window_join_rowcount_ref(*_t(L[k], R[k], op[k],
                                             th[k])).numpy(), got_rc[k])


def test_engine_row_stacks_carry_per_batch_thresholds(rng):
    """``engine._rows_to_stacks``: static thetas give one shared ``(C,)``
    vector (the order and tree engines); a per-batch ``(K,)`` theta in any
    row gives ``(K, C)``, static rows broadcast."""
    from repro_torch.core.engine import _rows_to_stacks

    k, m, b = 3, 5, 4
    lv = torch.from_numpy(_coarse(rng, (k, m)))
    rv = torch.from_numpy(_coarse(rng, (k, b)))
    w = torch.tensor([1.0, 2.5, 0.75])
    static = [(lv, rv, 1, 0.5), (lv, 1.0, 2, 0.25)]
    *_, ths = _rows_to_stacks(static, k, m, b, torch.device("cpu"))
    assert ths.shape == (2,) and ths.tolist() == [0.5, 0.25]
    *_, ths = _rows_to_stacks(static + [(lv, rv, 1, w)], k, m, b,
                              torch.device("cpu"))
    assert ths.shape == (k, 3)
    assert ths.tolist() == [[0.5, 0.25, 1.0], [0.5, 0.25, 2.5],
                            [0.5, 0.25, 0.75]]


def _select_nonzero_loop(bits, row_counts, b, out_cap):
    """The plain selection before it became capture-safe: one
    ``torch.nonzero`` per partition over the unpacked mask, sliced to a
    data-dependent length (the oracle of the rewrite)."""
    *lead, m, _ = bits.shape
    flat = ref.unpack_bits(bits, b).reshape(math.prod(lead), m * b)
    idx = torch.full((flat.shape[0], out_cap), m * b, dtype=torch.int64)
    for i in range(flat.shape[0]):
        found = torch.nonzero(flat[i]).flatten()[:out_cap]
        idx[i, :found.numel()] = found
    return idx.reshape(*lead, out_cap)


# (K, M, B, survivor density, out_cap): the selection cases above, plus
# out_cap exactly the survivor total, one short of it, zero, full rows,
# ragged words and a single partition without a K axis.
SELECT_EDGE_CASES = SELECT_CASES + [
    (2, 5, 32, 1.0, 160), (2, 5, 32, 1.0, 159), (3, 4, 64, 0.9, 0),
    (2, 3, 33, 1.0, 100), (4, 17, 95, 0.1, 7), (2, 1, 1, 0.0, 1),
]


@pytest.mark.parametrize("K,M,B,density,out_cap", SELECT_EDGE_CASES)
def test_select_equals_the_nonzero_loop_it_replaced(K, M, B, density,
                                                    out_cap, rng):
    """The fixed-size selection (popcount prefix + ``searchsorted``, no
    host sync) is bit-identical to the ``torch.nonzero`` loop: the
    ``M * b`` fill, zero survivors, ``out_cap`` past ``M * b``, overflow."""
    mask = rng.random((K, M, B)) < density
    bits = torch.from_numpy(_np_bits(mask))
    counts = torch.from_numpy(mask.sum(-1).astype(np.int32))
    got = ref.select_survivors_ref(bits, counts, B, out_cap)
    assert got.dtype == torch.int64 and got.shape == (K, out_cap)
    assert torch.equal(got, _select_nonzero_loop(bits, counts, B, out_cap))
    assert torch.equal(ref.select_survivors_ref(bits[0], counts[0], B,
                                                out_cap), got[0])


@pytest.mark.parametrize("K,M,B,density,out_cap",
                         [(2, 9, 70, 0.4, 999), (3, 30, 40, 0.3, 50),
                          (2, 5, 32, 1.0, 160)])
def test_select_in_slot_blocks_equals_one_pass(K, M, B, density, out_cap,
                                              rng, monkeypatch):
    """The plain selection's slot blocks (which bound its memory when
    ``out_cap`` is far past the survivors) change nothing: 7-slot blocks
    equal the nonzero loop."""
    mask = rng.random((K, M, B)) < density
    bits = torch.from_numpy(_np_bits(mask))
    counts = torch.from_numpy(mask.sum(-1).astype(np.int32))
    monkeypatch.setattr(ref, "_SELECT_BLOCK", 7)
    assert torch.equal(ref.select_survivors_ref(bits, counts, B, out_cap),
                       _select_nonzero_loop(bits, counts, B, out_cap))


@pytest.mark.parametrize("words", [1, 300])
def test_select_in_partition_groups_equals_one_pass(words, rng,
                                                    monkeypatch):
    """The plain selection ranks the partitions' words in groups of about
    ``_SELECT_WORDS`` words (whole partitions; at the escalated widths one
    pass over every partition did not fit on the card): one partition a
    pass, or a few, equal the nonzero loop."""
    K, M, B, out_cap = 5, 30, 70, 400
    mask = rng.random((K, M, B)) < 0.3
    bits = torch.from_numpy(_np_bits(mask))
    counts = torch.from_numpy(mask.sum(-1).astype(np.int32))
    monkeypatch.setattr(ref, "_SELECT_WORDS", words)
    monkeypatch.setattr(ref, "_SELECT_BLOCK", 64)
    assert torch.equal(ref.select_survivors_ref(bits, counts, B, out_cap),
                       _select_nonzero_loop(bits, counts, B, out_cap))


@pytest.mark.gpu
@pytest.mark.parametrize("K,C,M,B", [(32, 10, 8192, 1024),
                                     (5, 6, 1000, 333), (3, 64, 37, 1030)])
def test_cuda_per_batch_thresholds_match_plain(K, C, M, B, cuda_device,
                                               rng):
    """``(K, C)`` thresholds (rows that differ) through the kernels'
    batch stride: the packed join's words and row counts and the row count
    (and, at the smaller shapes, the unpacked join and the pair count)
    equal the plain versions bit for bit; a shared ``(C,)`` vector (stride
    0) equals the same values as ``(K, C)``."""
    L, R, op, th, mv, bv = (torch.from_numpy(a).to(cuda_device)
                            for a in _batch_case(rng, K, C, M, B))
    op8, mv, bv = op.to(torch.int8), mv > 0, bv > 0
    shared = th[0].contiguous()
    rows = shared.expand(K, C).contiguous()
    for t in (th, shared):
        got = ops.window_join_packed_bits(L, R, op8, t, mv, bv)
        want = ops.window_join_packed_bits(L, R, op8, t, mv, bv,
                                           backend="ref")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(ops.window_join_rowcount(L, R, op, t),
                           ops.window_join_rowcount(L, R, op, t,
                                                    backend="ref"))
    a = ops.window_join_packed_bits(L, R, op8, shared, mv, bv)
    b = ops.window_join_packed_bits(L, R, op8, rows, mv, bv)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(ops.window_join_rowcount(L, R, op, shared),
                       ops.window_join_rowcount(L, R, op, rows))
    if M * B <= 1 << 20:  # the unpacked join and the pair count take it too
        for fn in (ops.window_join_bits, ops.window_join_count):
            got, want = fn(L, R, op, th), fn(L, R, op, th, backend="ref")
            for g, w in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                assert torch.equal(g, w), fn.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["order", "tree"])
def test_cuda_plain_window_equals_kernel_window(plan, cuda_device):
    """A ``backend="ref"`` superchunk window captures and runs on the card
    (the plain selection has a fixed size and no host sync) and equals the
    kernel window, counter for counter."""
    from repro_torch import cep
    from repro_torch.cep import P, RuntimeConfig
    from repro_torch.core import scan
    from repro_torch.data.cep_streams import StreamConfig, traffic_stream

    rule = (P.seq(0, P.neg(3), 1, 2)
            .where(P.attr(0) < P.attr(1) + 0.3, P.attr(1) < P.attr(2) + 0.3)
            .within(3.0))
    caps = dict(max_invariants=8, max_terms=16) if plan == "tree" else {}
    scfg = StreamConfig(n_types=4, n_chunks=24, chunk_cap=64, base_rate=12.0,
                        shift_every=16.0)
    tels = []
    for backend in (None, "ref"):
        scan.reset_counts()
        sess = cep.open(rule, partitions=4, plan=plan, monitor=True,
                        config=RuntimeConfig(
                            buffer_capacity=64, match_capacity=1024,
                            chunk_capacity=64, device="cuda",
                            backend=backend, superchunk=8, **caps))
        tels.append(sess.run([traffic_stream(dataclasses.replace(
            scfg, seed=100 + p)) for p in range(4)]))
        assert scan.COUNTS["replays"] > 0 and scan.COUNTS["eager_steps"] == 0
    kernel, plain = tels
    for f in ("matches", "overflow", "neg_rejected", "replans",
              "deployments", "violations", "host_syncs", "escalations",
              "migration_partition_chunks"):
        assert getattr(kernel, f) == getattr(plain, f), f
    assert kernel.per_partition_matches.tolist() == \
        plain.per_partition_matches.tolist()
