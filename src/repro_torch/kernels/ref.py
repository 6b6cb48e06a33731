"""Plain PyTorch versions of the CEP window-join kernels.

Semantics (shared with the CUDA kernels in ``csrc/window_join.cu``): given
``C`` constraint rows, left-side values ``L[c, m]``, right-side values
``R[c, b]``, per-row op-codes and thresholds, compute

    ok[m, b] = AND_c  cmp(op[c], L[c, m], R[c, b], theta[c])

with the op-code table of ``repro_torch.core.patterns``:

    0 (NONE)   -> True
    1 (LT)     -> l <  r + theta
    2 (GT)     -> l >  r - theta
    3 (ABS_LE) -> |l - r| <= theta

Every function takes optional leading batch dimensions (the fleet's K
partition axis): ``L`` is ``(..., C, M)``, ``R`` is ``(..., C, B)``, per-row
ops are ``(..., C)`` and the thresholds ``(C,)`` or ``(..., C)``.  Without a
batch dimension each function is a literal twin of the JAX package's
reference, which is what the CPU tests hold them to, bit for bit.  The CPU
path of the engine runs these; ``chip_smoke.py`` holds the CUDA kernels
against them on the card.

The two joins that feed the compaction also come as bit words
(``*_bits_ref``): the mask packed 32 columns to an int32 word (bit ``j``
of word ``w`` is column ``32 w + j``, tail bits 0) beside each row's
survivor count, which ``select_survivors_ref`` turns into the reference's
``jnp.nonzero(size=out_cap, fill_value=m*b)`` indices.  Nothing here
syncs with the host, so a window step that runs the plain versions on the
card (``backend="ref"``) can be captured as a CUDA graph.
"""

from __future__ import annotations

import math

import torch


def cmp_op(op, l, r, theta):
    """Elementwise comparison dispatch; broadcasts ``l`` vs ``r``."""
    lt = l < r + theta
    gt = l > r - theta
    ab = torch.abs(l - r) <= theta
    true = torch.ones_like(lt)
    return torch.where(
        op == 1, lt, torch.where(op == 2, gt, torch.where(op == 3, ab, true))
    )


def _row(x, c):
    """Constraint row ``c`` of a ``(..., C)`` op/threshold strip, shaped to
    broadcast against ``(..., M, B)``."""
    return x[..., c, None, None]


def _shared_ops(ops):
    """Per constraint row, the op code every batch element shares there,
    else None.  Reading the codes syncs the host with a CUDA device, so
    while a CUDA graph is being captured every row is None (the selecting
    formula, capture-safe)."""
    rows = ops.reshape(-1, ops.shape[-1])
    if rows.shape[0] == 0 or (ops.is_cuda and
                              torch.cuda.is_current_stream_capturing()):
        return [None] * ops.shape[-1]
    lo, hi = rows.min(dim=0).values.tolist(), rows.max(dim=0).values.tolist()
    return [a if a == b else None for a, b in zip(lo, hi)]


def _cmp_row(op, l, r, th):
    """One row's plane for a known op code: the comparison ``cmp_op``
    selects, alone (None where every cell is true)."""
    if op == 0:
        return None
    if op == 1:
        return l < r + th
    if op == 2:
        return l > r - th
    return torch.abs(l - r) <= th


def window_join_packed_ref(L, R, ops8, thetas, mvalid, bvalid):
    """Packed oracle: ok[m, b] = mvalid & bvalid & AND_c row_c.

    L: (..., C, M) f32, R: (..., C, B) f32, ops8: (..., C) i8,
    thetas: (C,) or (..., C) f32, mvalid: (..., M), bvalid: (..., B)
    i8/u8/bool.  Returns (..., M, B) bool.  The float comparisons are the
    exact expressions of ``cmp_op``; op-codes outside 0..3 select nothing.
    A row whose op code every batch element shares computes only that
    code's comparison (the same values, a fraction of the work), except
    during a CUDA-graph capture.
    """
    acc = (mvalid > 0)[..., :, None] & (bvalid > 0)[..., None, :]
    shared = _shared_ops(ops8)
    for c in range(L.shape[-2]):  # keeps the working set at (..., M, B)
        l = L[..., c, :, None]
        r = R[..., c, None, :]
        th = _row(thetas, c)
        if shared[c] is not None and shared[c] not in (0, 1, 2, 3):
            acc = torch.zeros_like(acc)
            continue
        if shared[c] is not None:
            ok = _cmp_row(shared[c], l, r, th)
        else:
            o = _row(ops8, c)
            lt = l < r + th
            gt = l > r - th
            ab = torch.abs(l - r) <= th
            ok = (lt & (o == 1)) | (gt & (o == 2)) | (ab & (o == 3)) | (o == 0)
        if ok is not None:
            acc = acc & ok
    return acc


def window_join_ref(L, R, ops, thetas):
    """ok[m, b] = AND over constraint rows — (..., M, B) bool.

    L: (..., C, M) f32, R: (..., C, B) f32, ops: (..., C) i32, thetas:
    (C,) or (..., C) f32.  The reference stacks the ``(C, M, B)`` rows of
    ``cmp_op`` and takes ``all`` over C; here the AND is loop-accumulated
    over C (an AND is exact in any order), so the working set stays one
    ``(..., M, B)`` plane at the fleet's full width.
    """
    M, B = L.shape[-1], R.shape[-1]
    acc = torch.ones(L.shape[:-2] + (M, B), dtype=torch.bool,
                     device=L.device)
    shared = _shared_ops(ops)
    for c in range(L.shape[-2]):
        l, r, th = L[..., c, :, None], R[..., c, None, :], _row(thetas, c)
        if shared[c] is None or shared[c] not in (0, 1, 2, 3):
            ok = cmp_op(_row(ops, c), l, r, th)
        else:
            ok = _cmp_row(shared[c], l, r, th)
        if ok is not None:
            acc = acc & ok
    return acc


# Cells of the (..., M, B) plane that one pass of a plain join covers: the
# joins that reduce or pack their mask go over blocks of rows, so their
# temporaries (a few bytes a cell) stay bounded at escalated widths, where
# a whole plane would take tens of GiB.
_JOIN_BLOCK_CELLS = 1 << 28


def _row_blocks(L, R):
    """Row ranges ``(m0, m1)`` of ``L``'s M axis, each covering at most
    ``_JOIN_BLOCK_CELLS`` cells of the batched (..., M, B) plane."""
    m = L.shape[-1]
    cells_per_row = max(1, math.prod(L.shape[:-2]) * R.shape[-1])
    step = max(1, _JOIN_BLOCK_CELLS // cells_per_row)
    return [(m0, min(m0 + step, m)) for m0 in range(0, m, step)] or [(0, 0)]


def _by_row_blocks(per_block, L, R, dims):
    """``per_block(m0, m1)`` over the row blocks, each output joined along
    its M axis (``dims``, one per output)."""
    parts = [per_block(m0, m1) for m0, m1 in _row_blocks(L, R)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(outs, dim=d) for outs, d in zip(zip(*parts),
                                                           dims))


def window_join_count_ref(L, R, ops, thetas):
    """Total matching (m, b) pairs: the sum of ``window_join_ref``'s mask
    — a 0-d int32 without a batch axis, (...,) int32 with one."""
    return window_join_rowcount_ref(L, R, ops, thetas).sum(
        dim=-1, dtype=torch.int32)


def window_join_rowcount_ref(L, R, ops, thetas):
    """Per-m surviving-pair counts: cnt[m] = sum_b AND_c row_c[m, b].

    Feeds the negation veto (cnt > 0) and Kleene companion counts
    (cnt - 1) of the engine's finalize pass.  Returns (..., M) int32.

    Op codes outside 0..3 count as true, through ``cmp_op``, as in the JAX
    package's ``window_join_rowcount_ref``.  That package's Pallas
    ``_rowcount_kernel`` takes the packed dispatch instead and selects
    nothing for them; the engines emit only codes 0..3, so no engine
    result differs, and the port (plain version and CUDA kernel) follows
    ``cmp_op``.
    """
    (counts,) = _by_row_blocks(
        lambda m0, m1: (window_join_ref(L[..., m0:m1], R, ops, thetas)
                        .sum(dim=-1, dtype=torch.int32),), L, R, (-1,))
    return counts


def pack_bits(mask):
    """(..., M, B) bool -> (..., M, ceil(B/32)) int32 bit words: bit j of
    word w in row m is mask[..., m, 32 w + j]; tail bits past B are 0.
    A word is its 4 bytes, least significant first (little-endian)."""
    *lead, m, b = mask.shape
    w = -(-b // 32)
    if b == 32 * w:
        padded = mask.contiguous()
    else:
        padded = torch.zeros((*lead, m, 32 * w), dtype=torch.bool,
                             device=mask.device)
        padded[..., :b] = mask
    cells = padded.view(torch.uint8).view(*lead, m, 4 * w, 8)
    octets = cells[..., 0].clone()
    for j in range(1, 8):
        octets |= cells[..., j] << j
    return octets.view(torch.int32)


def unpack_bits(bits, b):
    """(..., M, W) int32 bit words -> the (..., M, b) bool mask."""
    octets = bits.view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    cells = (octets[..., None] >> shifts) & 1
    return cells.view(torch.bool).flatten(-2)[..., :b]


def _bits_and_counts(mask):
    return pack_bits(mask), mask.sum(dim=-1, dtype=torch.int32)


def window_join_bits_ref(L, R, ops, thetas):
    """``window_join_ref``'s mask as (bit words (..., M, ceil(B/32)) int32,
    row counts (..., M) int32)."""
    return _by_row_blocks(
        lambda m0, m1: _bits_and_counts(window_join_ref(
            L[..., m0:m1], R, ops, thetas)), L, R, (-2, -1))


def window_join_packed_bits_ref(L, R, ops8, thetas, mvalid, bvalid):
    """``window_join_packed_ref``'s mask as (bit words, row counts)."""
    return _by_row_blocks(
        lambda m0, m1: _bits_and_counts(window_join_packed_ref(
            L[..., m0:m1], R, ops8, thetas, mvalid[..., m0:m1], bvalid)),
        L, R, (-2, -1))


def _popcount(words):
    """Set bits per int32 word, as int64 (a SWAR count in elementwise ops:
    no host sync)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _select_in_word(word, rank):
    """Position of the set bit of ``word`` (uint32 values in int64) with
    ``rank`` set bits below it: a binary search over halves, quarters,
    ... of the word, by popcounts of its low bits."""
    pos = torch.zeros_like(word)
    for s in (16, 8, 4, 2, 1):
        below = _popcount((word >> pos) & ((1 << s) - 1))
        up = rank >= below
        rank = torch.where(up, rank - below, rank)
        pos = torch.where(up, pos + s, pos)
    return pos


# Output slots per partition that one pass of the plain selection handles
# (its temporaries are a few int64 per slot), and the words it ranks in
# one pass, whole partitions at a time (a few int64 per word).
_SELECT_BLOCK = 1 << 20
_SELECT_WORDS = 1 << 26


def select_survivors_ref(bits, row_counts, b, out_cap):
    """The first ``out_cap`` surviving cells in row-major order, as flat
    indices ``m * b + col`` — (..., out_cap) int64, ``M * b`` past the
    last survivor (the reference's ``jnp.nonzero(flat, size=out_cap,
    fill_value=m*b)`` per partition).

    Fixed-size and free of host syncs, so a CUDA graph can capture it: the
    inclusive prefix of the words' popcounts ranks them row-major, output
    slot ``j`` takes the first word whose prefix passes ``j``
    (``torch.searchsorted``), and its bit is the word's set bit with
    ``j - start`` set bits below it.  Slots ``j`` at or past the total
    (no such word) get ``M * b``.  The slots go in blocks of
    ``_SELECT_BLOCK`` per partition, so memory stays bounded when
    ``out_cap`` is far past the survivors, and the partitions in groups
    of about ``_SELECT_WORDS`` words.  The row counts (the words'
    popcounts per row) are not read.
    """
    *lead, m, w = bits.shape
    n_words = m * w
    dev = bits.device
    out = torch.full((math.prod(lead), out_cap), m * b, dtype=torch.int64,
                     device=dev)
    if n_words == 0:
        return out.reshape(*lead, out_cap)
    all_words = bits.reshape(math.prod(lead), n_words)
    group = max(1, _SELECT_WORDS // n_words)
    for p0 in range(0, all_words.shape[0], group):
        words = all_words[p0:p0 + group]
        pc = _popcount(words)
        incl = torch.cumsum(pc, dim=1)
        for j0 in range(0, out_cap, _SELECT_BLOCK):
            j = torch.arange(j0, min(j0 + _SELECT_BLOCK, out_cap),
                             device=dev)
            j = j.expand(words.shape[0], j.shape[0]).contiguous()
            wi = torch.searchsorted(incl, j, right=True)  # first incl > j
            live = wi < n_words
            wi = torch.clamp(wi, max=n_words - 1)
            rank = j - (torch.gather(incl, 1, wi) - torch.gather(pc, 1, wi))
            word = torch.gather(words, 1, wi).to(torch.int64) & 0xFFFFFFFF
            col = _select_in_word(word, rank)
            idx = (wi // w) * b + (wi % w) * 32 + col
            out[p0:p0 + group, j0:j0 + j.shape[1]] = torch.where(
                live, idx, m * b)
    return out.reshape(*lead, out_cap)
