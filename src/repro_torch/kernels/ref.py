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


def window_join_packed_ref(L, R, ops8, thetas, mvalid, bvalid):
    """Packed oracle: ok[m, b] = mvalid & bvalid & AND_c row_c.

    L: (..., C, M) f32, R: (..., C, B) f32, ops8: (..., C) i8,
    thetas: (C,) or (..., C) f32, mvalid: (..., M), bvalid: (..., B)
    i8/u8/bool.  Returns (..., M, B) bool.  The float comparisons are the
    exact expressions of ``cmp_op``; op-codes outside 0..3 select nothing.
    """
    acc = (mvalid > 0)[..., :, None] & (bvalid > 0)[..., None, :]
    for c in range(L.shape[-2]):  # keeps the working set at (..., M, B)
        l = L[..., c, :, None]
        r = R[..., c, None, :]
        th = _row(thetas, c)
        o = _row(ops8, c)
        lt = l < r + th
        gt = l > r - th
        ab = torch.abs(l - r) <= th
        ok = (lt & (o == 1)) | (gt & (o == 2)) | (ab & (o == 3)) | (o == 0)
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
    for c in range(L.shape[-2]):
        ok = cmp_op(_row(ops, c), L[..., c, :, None], R[..., c, None, :],
                    _row(thetas, c))
        acc = acc & ok
    return acc


def window_join_count_ref(L, R, ops, thetas):
    """Total matching (m, b) pairs: the sum of ``window_join_ref``'s mask
    — a 0-d int32 without a batch axis, (...,) int32 with one."""
    return window_join_ref(L, R, ops, thetas).sum(dim=(-2, -1),
                                                  dtype=torch.int32)


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
    return window_join_ref(L, R, ops, thetas).sum(dim=-1, dtype=torch.int32)


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
    return _bits_and_counts(window_join_ref(L, R, ops, thetas))


def window_join_packed_bits_ref(L, R, ops8, thetas, mvalid, bvalid):
    """``window_join_packed_ref``'s mask as (bit words, row counts)."""
    return _bits_and_counts(window_join_packed_ref(L, R, ops8, thetas,
                                                   mvalid, bvalid))


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
# (its temporaries are a few int64 per slot).
_SELECT_BLOCK = 1 << 20


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
    ``out_cap`` is far past the survivors.  The row counts (the words'
    popcounts per row) are not read.
    """
    *lead, m, w = bits.shape
    n_words = m * w
    dev = bits.device
    out = torch.full((math.prod(lead), out_cap), m * b, dtype=torch.int64,
                     device=dev)
    if n_words == 0:
        return out.reshape(*lead, out_cap)
    words = bits.reshape(math.prod(lead), n_words)
    pc = _popcount(words)
    incl = torch.cumsum(pc, dim=1)
    for j0 in range(0, out_cap, _SELECT_BLOCK):
        j = torch.arange(j0, min(j0 + _SELECT_BLOCK, out_cap), device=dev)
        j = j.expand(words.shape[0], j.shape[0]).contiguous()
        wi = torch.searchsorted(incl, j, right=True)  # first incl > j
        live = wi < n_words
        wi = torch.clamp(wi, max=n_words - 1)
        rank = j - (torch.gather(incl, 1, wi) - torch.gather(pc, 1, wi))
        word = torch.gather(words, 1, wi).to(torch.int64) & 0xFFFFFFFF
        col = _select_in_word(word, rank)
        idx = (wi // w) * b + (wi % w) * 32 + col
        out[:, j0:j0 + j.shape[1]] = torch.where(live, idx, m * b)
    return out.reshape(*lead, out_cap)
