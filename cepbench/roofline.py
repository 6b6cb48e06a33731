"""Least times of the join kernels on their inputs, for their roofline shares.

Frozen copy of ``chip_smoke.py``'s ``roofline``, ``bit_output_bytes``,
``packed_bound`` and ``join_bound`` (in seconds here, and with the counts
split out so that a launch is counted without a host sync), with the
card's published terms written out here (NVIDIA H100 SXM data sheet:
67 TFLOP/s of float32 outside the tensor cores, 3.35 TB/s of HBM3, both
at the 700 W limit).

The operation count is 3 float32 operations (shift, compare, AND) per
active constraint row of each cell the kernel must decide.  The CUDA strip
body skips the remaining constraint rows of a tile once the tile is dead,
so a kernel can do fewer than 3 operations per active row on data where
early rows reject most cells; a share computed against this count could
then read high, and the count, not the share, would be what a later
benchmark change corrects.
"""

from __future__ import annotations

PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12


def roofline(nbytes, n_ops):
    """(seconds, what bounds it): the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BW
    t_ops = n_ops / PEAK_FLOPS_F32
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bit_output_bytes(k, m, b):
    """Bytes of a bit-word join's outputs: (K, M, ceil(B/32)) int32 words
    and (K, M) int32 row counts."""
    return 4 * k * m * -(-b // 32) + 4 * k * m


def packed_counts(L, R, ops8, th, mv, bv):
    """(bytes, operations) of one packed join (order plans) on these
    inputs: each input read once, the bit words and row counts written
    once; 3 operations per active constraint row of each valid cell,
    plus one.  The operations stay a 0-d tensor on the inputs' device, so
    counting a launch waits for nothing."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel()) + ops8.numel() \
        + mv.numel() + bv.numel() + bit_output_bytes(k, m, b)
    cells = mv.reshape(k, -1).sum(1).double() \
        * bv.reshape(k, -1).sum(1).double()
    active = (ops8.reshape(-1, c) != 0).sum(1).double()
    return nbytes, (cells * (3 * active + 1)).sum()


def packed_bound(L, R, ops8, th, mv, bv):
    """Least time of the packed join on these inputs."""
    nbytes, ops = packed_counts(L, R, ops8, th, mv, bv)
    return roofline(nbytes, float(ops))


def join_counts(L, R, ops, th):
    """(bytes, operations) of one unpacked join (tree plans) on these
    inputs: each input read once, the bit words and row counts written
    once; 3 operations per active constraint row of every cell (a 0-d
    tensor, as in ``packed_counts``)."""
    k, c, m = L.shape
    b = R.shape[2]
    nbytes = 4 * (L.numel() + R.numel() + th.numel() + ops.numel()) \
        + bit_output_bytes(k, m, b)
    active = ((ops >= 1) & (ops <= 3)).reshape(-1, c).sum(1).double()
    return nbytes, (m * b * 3 * active).sum()


def join_bound(L, R, ops, th):
    """Least time of the unpacked join on these inputs."""
    nbytes, ops_n = join_counts(L, R, ops, th)
    return roofline(nbytes, float(ops_n))
