// Hand-written Hopper (sm_90a) kernels for the CEP masked windowed join.
//
// All join kernels evaluate, for K fleet partitions at once (grid.z = K),
//
//     ok[k, m, b] = AND_c cmp(op[k, c], L[k, c, m], R[k, c, b], theta[c])
//
// with the literal f32 comparison forms l < r + theta, l > r - theta and
// fabsf(l - r) <= theta.  The thresholds are never folded and the file must
// not be built with --use_fast_math (its -ftz=true flushes denormals, which
// changes comparisons): every kernel is bit-identical to its plain
// PyTorch version in repro_torch/kernels/ref.py.
//
// The two joins that feed a compaction (packed_kernel, join_kernel) emit
// the mask as bit words, (K, M, ceil(B/32)) int32 with bit j of word w in
// row m the cell b = 32 w + j (tail bits past B are 0), plus each row's
// survivor count (K, M) int32.  select_kernel turns those into the
// row-major survivor indices of a fixed-size compaction, reading only the
// rows that hold a survivor below the capacity: no byte or int32 per cell
// reaches device memory.
//
// The launchers have a plain C interface (loaded with ctypes by
// repro_torch/kernels/window_join.py).  Each launches on the caller's stream,
// allocates nothing, never synchronises, and returns cudaGetLastError().

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Widest constraint stack the launchers accept (shared-memory staging).
constexpr int kMaxC = 64;

// The unpacked op dispatch of ref.cmp_op: 1 lt, 2 gt, 3 abs, any other op
// true.  Ops are uniform across a block (one partition), so the branches
// never diverge within a warp.
__device__ __forceinline__ bool cmp_unpacked(int op, float l, float r,
                                             float th) {
  if (op == 1) return l < r + th;
  if (op == 2) return l > r - th;
  if (op == 3) return fabsf(l - r) <= th;
  return true;
}

// Stages partition k's (C, bm) L strip from column m0, (C, bb) R strip
// from column b0, its ops (K, C) and the shared thresholds (C,) into
// shared memory; columns past the true extents read as 0.  The caller
// synchronises.
__device__ __forceinline__ void stage_unpacked(
    const float* __restrict__ L, const float* __restrict__ R,
    const int32_t* __restrict__ ops, const float* __restrict__ thetas,
    float* sL, float* sR, float* sTh, int* sOp, int k, int C, int M, int B,
    int m0, int bm, int b0, int bb, int tid, int nthreads) {
  const float* Lk = L + static_cast<size_t>(k) * C * M;
  const float* Rk = R + static_cast<size_t>(k) * C * B;
  for (int i = tid; i < C * bb; i += nthreads) {
    const int c = i / bb, b = b0 + i % bb;
    sR[i] = b < B ? Rk[static_cast<size_t>(c) * B + b] : 0.0f;
  }
  for (int i = tid; i < C * bm; i += nthreads) {
    const int c = i / bm, m = m0 + i % bm;
    sL[i] = m < M ? Lk[static_cast<size_t>(c) * M + m] : 0.0f;
  }
  for (int i = tid; i < C; i += nthreads) {
    sTh[i] = thetas[i];
    sOp[i] = ops[static_cast<size_t>(k) * C + i];
  }
}

// ---------------------------------------------------------------------------
// Bit-word joins: packed_kernel (order steps) and join_kernel (tree steps)
// ---------------------------------------------------------------------------
//
// packed_kernel replaces: src/repro/kernels/window_join.py,
// window_join_packed_pallas / _packed_kernel (the pallas_call at :295):
//   ok[k, m, b] = mv[k, m] & bv[k, b] & AND_c sel_c, with
//   sel_c = (lt & op==1) | (gt & op==2) | (ab & op==3) | (op==0)
//   (int8 op codes outside 0..3 select nothing).
// join_kernel replaces: src/repro/kernels/window_join.py,
// window_join_pallas / _kernel (the pallas_call at :120):
//   ok[k, m, b] = AND_c cmp_unpacked(op[k, c], L, R, th[c])
//   (validity enters as two ordinary f32 rows; ops outside 1..3 are true).
//
// Both write bit words (K, M, W = ceil(B/32)) int32 and row counts (K, M)
// int32: the TPU kernel's mask plus the count the compaction needs.
//
// Bound on the H100: operations.  Per (cell, active row) one f32 compare
// (abs: a subtract too) and the AND; the bytes are the (C, M) + (C, B)
// operand strips, M*W/8 of a byte-mask's M*B bytes, and the counts.
//
// Design.  A block owns a strip of kStripM = 32 rows of one partition and
// walks all of B, its kBitsWarps warps taking interleaved 32-column words.
// A lane holds one column b and a 32-bit accumulator with one bit per row
// of the strip, so the row loop is unrolled in registers: per constraint
// row c the block-uniform op is branched on once (no per-cell dispatch),
// the lane's R value (and r + th or r - th, the same f32 sums the literal
// forms compute) sits in a register, and the strip's 32 L values are read
// as 8 broadcast float4 loads from shared memory.  R values are loaded
// kCGroup rows at a time into registers (C <= 16 covers both paths in one
// group; wider stacks up to kMaxC loop over groups).  When no cell of the
// warp's 32 x 32 tile survives, the remaining rows are skipped (a uniform
// vote) -- on the engine's stacks the validity rows come first.  A 5-step
// shuffle transpose turns the lanes' column accumulators into row words
// (lane i: row m0 + i), whose __popc is the row's survivor count among the
// warp's columns; the words go through a padded shared tile so each row's
// kBitsWarps words are stored contiguously, and the per-warp counts are
// summed in shared memory at the end: exact integer sums, no atomics.
// Left for later: a cp.async / TMA pipeline for the R words, and fusing
// the selection into the join so the bit words never leave the SM.

constexpr int kStripM = 32;    // rows per block: one accumulator bit each
constexpr int kBitsWarps = 8;  // warps per block, interleaved over words
constexpr int kCGroup = 16;    // R values a lane holds in registers
constexpr unsigned kFull = 0xffffffffu;

// On entry bit i of lane l's x is A[l][i]; on return it is A[i][l].
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  const unsigned masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    const int s = 16 >> t;
    const unsigned m = masks[t];  // bits i with (i & s) == 0
    const unsigned y = __shfl_xor_sync(kFull, x, s);
    x = (lane & s) ? ((x & ~m) | ((y >> s) & m))
                   : ((x & m) | ((y << s) & ~m));
  }
  return x;
}

// Clears bit i of acc for each strip row i whose L value fails ok.
template <class Pred>
__device__ __forceinline__ unsigned and_strip(unsigned acc, const float* l,
                                              Pred ok) {
  const float4* l4 = reinterpret_cast<const float4*>(l);
#pragma unroll
  for (int q = 0; q < kStripM / 4; ++q) {
    const float4 v = l4[q];
    if (!ok(v.x)) acc &= ~(1u << (4 * q));
    if (!ok(v.y)) acc &= ~(1u << (4 * q + 1));
    if (!ok(v.z)) acc &= ~(1u << (4 * q + 2));
    if (!ok(v.w)) acc &= ~(1u << (4 * q + 3));
  }
  return acc;
}

// One constraint row against the strip: op is block-uniform.
template <bool kPacked>
__device__ __forceinline__ unsigned join_row(unsigned acc, int op,
                                             const float* l, float r,
                                             float th) {
  if (op == 1) {
    const float x = r + th;
    return and_strip(acc, l, [x](float lv) { return lv < x; });
  }
  if (op == 2) {
    const float x = r - th;
    return and_strip(acc, l, [x](float lv) { return lv > x; });
  }
  if (op == 3) {
    return and_strip(acc, l,
                     [r, th](float lv) { return fabsf(lv - r) <= th; });
  }
  if (kPacked && op != 0) return 0u;  // packed: unknown codes select none
  return acc;  // op 0, or (unpacked) any other code: true
}

template <typename OpT, bool kPacked>
__device__ __forceinline__ void bits_body(
    const float* __restrict__ L, const float* __restrict__ R,
    const OpT* __restrict__ ops, const float* __restrict__ thetas,
    const uint8_t* __restrict__ mvalid, const uint8_t* __restrict__ bvalid,
    int32_t* __restrict__ bits, int32_t* __restrict__ counts, int C, int M,
    int B, int W) {
  extern __shared__ float4 smem4[];
  float* sL = reinterpret_cast<float*>(smem4);           // (C, kStripM)
  unsigned* tile =
      reinterpret_cast<unsigned*>(sL + C * kStripM);     // (32, warps + 1)
  int* part = reinterpret_cast<int*>(tile + kStripM * (kBitsWarps + 1));
  float* sTh = reinterpret_cast<float*>(part + kBitsWarps * 32);  // (C,)
  int* sOp = reinterpret_cast<int*>(sTh + C);                     // (C,)

  const int k = blockIdx.z;
  const int m0 = blockIdx.x * kStripM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* Lk = L + static_cast<size_t>(k) * C * M;
  const float* Rk = R + static_cast<size_t>(k) * C * B;
  for (int i = threadIdx.x; i < C * kStripM; i += blockDim.x) {
    const int c = i / kStripM, m = m0 + i % kStripM;
    sL[i] = m < M ? Lk[static_cast<size_t>(c) * M + m] : 0.0f;
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    sTh[i] = thetas[i];
    sOp[i] = static_cast<int>(ops[static_cast<size_t>(k) * C + i]);
  }
  unsigned init = kFull;  // rows of the strip a cell may survive in
  if (kPacked) {
    const int m = m0 + lane;
    init = __ballot_sync(
        kFull, m < M && mvalid[static_cast<size_t>(k) * M + m] != 0);
  }
  __syncthreads();

  int cnt = 0;  // survivors of row m0 + lane among this warp's words
  for (int w0 = 0; w0 < W; w0 += kBitsWarps) {
    const int w = w0 + warp;
    unsigned acc = 0;  // bit i: cell (m0 + i, b) survives so far
    if (w < W) {       // warp-uniform
      const int b = w * 32 + lane;
      if (b < B) {
        acc = (!kPacked || bvalid[static_cast<size_t>(k) * B + b] != 0)
                  ? init
                  : 0u;
      }
      for (int c0 = 0; c0 < C; c0 += kCGroup) {
        float rv[kCGroup];
#pragma unroll
        for (int j = 0; j < kCGroup; ++j) {
          rv[j] = (c0 + j < C && b < B)
                      ? Rk[static_cast<size_t>(c0 + j) * B + b]
                      : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kCGroup; ++j) {
          const int c = c0 + j;
          if (c >= C || !__any_sync(kFull, acc)) break;
          acc = join_row<kPacked>(acc, sOp[c], sL + c * kStripM, rv[j],
                                  sTh[c]);
        }
      }
    }
    const unsigned word = transpose32(acc, lane);  // lane i: row m0 + i
    cnt += __popc(word);
    tile[lane * (kBitsWarps + 1) + warp] = word;
    __syncthreads();
    {
      const int row = threadIdx.x / kBitsWarps, q = threadIdx.x % kBitsWarps;
      const int m = m0 + row, ww = w0 + q;
      if (m < M && ww < W) {
        bits[(static_cast<size_t>(k) * M + m) * W + ww] =
            static_cast<int32_t>(tile[row * (kBitsWarps + 1) + q]);
      }
    }
    __syncthreads();  // the tile is consumed before the next words
  }
  part[warp * 32 + lane] = cnt;
  __syncthreads();
  if (threadIdx.x < 32) {
    int total = 0;
#pragma unroll
    for (int q = 0; q < kBitsWarps; ++q) total += part[q * 32 + threadIdx.x];
    const int m = m0 + threadIdx.x;
    if (m < M) counts[static_cast<size_t>(k) * M + m] = total;
  }
}

__global__ void __launch_bounds__(kBitsWarps * 32)
    packed_kernel(const float* __restrict__ L, const float* __restrict__ R,
                  const int8_t* __restrict__ ops,
                  const float* __restrict__ thetas,
                  const uint8_t* __restrict__ mvalid,
                  const uint8_t* __restrict__ bvalid,
                  int32_t* __restrict__ bits, int32_t* __restrict__ counts,
                  int C, int M, int B, int W) {
  bits_body<int8_t, true>(L, R, ops, thetas, mvalid, bvalid, bits, counts,
                          C, M, B, W);
}

__global__ void __launch_bounds__(kBitsWarps * 32)
    join_kernel(const float* __restrict__ L, const float* __restrict__ R,
                const int32_t* __restrict__ ops,
                const float* __restrict__ thetas,
                int32_t* __restrict__ bits, int32_t* __restrict__ counts,
                int C, int M, int B, int W) {
  bits_body<int32_t, false>(L, R, ops, thetas, nullptr, nullptr, bits,
                            counts, C, M, B, W);
}

size_t bits_smem(int C) {
  return static_cast<size_t>(C) * (kStripM + 2) * sizeof(float) +
         kStripM * (kBitsWarps + 1) * sizeof(unsigned) +
         kBitsWarps * 32 * sizeof(int);
}

// ---------------------------------------------------------------------------
// Survivor selection
// ---------------------------------------------------------------------------
//
// Replaces: jnp.nonzero(flat, size=out_cap, fill_value=m*b) in
// src/repro/core/engine.py:_compact (:167) -- not a TPU kernel.
//
// idx[k, j] = m * B + b of the j-th surviving cell of partition k in
// row-major order, for j < min(total, out_cap); m * B (past the last
// cell) in the slots after the last survivor.  ends[k, m] is the inclusive
// prefix of the row counts, so row m's survivors take ranks
// [ends - count, ends).
//
// Bound on the H100: bytes -- the row counts and prefix, the bit words of
// the rows that hold a rank below out_cap, and the out_cap indices.  One
// warp owns one row: it returns at once when the row is empty or starts
// at or past out_cap, else reads the row's words 32 at a time (one per
// lane, coalesced), ranks them with a warp prefix sum of their __popc,
// and each lane writes its word's survivors below out_cap.  The fill of
// the slots past the last survivor is a grid-stride loop over the slots
// of the partition.  Every slot is written exactly once: no atomics.

constexpr int kSelectWarps = 8;  // rows per block

__global__ void __launch_bounds__(kSelectWarps * 32)
    select_kernel(const int32_t* __restrict__ bits,
                  const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ ends,
                  int64_t* __restrict__ idx, int M, int B, int W,
                  int out_cap) {
  const int k = blockIdx.z;
  const int64_t fill = static_cast<int64_t>(M) * B;
  int64_t* out = idx + static_cast<size_t>(k) * out_cap;
  const int total = ends[static_cast<size_t>(k) * M + M - 1];
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < out_cap;
       s += gridDim.x * blockDim.x) {
    if (s >= total) out[s] = fill;
  }

  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * kSelectWarps + threadIdx.x / 32;
  if (m >= M) return;  // warp-uniform
  const int cnt = counts[static_cast<size_t>(k) * M + m];
  const int end = ends[static_cast<size_t>(k) * M + m];
  int rank = end - cnt;  // rank of the row's next survivor
  if (cnt == 0 || rank >= out_cap) return;
  const int32_t* row = bits + (static_cast<size_t>(k) * M + m) * W;
  const int64_t base = static_cast<int64_t>(m) * B;
  for (int w0 = 0; w0 < W && rank < end && rank < out_cap; w0 += 32) {
    const int w = w0 + lane;
    unsigned word = w < W ? static_cast<unsigned>(row[w]) : 0u;
    const int pc = __popc(word);
    int incl = pc;  // inclusive prefix of pc over the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    int pos = rank + incl - pc;
    while (word != 0u && pos < out_cap) {
      const int j = __ffs(word) - 1;
      out[pos++] = base + 32 * w + j;
      word &= word - 1u;
    }
    rank += __shfl_sync(kFull, incl, 31);
  }
}


// ---------------------------------------------------------------------------
// Row count
// ---------------------------------------------------------------------------
//
// Replaces: src/repro/kernels/window_join.py, window_join_rowcount_pallas /
// _rowcount_kernel (the pallas_call at :383).
//
// cnt[k, m] = sum_{b < B} AND_c cmp(op[k, c], L[k, c, m], R[k, c, b], th[c])
// with the unpacked op dispatch of ref.cmp_op (1 lt, 2 gt, 3 abs, else
// true).  The (M, B) mask is never stored.
//
// Bound on the H100: operations, C compare-selects per (m, b) cell plus
// the count; it reads only (C, M) + (C, B) floats and writes M ints.  The
// TPU kernel accumulates across a sequential j grid; Hopper blocks run in
// no order, so here one warp owns one (k, m) row and loops over all of B
// itself: lanes stride over b, each block stages a (C, kRowTileB) R tile
// in shared memory for its kRowsPerBlock warps, and the 32 lane partials
// are reduced with __shfl_down_sync.  Integer sums are exact in any order,
// so there are no atomics and no second pass.
// Left for later: several rows per warp to reuse each staged R value from
// registers, and a double-buffered (cp.async / TMA) R tile pipeline.

constexpr int kRowsPerBlock = 8;  // warps per block, one (k, m) row each
constexpr int kRowTileB = 128;    // b per staged R tile

__global__ void rowcount_kernel(const float* __restrict__ L,
                                const float* __restrict__ R,
                                const int32_t* __restrict__ ops,
                                const float* __restrict__ thetas,
                                int32_t* __restrict__ out,
                                int C, int M, int B) {
  extern __shared__ float smem[];
  float* sR = smem;                                    // (C, kRowTileB)
  float* sL = sR + C * kRowTileB;                      // (C, kRowsPerBlock)
  float* sTh = sL + C * kRowsPerBlock;                 // (C,)
  int* sOp = reinterpret_cast<int*>(sTh + C);          // (C,)

  const int k = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kRowsPerBlock;
  const int m = m0 + warp;
  const float* Lk = L + static_cast<size_t>(k) * C * M;
  const float* Rk = R + static_cast<size_t>(k) * C * B;

  for (int i = threadIdx.x; i < C * kRowsPerBlock; i += blockDim.x) {
    const int c = i / kRowsPerBlock, mm = m0 + i % kRowsPerBlock;
    sL[i] = mm < M ? Lk[static_cast<size_t>(c) * M + mm] : 0.0f;
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    sTh[i] = thetas[i];
    sOp[i] = ops[static_cast<size_t>(k) * C + i];
  }

  int cnt = 0;
  for (int b0 = 0; b0 < B; b0 += kRowTileB) {
    __syncthreads();  // the previous tile is consumed (and sL/sOp written)
    for (int i = threadIdx.x; i < C * kRowTileB; i += blockDim.x) {
      const int c = i / kRowTileB, b = b0 + i % kRowTileB;
      sR[i] = b < B ? Rk[static_cast<size_t>(c) * B + b] : 0.0f;
    }
    __syncthreads();
    if (m < M) {
      for (int j = lane; j < kRowTileB && b0 + j < B; j += 32) {
        bool acc = true;
        for (int c = 0; c < C; ++c) {
          acc = acc & cmp_unpacked(sOp[c], sL[c * kRowsPerBlock + warp],
                                   sR[c * kRowTileB + j], sTh[c]);
        }
        cnt += acc ? 1 : 0;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0 && m < M) out[static_cast<size_t>(k) * M + m] = cnt;
}

// ---------------------------------------------------------------------------
// Pair count
// ---------------------------------------------------------------------------
//
// Replaces: src/repro/kernels/window_join.py, window_join_count_pallas /
// _count_kernel (the pallas_call at :202).
//
// cnt[k] = sum_{m < M, b < B} AND_c cmp(op[k, c], L[k, c, m], R[k, c, b],
// th[c]) — the total of join_kernel's mask, which is never stored.
//
// Bound on the H100: operations, 3 f32 operations per active row of each
// cell plus the count; it reads (C, M) + (C, B) floats and writes K ints.
// The TPU kernel writes one partial per tile and the wrapper sums them.
// Hopper blocks run in no order, so each block reduces its (kCountBM,
// kCountBB) tile itself — warp shuffles, then one partial per warp in
// shared memory — and adds it to the zeroed (K,) output with one int32
// atomicAdd.  Integer atomics are exact, so the total does not depend on
// the order of the blocks.  Each thread walks kCountBM / kCountTY rows of
// m against its one b, which cuts the atomics to one per 4096 cells.  Cells
// at or past the true extents are masked by index: a stack of op-0 rows
// counts exactly M * B.

constexpr int kCountBB = 128;  // b per block (threadIdx.x)
constexpr int kCountTY = 4;    // threadIdx.y
constexpr int kCountBM = 32;   // m per block
constexpr int kCountWarps = kCountBB * kCountTY / 32;

__global__ void count_kernel(const float* __restrict__ L,
                             const float* __restrict__ R,
                             const int32_t* __restrict__ ops,
                             const float* __restrict__ thetas,
                             int32_t* __restrict__ out,
                             int C, int M, int B, int n_btiles) {
  extern __shared__ float smem[];
  float* sL = smem;                                    // (C, kCountBM)
  float* sR = sL + C * kCountBM;                       // (C, kCountBB)
  float* sTh = sR + C * kCountBB;                      // (C,)
  int* sOp = reinterpret_cast<int*>(sTh + C);          // (C,)
  __shared__ int warp_sums[kCountWarps];

  const int k = blockIdx.z;
  const int m0 = (blockIdx.x / n_btiles) * kCountBM;
  const int b0 = (blockIdx.x % n_btiles) * kCountBB;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  stage_unpacked(L, R, ops, thetas, sL, sR, sTh, sOp, k, C, M, B, m0,
                 kCountBM, b0, kCountBB, tid, blockDim.x * blockDim.y);
  __syncthreads();

  int cnt = 0;
  if (b0 + static_cast<int>(threadIdx.x) < B) {
    for (int i = threadIdx.y; i < kCountBM && m0 + i < M; i += kCountTY) {
      bool acc = true;
      for (int c = 0; c < C; ++c) {
        acc = acc & cmp_unpacked(sOp[c], sL[c * kCountBM + i],
                                 sR[c * kCountBB + threadIdx.x], sTh[c]);
      }
      cnt += acc ? 1 : 0;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if (tid % 32 == 0) warp_sums[tid / 32] = cnt;
  __syncthreads();
  if (tid < 32) {
    int v = tid < kCountWarps ? warp_sums[tid] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (tid == 0 && v != 0) atomicAdd(out + k, v);
  }
}

}  // namespace

extern "C" {

int wj_max_c() { return kMaxC; }

const char* wj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// L (K,C,M) f32, R (K,C,B) f32, ops (K,C) i8, thetas (C,) f32,
// mvalid (K,M) u8, bvalid (K,B) u8 -> bits (K,M,ceil(B/32)) i32,
// counts (K,M) i32.
int wj_packed(const void* L, const void* R, const void* ops,
              const void* thetas, const void* mvalid, const void* bvalid,
              void* bits, void* counts, int K, int C, int M, int B,
              void* stream) {
  if (C < 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kStripM - 1) / kStripM, 1, K);
  packed_kernel<<<grid, kBitsWarps * 32, bits_smem(C),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const int8_t*>(ops), static_cast<const float*>(thetas),
      static_cast<const uint8_t*>(mvalid),
      static_cast<const uint8_t*>(bvalid), static_cast<int32_t*>(bits),
      static_cast<int32_t*>(counts), C, M, B, (B + 31) / 32);
  return static_cast<int>(cudaGetLastError());
}

// L (K,C,M) f32, R (K,C,B) f32, ops (K,C) i32, thetas (C,) f32
// -> out (K,M) i32.
int wj_rowcount(const void* L, const void* R, const void* ops,
                const void* thetas, void* out, int K, int C, int M, int B,
                void* stream) {
  if (C < 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, 1, K);
  const dim3 block(32 * kRowsPerBlock);
  const size_t smem =
      static_cast<size_t>(C) *
      ((kRowTileB + kRowsPerBlock + 1) * sizeof(float) + sizeof(int));
  rowcount_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const int32_t*>(ops), static_cast<const float*>(thetas),
      static_cast<int32_t*>(out), C, M, B);
  return static_cast<int>(cudaGetLastError());
}


// L (K,C,M) f32, R (K,C,B) f32, ops (K,C) i32, thetas (C,) f32
// -> bits (K,M,ceil(B/32)) i32, counts (K,M) i32.
int wj_join(const void* L, const void* R, const void* ops,
            const void* thetas, void* bits, void* counts, int K, int C,
            int M, int B, void* stream) {
  if (C < 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kStripM - 1) / kStripM, 1, K);
  join_kernel<<<grid, kBitsWarps * 32, bits_smem(C),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const int32_t*>(ops), static_cast<const float*>(thetas),
      static_cast<int32_t*>(bits), static_cast<int32_t*>(counts), C, M, B,
      (B + 31) / 32);
  return static_cast<int>(cudaGetLastError());
}

// bits (K,M,ceil(B/32)) i32, counts (K,M) i32, ends (K,M) i32 (inclusive
// prefix of counts) -> idx (K,out_cap) i64.  M >= 1.
int wj_select(const void* bits, const void* counts, const void* ends,
              void* idx, int K, int M, int B, int out_cap, void* stream) {
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kSelectWarps - 1) / kSelectWarps, 1, K);
  select_kernel<<<grid, kSelectWarps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bits), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(ends), static_cast<int64_t*>(idx), M, B,
      (B + 31) / 32, out_cap);
  return static_cast<int>(cudaGetLastError());
}

// L (K,C,M) f32, R (K,C,B) f32, ops (K,C) i32, thetas (C,) f32
// -> out (K,) i32, which the caller zeroes before the launch.
int wj_count(const void* L, const void* R, const void* ops,
             const void* thetas, void* out, int K, int C, int M, int B,
             void* stream) {
  if (C < 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const int n_btiles = (B + kCountBB - 1) / kCountBB;
  const int n_mtiles = (M + kCountBM - 1) / kCountBM;
  const dim3 grid(n_mtiles * n_btiles, 1, K);
  const dim3 block(kCountBB, kCountTY);
  const size_t smem =
      static_cast<size_t>(C) *
      ((kCountBM + kCountBB + 1) * sizeof(float) + sizeof(int));
  count_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const int32_t*>(ops), static_cast<const float*>(thetas),
      static_cast<int32_t*>(out), C, M, B, n_btiles);
  return static_cast<int>(cudaGetLastError());
}


}  // extern "C"
