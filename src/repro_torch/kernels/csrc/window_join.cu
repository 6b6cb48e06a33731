// Hand-written Hopper (sm_90a) kernels for the CEP masked windowed join.
//
// All join kernels evaluate, for K fleet partitions at once (grid.z = K),
//
//     ok[k, m, b] = AND_c cmp(op[k, c], L[k, c, m], R[k, c, b], theta[k, c])
//
// where theta[k, c] is thetas[k * th_stride + c]: th_stride 0 shares one
// (C,) vector across the batch (the order and tree engines), th_stride C
// gives every batch row its own (the rulebook, whose rules differ in
// window and predicate thresholds along the batch axis).  Every strip
// launcher takes the stride.
//
// with the literal f32 comparison forms l < r + theta, l > r - theta and
// fabsf(l - r) <= theta.  The thresholds are never folded and the file must
// not be built with --use_fast_math (its -ftz=true flushes denormals, which
// changes comparisons): every kernel is bit-identical to its plain
// PyTorch version in repro_torch/kernels/ref.py.
//
// Four kernels share one body (strip_body): a block evaluates a strip of
// 32 rows of one partition against all of B, and its epilogue is chosen at
// compile time.  The two joins that feed a compaction (packed_kernel,
// join_kernel) emit the mask as bit words, (K, M, ceil(B/32)) int32 with
// bit j of word w in row m the cell b = 32 w + j (tail bits past B are 0),
// plus each row's survivor count (K, M) int32.  rowcount_kernel emits the
// row counts alone and count_kernel one total per partition.
// select_kernel turns a join's words and counts into the row-major
// survivor indices of a fixed-size compaction, reading only the rows that
// hold a survivor below the capacity: no byte or int32 per cell reaches
// device memory.
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

// ---------------------------------------------------------------------------
// The strip body: packed_kernel, join_kernel, rowcount_kernel, count_kernel
// ---------------------------------------------------------------------------
//
// packed_kernel replaces: src/repro/kernels/window_join.py,
// window_join_packed_pallas / _packed_kernel (the pallas_call at :295):
//   ok[k, m, b] = mv[k, m] & bv[k, b] & AND_c sel_c, with
//   sel_c = (lt & op==1) | (gt & op==2) | (ab & op==3) | (op==0)
//   (int8 op codes outside 0..3 select nothing).  Out: bit words and row
//   counts.
// join_kernel replaces: src/repro/kernels/window_join.py,
// window_join_pallas / _kernel (the pallas_call at :120):
//   ok[k, m, b] = AND_c cmp(op[k, c], L, R, th[k, c]) with the unpacked
//   dispatch of ref.cmp_op (1 lt, 2 gt, 3 abs, any other code true;
//   validity enters as two ordinary f32 rows).  Out: bit words and row
//   counts.
// rowcount_kernel replaces: src/repro/kernels/window_join.py,
// window_join_rowcount_pallas / _rowcount_kernel (the pallas_call at
// :383):
//   cnt[k, m] = sum_{b < B} ok[k, m, b] with join_kernel's ok.  Out: row
//   counts (K, M) int32 only.  Op codes outside 0..3: the JAX package's
//   reference (window_join_rowcount_ref, through cmp_op) takes them as
//   true, its Pallas _rowcount_kernel (:342-343, the packed dispatch) as
//   selecting nothing.  The engines emit only 0..3 (PRED_*,
//   src/repro/core/patterns.py:35-38), so no system result differs; this
//   kernel follows cmp_op.
// count_kernel replaces: src/repro/kernels/window_join.py,
// window_join_count_pallas / _count_kernel (the pallas_call at :202):
//   cnt[k] = sum_{m < M, b < B} ok[k, m, b] with join_kernel's ok.  Out:
//   (K,) int32, which the caller zeroes.
//
// Bound on the H100: operations, for all four.  Per (cell, active row)
// one f32 compare (abs: a subtract too) and the AND, plus the count's add
// per cell; the bytes are the (C, M) + (C, B) operand strips and the
// outputs -- M*W/8 of a byte-mask's M*B bytes for the words, M or 1 ints
// per partition for the counts.  At the paths' shapes (chip_smoke.py's
// *_bound): rowcount (16, 6, 8192, 1024) 0.023 ms, join and count
// (16, 9, 8192, 8192) 0.258 and 0.274 ms, packed (16, 8, 8192, 1024)
// 0.009 ms.
//
// Design against that bound: make each (cell, row) cost about two
// instructions and skip what cannot survive.  A block owns a strip of
// kStripM = 32 rows of one partition and walks all of B, its kBitsWarps
// warps taking interleaved 32-column words.  A lane holds one column b and
// a 32-bit accumulator with one bit per row of the strip, so the row loop
// is unrolled in registers: per constraint row c the block-uniform op is
// branched on once (no per-cell dispatch), the lane's R value (and r + th
// or r - th, the same f32 sums the literal forms compute) sits in a
// register, and the strip's 32 L values are read as 8 broadcast float4
// loads from shared memory.  R values are read coalesced straight into
// registers kCGroup rows at a time (C <= 16 covers every path in one
// group; wider stacks up to kMaxC loop over groups); at the row count's
// shape R is 24 KB per partition and stays in L2, so no cp.async / TMA
// stage is kept for it.  When no cell of the warp's 32 x 32 tile survives,
// the remaining rows are skipped (a uniform vote) -- on the engine's
// stacks the validity rows come first, so tiles of empty match slots end
// at the first row.  Rows past M start the accumulator at 0 and columns
// past B are never set, so ragged edges are masked by index: an all-op-0
// stack counts exactly B per row and M*B per partition.
//
// The epilogues (Out):
// - kBitsAndRows: a 5-step shuffle transpose turns the lanes' column
//   accumulators into row words (lane i: row m0 + i), whose __popc is the
//   row's survivor count among the warp's columns; the words go through a
//   padded shared tile so each row's kBitsWarps words are stored
//   contiguously (two barriers per word group).
// - kRows: the same transpose and __popc, but no word is stored, so there
//   is no tile and no barrier: each warp walks its words on its own.
// - kTotal: no transpose either: a lane adds the __popc of its column
//   accumulator, and the block's sum goes to the partition's total with
//   one int32 atomicAdd per strip (exact in any block order).
// Row counts are per-warp partials summed in shared memory at the end:
// exact integer sums, no atomics.
// Left for later: fusing the selection into the join so the bit words
// never leave the SM.

constexpr int kStripM = 32;    // rows per block: one accumulator bit each
constexpr int kBitsWarps = 8;  // warps per block, interleaved over words
constexpr int kCGroup = 16;    // R values a lane holds in registers
constexpr unsigned kFull = 0xffffffffu;

enum class Out { kBitsAndRows, kRows, kTotal };

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

// The accumulator of column b (this lane's) against the strip: bit i is
// set iff cell (m0 + i, b) survives every constraint row.  Warp-uniform
// control: every lane of the warp calls it.
template <bool kPacked>
__device__ __forceinline__ unsigned column(const float* __restrict__ Rk,
                                           const uint8_t* __restrict__ bvk,
                                           const float* sL, const float* sTh,
                                           const int* sOp, unsigned init,
                                           int C, int B, int b) {
  unsigned acc = 0;
  if (b < B) acc = (!kPacked || bvk[b] != 0) ? init : 0u;
  for (int c0 = 0; c0 < C && __any_sync(kFull, acc); c0 += kCGroup) {
    float rv[kCGroup];
#pragma unroll
    for (int j = 0; j < kCGroup; ++j) {
      rv[j] = (c0 + j < C && b < B) ? Rk[static_cast<size_t>(c0 + j) * B + b]
                                    : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kCGroup; ++j) {
      const int c = c0 + j;
      if (c >= C || !__any_sync(kFull, acc)) break;
      acc = join_row<kPacked>(acc, sOp[c], sL + c * kStripM, rv[j], sTh[c]);
    }
  }
  return acc;
}

// Shared memory of a strip block: L strip, thresholds, ops, the per-warp
// partials and (bit words only) the padded word tile.
template <Out kOut>
size_t strip_smem(int C) {
  return static_cast<size_t>(C) * (kStripM + 2) * sizeof(float) +
         kBitsWarps * 32 * sizeof(int) +
         (kOut == Out::kBitsAndRows
              ? kStripM * (kBitsWarps + 1) * sizeof(unsigned)
              : 0);
}

template <typename OpT, bool kPacked, Out kOut>
__device__ __forceinline__ void strip_body(
    const float* __restrict__ L, const float* __restrict__ R,
    const OpT* __restrict__ ops, const float* __restrict__ thetas,
    const uint8_t* __restrict__ mvalid, const uint8_t* __restrict__ bvalid,
    int32_t* __restrict__ bits, int32_t* __restrict__ counts, int C, int M,
    int B, int W, int th_stride) {
  extern __shared__ float4 smem4[];
  float* sL = reinterpret_cast<float*>(smem4);                    // (C, 32)
  float* sTh = sL + C * kStripM;                                  // (C,)
  int* sOp = reinterpret_cast<int*>(sTh + C);                     // (C,)
  int* part = sOp + C;                                  // (kBitsWarps, 32)
  unsigned* tile = reinterpret_cast<unsigned*>(part + kBitsWarps * 32);

  const int k = blockIdx.z;
  const int m0 = blockIdx.x * kStripM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* Lk = L + static_cast<size_t>(k) * C * M;
  const float* Rk = R + static_cast<size_t>(k) * C * B;
  const uint8_t* bvk = kPacked ? bvalid + static_cast<size_t>(k) * B
                               : nullptr;
  for (int i = threadIdx.x; i < C * kStripM; i += blockDim.x) {
    const int c = i / kStripM, m = m0 + i % kStripM;
    sL[i] = m < M ? Lk[static_cast<size_t>(c) * M + m] : 0.0f;
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    sTh[i] = thetas[static_cast<size_t>(k) * th_stride + i];
    sOp[i] = static_cast<int>(ops[static_cast<size_t>(k) * C + i]);
  }
  // Rows of the strip a cell may survive in: below M and (packed) valid.
  const int m = m0 + lane;
  const unsigned init = __ballot_sync(
      kFull,
      m < M && (!kPacked || mvalid[static_cast<size_t>(k) * M + m] != 0));
  __syncthreads();

  // kBitsAndRows, kRows: survivors of row m0 + lane among this warp's
  // words; kTotal: survivors in this lane's columns.
  int cnt = 0;
  if (kOut == Out::kBitsAndRows) {
    for (int w0 = 0; w0 < W; w0 += kBitsWarps) {
      const int w = w0 + warp;
      const unsigned acc =  // w is warp-uniform
          w < W ? column<kPacked>(Rk, bvk, sL, sTh, sOp, init, C, B,
                                  w * 32 + lane)
                : 0u;
      const unsigned word = transpose32(acc, lane);  // lane i: row m0 + i
      cnt += __popc(word);
      tile[lane * (kBitsWarps + 1) + warp] = word;
      __syncthreads();
      {
        const int row = threadIdx.x / kBitsWarps;
        const int q = threadIdx.x % kBitsWarps;
        const int mm = m0 + row, ww = w0 + q;
        if (mm < M && ww < W) {
          bits[(static_cast<size_t>(k) * M + mm) * W + ww] =
              static_cast<int32_t>(tile[row * (kBitsWarps + 1) + q]);
        }
      }
      __syncthreads();  // the tile is consumed before the next words
    }
  } else {
    for (int w = warp; w < W; w += kBitsWarps) {
      const unsigned acc =
          column<kPacked>(Rk, bvk, sL, sTh, sOp, init, C, B, w * 32 + lane);
      cnt += __popc(kOut == Out::kRows ? transpose32(acc, lane) : acc);
    }
  }
  part[warp * 32 + lane] = cnt;
  __syncthreads();
  if (threadIdx.x < 32) {
    int total = 0;
#pragma unroll
    for (int q = 0; q < kBitsWarps; ++q) total += part[q * 32 + threadIdx.x];
    if (kOut == Out::kTotal) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        total += __shfl_down_sync(kFull, total, off);
      }
      if (threadIdx.x == 0 && total != 0) atomicAdd(counts + k, total);
    } else {
      const int mm = m0 + threadIdx.x;
      if (mm < M) counts[static_cast<size_t>(k) * M + mm] = total;
    }
  }
}

__global__ void __launch_bounds__(kBitsWarps * 32)
    packed_kernel(const float* __restrict__ L, const float* __restrict__ R,
                  const int8_t* __restrict__ ops,
                  const float* __restrict__ thetas,
                  const uint8_t* __restrict__ mvalid,
                  const uint8_t* __restrict__ bvalid,
                  int32_t* __restrict__ bits, int32_t* __restrict__ counts,
                  int C, int M, int B, int W, int th_stride) {
  strip_body<int8_t, true, Out::kBitsAndRows>(L, R, ops, thetas, mvalid,
                                              bvalid, bits, counts, C, M, B,
                                              W, th_stride);
}

__global__ void __launch_bounds__(kBitsWarps * 32)
    join_kernel(const float* __restrict__ L, const float* __restrict__ R,
                const int32_t* __restrict__ ops,
                const float* __restrict__ thetas,
                int32_t* __restrict__ bits, int32_t* __restrict__ counts,
                int C, int M, int B, int W, int th_stride) {
  strip_body<int32_t, false, Out::kBitsAndRows>(
      L, R, ops, thetas, nullptr, nullptr, bits, counts, C, M, B, W,
      th_stride);
}

__global__ void __launch_bounds__(kBitsWarps * 32)
    rowcount_kernel(const float* __restrict__ L, const float* __restrict__ R,
                    const int32_t* __restrict__ ops,
                    const float* __restrict__ thetas,
                    int32_t* __restrict__ counts, int C, int M, int B,
                    int W, int th_stride) {
  strip_body<int32_t, false, Out::kRows>(L, R, ops, thetas, nullptr,
                                         nullptr, nullptr, counts, C, M, B,
                                         W, th_stride);
}

__global__ void __launch_bounds__(kBitsWarps * 32)
    count_kernel(const float* __restrict__ L, const float* __restrict__ R,
                 const int32_t* __restrict__ ops,
                 const float* __restrict__ thetas,
                 int32_t* __restrict__ total, int C, int M, int B, int W,
                 int th_stride) {
  strip_body<int32_t, false, Out::kTotal>(L, R, ops, thetas, nullptr,
                                          nullptr, nullptr, total, C, M, B,
                                          W, th_stride);
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

// The grid of a strip launch: one block per 32-row strip of each partition.
dim3 strip_grid(int K, int M) {
  return dim3((M + kStripM - 1) / kStripM, 1, K);
}

}  // namespace

extern "C" {

int wj_max_c() { return kMaxC; }

const char* wj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// L (K,C,M) f32, R (K,C,B) f32, ops (K,C) i8, thetas (C,) f32 with
// th_stride 0 or (K,C) f32 with th_stride C, mvalid (K,M) u8,
// bvalid (K,B) u8 -> bits (K,M,ceil(B/32)) i32, counts (K,M) i32.
int wj_packed(const void* L, const void* R, const void* ops,
              const void* thetas, const void* mvalid, const void* bvalid,
              void* bits, void* counts, int K, int C, int M, int B,
              int th_stride, void* stream) {
  if (C < 0 || C > kMaxC || (th_stride != 0 && th_stride != C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  packed_kernel<<<strip_grid(K, M), kBitsWarps * 32,
                  strip_smem<Out::kBitsAndRows>(C),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const int8_t*>(ops), static_cast<const float*>(thetas),
      static_cast<const uint8_t*>(mvalid),
      static_cast<const uint8_t*>(bvalid), static_cast<int32_t*>(bits),
      static_cast<int32_t*>(counts), C, M, B, (B + 31) / 32, th_stride);
  return static_cast<int>(cudaGetLastError());
}

// L (K,C,M) f32, R (K,C,B) f32, ops (K,C) i32, thetas (C,) f32 with
// th_stride 0 or (K,C) f32 with th_stride C -> out (K,M) i32.
int wj_rowcount(const void* L, const void* R, const void* ops,
                const void* thetas, void* out, int K, int C, int M, int B,
                int th_stride, void* stream) {
  if (C < 0 || C > kMaxC || (th_stride != 0 && th_stride != C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rowcount_kernel<<<strip_grid(K, M), kBitsWarps * 32,
                    strip_smem<Out::kRows>(C),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const int32_t*>(ops), static_cast<const float*>(thetas),
      static_cast<int32_t*>(out), C, M, B, (B + 31) / 32, th_stride);
  return static_cast<int>(cudaGetLastError());
}

// L (K,C,M) f32, R (K,C,B) f32, ops (K,C) i32, thetas (C,) f32 with
// th_stride 0 or (K,C) f32 with th_stride C -> bits (K,M,ceil(B/32)) i32,
// counts (K,M) i32.
int wj_join(const void* L, const void* R, const void* ops,
            const void* thetas, void* bits, void* counts, int K, int C,
            int M, int B, int th_stride, void* stream) {
  if (C < 0 || C > kMaxC || (th_stride != 0 && th_stride != C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  join_kernel<<<strip_grid(K, M), kBitsWarps * 32,
                strip_smem<Out::kBitsAndRows>(C),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const int32_t*>(ops), static_cast<const float*>(thetas),
      static_cast<int32_t*>(bits), static_cast<int32_t*>(counts), C, M, B,
      (B + 31) / 32, th_stride);
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

// L (K,C,M) f32, R (K,C,B) f32, ops (K,C) i32, thetas (C,) f32 with
// th_stride 0 or (K,C) f32 with th_stride C -> out (K,) i32, which the
// caller zeroes before the launch.
int wj_count(const void* L, const void* R, const void* ops,
             const void* thetas, void* out, int K, int C, int M, int B,
             int th_stride, void* stream) {
  if (C < 0 || C > kMaxC || (th_stride != 0 && th_stride != C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  count_kernel<<<strip_grid(K, M), kBitsWarps * 32,
                 strip_smem<Out::kTotal>(C),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const int32_t*>(ops), static_cast<const float*>(thetas),
      static_cast<int32_t*>(out), C, M, B, (B + 31) / 32, th_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
