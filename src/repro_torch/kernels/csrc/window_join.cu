// Hand-written Hopper (sm_90a) kernels for the CEP masked windowed join.
//
// All four kernels evaluate, for K fleet partitions at once (grid.z = K),
//
//     ok[k, m, b] = AND_c cmp(op[k, c], L[k, c, m], R[k, c, b], theta[c])
//
// with the literal f32 comparison forms l < r + theta, l > r - theta and
// fabsf(l - r) <= theta.  The thresholds are never folded and the file must
// not be built with --use_fast_math (its -ftz=true flushes denormals, which
// changes comparisons): every kernel is bit-identical to its plain
// PyTorch version in repro_torch/kernels/ref.py.
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
// Packed join
// ---------------------------------------------------------------------------
//
// Replaces: src/repro/kernels/window_join.py, window_join_packed_pallas /
// _packed_kernel (the pallas_call at :295).
//
// ok[k, m, b] = mv[k, m] & bv[k, b] & AND_c sel_c, with
// sel_c = (lt & op==1) | (gt & op==2) | (ab & op==3) | (op==0).
//
// Bound on the H100: the K*M*B byte mask store (one byte per cell) and C
// compare-selects per cell; the operand strips are (C, M) + (C, B) floats,
// negligible beside the mask.  Design: one thread per (m, b) cell, with
// threadIdx.x along b so the R strip loads and the mask stores are
// coalesced; each block stages its (C, kPackedBM) L strip, (C, kPackedBB) R
// strip and its partition's ops/thresholds in shared memory and loops over
// C.  The ragged edge is masked by index; the validity vectors already zero
// the padding rows, as on the TPU, but the output has no padding.
// Left for later: larger register tiles per thread (several cells each),
// packing the mask to bits (8x fewer store bytes), or fusing the join with
// the compaction that consumes the mask so it never reaches device memory.

constexpr int kPackedBB = 128;  // b per block (threadIdx.x)
constexpr int kPackedBM = 4;    // m per block (threadIdx.y)

__global__ void packed_kernel(const float* __restrict__ L,
                              const float* __restrict__ R,
                              const int8_t* __restrict__ ops,
                              const float* __restrict__ thetas,
                              const uint8_t* __restrict__ mvalid,
                              const uint8_t* __restrict__ bvalid,
                              uint8_t* __restrict__ out,
                              int C, int M, int B, int n_btiles) {
  extern __shared__ float smem[];
  float* sL = smem;                                    // (C, kPackedBM)
  float* sR = sL + C * kPackedBM;                      // (C, kPackedBB)
  float* sTh = sR + C * kPackedBB;                     // (C,)
  int* sOp = reinterpret_cast<int*>(sTh + C);          // (C,)

  const int k = blockIdx.z;
  const int m0 = (blockIdx.x / n_btiles) * kPackedBM;
  const int b0 = (blockIdx.x % n_btiles) * kPackedBB;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const float* Lk = L + static_cast<size_t>(k) * C * M;
  const float* Rk = R + static_cast<size_t>(k) * C * B;

  for (int i = tid; i < C * kPackedBB; i += nthreads) {
    const int c = i / kPackedBB, b = b0 + i % kPackedBB;
    sR[i] = b < B ? Rk[static_cast<size_t>(c) * B + b] : 0.0f;
  }
  for (int i = tid; i < C * kPackedBM; i += nthreads) {
    const int c = i / kPackedBM, m = m0 + i % kPackedBM;
    sL[i] = m < M ? Lk[static_cast<size_t>(c) * M + m] : 0.0f;
  }
  for (int i = tid; i < C; i += nthreads) {
    sTh[i] = thetas[i];
    sOp[i] = ops[static_cast<size_t>(k) * C + i];
  }
  __syncthreads();

  const int m = m0 + threadIdx.y;
  const int b = b0 + threadIdx.x;
  if (m >= M || b >= B) return;
  bool acc = (mvalid[static_cast<size_t>(k) * M + m] != 0) &
             (bvalid[static_cast<size_t>(k) * B + b] != 0);
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float l = sL[c * kPackedBM + threadIdx.y];
    const float r = sR[c * kPackedBB + threadIdx.x];
    const float th = sTh[c];
    const int op = sOp[c];
    const bool lt = l < r + th;
    const bool gt = l > r - th;
    const bool ab = fabsf(l - r) <= th;
    const bool ok = (lt & (op == 1)) | (gt & (op == 2)) | (ab & (op == 3)) |
                    (op == 0);
    acc = acc & ok;
  }
  out[(static_cast<size_t>(k) * M + m) * B + b] = acc ? 1 : 0;
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
// Unpacked join
// ---------------------------------------------------------------------------
//
// Replaces: src/repro/kernels/window_join.py, window_join_pallas / _kernel
// (the pallas_call at :120) — the tree engine's only join.
//
// ok[k, m, b] = AND_c cmp(op[k, c], L[k, c, m], R[k, c, b], th[c]), with
// the unpacked dispatch of cmp_unpacked.  Validity enters as two ordinary
// f32 rows (1.0 > 1 - 0.5 is exact), so there are no validity vectors.
//
// Bound on the H100: the K*M*B byte mask store against 3 f32 operations
// (shift, compare, AND) per active row of each cell; the operand strips
// are (C, M) + (C, B) floats, negligible beside the mask.  Design: as
// packed_kernel, one thread per (m, b) cell with threadIdx.x along b (R
// strip loads and mask stores coalesced), the block's (C, kJoinBM) L
// strip, (C, kJoinBB) R strip and its partition's ops/thresholds staged
// in shared memory, a loop over C.  The ragged edge is masked by index.
// Left for later: register tiles of several cells per thread, a
// bit-packed mask, or fusing the join with the compaction that consumes
// it, so the mask never reaches device memory.

constexpr int kJoinBB = 128;  // b per block (threadIdx.x)
constexpr int kJoinBM = 4;    // m per block (threadIdx.y)

__global__ void join_kernel(const float* __restrict__ L,
                            const float* __restrict__ R,
                            const int32_t* __restrict__ ops,
                            const float* __restrict__ thetas,
                            uint8_t* __restrict__ out,
                            int C, int M, int B, int n_btiles) {
  extern __shared__ float smem[];
  float* sL = smem;                                    // (C, kJoinBM)
  float* sR = sL + C * kJoinBM;                        // (C, kJoinBB)
  float* sTh = sR + C * kJoinBB;                       // (C,)
  int* sOp = reinterpret_cast<int*>(sTh + C);          // (C,)

  const int k = blockIdx.z;
  const int m0 = (blockIdx.x / n_btiles) * kJoinBM;
  const int b0 = (blockIdx.x % n_btiles) * kJoinBB;
  stage_unpacked(L, R, ops, thetas, sL, sR, sTh, sOp, k, C, M, B, m0,
                 kJoinBM, b0, kJoinBB, threadIdx.y * blockDim.x + threadIdx.x,
                 blockDim.x * blockDim.y);
  __syncthreads();

  const int m = m0 + threadIdx.y;
  const int b = b0 + threadIdx.x;
  if (m >= M || b >= B) return;
  bool acc = true;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    acc = acc & cmp_unpacked(sOp[c], sL[c * kJoinBM + threadIdx.y],
                             sR[c * kJoinBB + threadIdx.x], sTh[c]);
  }
  out[(static_cast<size_t>(k) * M + m) * B + b] = acc ? 1 : 0;
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
// mvalid (K,M) u8, bvalid (K,B) u8 -> out (K,M,B) u8.
int wj_packed(const void* L, const void* R, const void* ops,
              const void* thetas, const void* mvalid, const void* bvalid,
              void* out, int K, int C, int M, int B, void* stream) {
  if (C < 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const int n_btiles = (B + kPackedBB - 1) / kPackedBB;
  const int n_mtiles = (M + kPackedBM - 1) / kPackedBM;
  const dim3 grid(n_mtiles * n_btiles, 1, K);
  const dim3 block(kPackedBB, kPackedBM);
  const size_t smem =
      static_cast<size_t>(C) * ((kPackedBM + kPackedBB + 1) * sizeof(float) +
                                sizeof(int));
  packed_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const int8_t*>(ops), static_cast<const float*>(thetas),
      static_cast<const uint8_t*>(mvalid),
      static_cast<const uint8_t*>(bvalid), static_cast<uint8_t*>(out), C, M,
      B, n_btiles);
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
// -> out (K,M,B) u8.
int wj_join(const void* L, const void* R, const void* ops,
            const void* thetas, void* out, int K, int C, int M, int B,
            void* stream) {
  if (C < 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const int n_btiles = (B + kJoinBB - 1) / kJoinBB;
  const int n_mtiles = (M + kJoinBM - 1) / kJoinBM;
  const dim3 grid(n_mtiles * n_btiles, 1, K);
  const dim3 block(kJoinBB, kJoinBM);
  const size_t smem =
      static_cast<size_t>(C) *
      ((kJoinBM + kJoinBB + 1) * sizeof(float) + sizeof(int));
  join_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const int32_t*>(ops), static_cast<const float*>(thetas),
      static_cast<uint8_t*>(out), C, M, B, n_btiles);
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
