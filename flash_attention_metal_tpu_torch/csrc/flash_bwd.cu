// Backward flash attention for Hopper (sm_90a), bf16 and fp32: dK/dV and dQ
// (the split pair), and the fused 5-matmul backward.
//
// Replaces the FA-2 split pair of flash_attention_metal_tpu/kernels/
// flash_bwd.py: _dkv_kernel (dK, dV over KV tiles) and _dq_kernel (dQ over
// Q tiles), which the training step reaches through flash_attention_bwd; and
// _fused_bwd_kernel (flash_attention_bwd_fused), which the backward router
// takes where the autotuner's saved decision names it.
//
// Contract, for every batch b, q-head h (KV head h / group), query row r and
// key column c, with row r seeing c when c < n_kv and, when causal,
// c <= r + q_offset[b] (q_offset int32 [B] on the device):
//   P[r,c]  = exp(sm_scale * q[r] . k[c] - lse[r])   (lse: the forward's
//             natural-log row logsumexp; -inf rows take a large finite
//             sentinel, so their P, and every gradient they feed, is 0)
//   dV[c]   = sum_{h in group} sum_r P[r,c] dO[r]
//   dP[r,c] = dO[r] . v[c]
//   dS[r,c] = P[r,c] (dP[r,c] - delta[r])   (delta = rowsum(dO o O) - dlse,
//             computed by the wrapper)
//   dK[c]   = sm_scale * sum_{h in group} sum_r dS[r,c] q[r]
//   dQ[r]   = sm_scale * sum_c dS[r,c] k[c]
// Products and sums accumulate in fp32; P and dS enter the bf16 products
// rounded to bf16 (the JAX kernels do the same).  fp32 inputs use plain
// IEEE FMA (never TF32).  dK and dV come out in k's dtype, dQ in q's.
//
// GQA is native: one dK/dV block per (KV tile, KV head, batch) loops over
// the group's q-heads and sums them in its fp32 accumulators before the one
// store, and the dQ kernel reads KV head h / group.  Nothing is repeated in
// memory.  The JAX package instead repeats K/V to every q-head and sums the
// per-head dK/dV after rounding them to bf16; the fp32 group sum here is the
// more exact of the two.
//
// Deterministic: each output tile has exactly one owner block and its sums
// run in a fixed order.  No atomics.
//
// The fused backward is the dK/dV kernel with a fifth product per (Q tile,
// KV tile) pair: the pair's dQ contribution dS K, written to its own fp32
// workspace slot in the packed layout of dq_slots.cuh (the triangular
// backward's): one slot per pair visible at off_bound, a host-known bound on
// the offsets (the op's int offset; n_kv - 1, every pair, when the host
// knows none).  Each batch's slots follow its own offset, read no higher
// than the bound.  The shared reduce kernel then sums each Q tile's slots
// in KV-tile order and scales: the dQ kernel's recompute of S, P and dP is
// gone, at the cost of the workspace's traffic.  The JAX kernel keeps the
// partial count at 1-2 with 1024-2048-row KV tiles held in VMEM (its dqp,
// [B, H, n_kv / block_kv, N, D]); a thread block here holds a 64-row tile's
// dK/dV (a 2048-row tile's is 1 MB of fp32).
//
// What bounds it on the H100.  At the training shape (q [4,16,2048,64],
// kv [4,8,2048,64], causal) the two kernels do ~120 GFLOP together, so the
// bound is the tensor cores, not HBM.  This first design reaches far less:
// every product goes through shared memory (WMMA fragments are stored and
// reloaded), a 64 x 64 tile pair needs five barriers, and a dK/dV block
// walks its Q tiles one after the other (group x N / 64 steps).
//
// What the design does about it.
//   * Causal block skipping in both kernels: a dK/dV block starts at the
//     first Q tile whose last row sees its first column, and a dQ block
//     stops at the last KV tile its last row sees.  Skipped tiles are
//     neither loaded nor computed.
//   * K and V (dK/dV) or Q, dO, lse and delta (dQ) load once per block and
//     stay in shared memory; dK/dV and dQ live in fp32 fragments (bf16) or
//     registers (fp32) for the whole walk.
//   * bf16 products run on the tensor cores through WMMA 16x16x16.
// Not yet done (later PRs): wgmma, TMA and a multi-stage copy pipeline;
// one fused pass for dQ and dK/dV.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "dq_slots.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 64;  // query rows per tile
constexpr int kBlockN = 64;  // key columns per tile
constexpr int kHeadDim = 64;
constexpr int kThreads = 2 * kBlockM;  // two threads per tile row, 4 warps
constexpr int kHalf = 32;              // columns per thread of a 64-wide row
static_assert(kBlockM == kBlockN && kBlockN == kHeadDim,
              "a thread's row and half map onto every tile alike");
static_assert(kBlockM == dq_slots::kTile, "a dQ slot is one tile pair");
using dq_slots::batch_offset;
using dq_slots::first_slot;
using dq_slots::last_visible;
using dq_slots::visible_kv_tiles;
// Shared-memory row pitches: padded to spread banks, multiples of 16 bytes
// (vector copies) and of 32 bytes per 16 rows (WMMA pointers).
constexpr int kLdT = kHeadDim + 8;
constexpr int kLdP = kBlockN + 8;
constexpr int kLdS = kBlockN + 4;
constexpr float kLog2e = 1.4426950408889634f;
// Stands in for lse = -inf (a row that sees nothing) and for padding rows:
// exp2(s - kLseSentinel * log2 e) underflows to exactly 0.
constexpr float kLseSentinel = 1e30f;
constexpr int kMaxDevices = 64;

template <typename T>
struct Smem {
  T q[kBlockM * kLdT];
  T k[kBlockN * kLdT];
  T v[kBlockN * kLdT];
  T dout[kBlockM * kLdT];
  T p[kBlockM * kLdP];       // P in the input type: dV's operand
  T ds[kBlockM * kLdP];      // dS in the input type: dK's and dQ's operand
  float s[kBlockM * kLdS];   // scores; dK at the store (bf16)
  float dp[kBlockM * kLdS];  // dO V^T; dV at the store (bf16)
  float lse2[kBlockM];       // row lse in log2 units, sentinel-guarded
  float delta[kBlockM];
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Copy `rows_valid` rows of head_dim elements (row pitch kHeadDim in global
// memory) into a [64][kLdT] shared tile; the other rows are zero.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows_valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = kHeadDim / kVec;
  for (int i = threadIdx.x; i < kBlockM * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * kHeadDim + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = val;
  }
}

// The Q tile's lse (log2 units) and delta; padding rows get the sentinel.
template <typename T>
__device__ __forceinline__ void load_rows(Smem<T>& sm, const float* lse,
                                          const float* delta, int rows_valid) {
  for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
    float l = kLseSentinel, d = 0.0f;
    if (i < rows_valid) {
      const float x = lse[i];
      l = x == -INFINITY ? kLseSentinel : x;
      d = delta[i];
    }
    sm.lse2[i] = l * kLog2e;
    sm.delta[i] = d;
  }
}

using namespace nvcuda;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out[warp's 16 rows][64] = A[rows][:] . B[:][:]^T on the tensor cores;
// A and B are [64][kLdT] tiles (Q K^T, dO V^T).
__device__ __forceinline__ void mm_abt_bf16(const bf16* a, const bf16* b,
                                            float* out, int warp) {
  Acc acc[kBlockN / 16];
#pragma unroll
  for (int n = 0; n < kBlockN / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kHeadDim; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + warp * 16 * kLdT + kk, kLdT);
#pragma unroll
    for (int n = 0; n < kBlockN / 16; ++n) {
      // B^T as a column-major operand: element (d, c) sits at b[c][d].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + n * 16 * kLdT + kk, kLdT);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBlockN / 16; ++n) {
    wmma::store_matrix_sync(out + warp * 16 * kLdS + n * 16, acc[n], kLdS,
                            wmma::mem_row_major);
  }
}

// acc += X^T[warp's 16 columns of X][64] . Y: X is [64 q][kLdP] (P or dS),
// Y is [64 q][kLdT] (dO or Q).  dV += P^T dO and dK += dS^T Q.
__device__ __forceinline__ void mma_atb_bf16(Acc (&acc)[kHeadDim / 16],
                                             const bf16* x, const bf16* y,
                                             int warp) {
#pragma unroll
  for (int kk = 0; kk < kBlockM; kk += 16) {
    // X^T as a column-major operand: element (c, r) sits at x[r][c].
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
    wmma::load_matrix_sync(fa, x + kk * kLdP + warp * 16, kLdP);
#pragma unroll
    for (int n = 0; n < kHeadDim / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, y + kk * kLdT + n * 16, kLdT);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// acc += X[warp's 16 rows][64] . Y: X is [64 q][kLdP] (dS), Y is
// [64 kv][kLdT] (K).  dQ += dS K.
__device__ __forceinline__ void mma_ab_bf16(Acc (&acc)[kHeadDim / 16],
                                            const bf16* x, const bf16* y,
                                            int warp) {
#pragma unroll
  for (int kk = 0; kk < kBlockN; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, x + warp * 16 * kLdP + kk, kLdP);
#pragma unroll
    for (int n = 0; n < kHeadDim / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, y + kk * kLdT + n * 16, kLdT);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

__device__ __forceinline__ void store_acc(float* out, Acc (&acc)[kHeadDim / 16],
                                          int warp) {
#pragma unroll
  for (int n = 0; n < kHeadDim / 16; ++n) {
    wmma::store_matrix_sync(out + warp * 16 * kLdS + n * 16, acc[n], kLdS,
                            wmma::mem_row_major);
  }
}

// fp32 products in IEEE FMA; thread (r, half) owns half of row r.
// out[r][half cols] = A[r][:] . B[half cols][:]
__device__ __forceinline__ void mm_abt_f32(const float* a, const float* b,
                                           float* out, int r, int half) {
  float acc[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) acc[j] = 0.0f;
  for (int d = 0; d < kHeadDim; ++d) {
    const float av = a[r * kLdT + d];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      acc[j] = fmaf(av, b[(half * kHalf + j) * kLdT + d], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kHalf; ++j) out[r * kLdS + half * kHalf + j] = acc[j];
}

// acc[j] += sum_i X[i][c] Y[i][half cols]   (c: this thread's KV row)
__device__ __forceinline__ void mma_atb_f32(float (&acc)[kHalf], const float* x,
                                            const float* y, int c, int half) {
  for (int i = 0; i < kBlockM; ++i) {
    const float xv = x[i * kLdP + c];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      acc[j] = fmaf(xv, y[i * kLdT + half * kHalf + j], acc[j]);
    }
  }
}

// acc[j] += sum_c X[r][c] Y[c][half cols]
__device__ __forceinline__ void mma_ab_f32(float (&acc)[kHalf], const float* x,
                                           const float* y, int r, int half) {
  for (int c = 0; c < kBlockN; ++c) {
    const float xv = x[r * kLdP + c];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      acc[j] = fmaf(xv, y[c * kLdT + half * kHalf + j], acc[j]);
    }
  }
}

// P and dS of one (Q tile, KV tile) pair for this thread's half row, from
// the scores in s and dO V^T in dp.  col_limit: the last column the row
// sees (-1: none, also for padding rows).
template <typename T>
__device__ __forceinline__ void softmax_grad(Smem<T>& sm, int r, int half,
                                             int kv_start, int col_limit,
                                             float scale_log2) {
  const float lse2 = sm.lse2[r];
  const float delta = sm.delta[r];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int c = half * kHalf + j;
    const float p = kv_start + c <= col_limit
                        ? exp2f(sm.s[r * kLdS + c] * scale_log2 - lse2)
                        : 0.0f;
    const float ds = p * (sm.dp[r * kLdS + c] - delta);
    sm.p[r * kLdP + c] = from_float<T>(p);
    sm.ds[r * kLdP + c] = from_float<T>(ds);
  }
}

// S = Q K^T and dP = dO V^T of the current tiles.
template <typename T>
__device__ __forceinline__ void scores_and_dp(Smem<T>& sm, int warp, int r,
                                              int half) {
  if constexpr (std::is_same<T, bf16>::value) {
    mm_abt_bf16(sm.q, sm.k, sm.s, warp);
    mm_abt_bf16(sm.dout, sm.v, sm.dp, warp);
  } else {
    mm_abt_f32(sm.q, sm.k, sm.s, r, half);
    mm_abt_f32(sm.dout, sm.v, sm.dp, r, half);
  }
}

// One block per (KV tile, KV head, batch): dK and dV of the tile, summed
// over the group's q-heads and their visible Q tiles.  kFused: also each
// visible pair's dQ contribution (unscaled) into its slot of dq_ws, which
// holds n_pairs slots per q-head (dq_slots.cuh).  q_offset: per-batch
// offsets read no higher than off_bound; null: off_bound for every batch.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ q_offset, int off_bound,
                         T* __restrict__ dk, T* __restrict__ dv,
                         float* __restrict__ dq_ws, int n_pairs, int n_heads,
                         int n_kv_heads, int n_q, int n_kv, float sm_scale,
                         float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  constexpr bool kBf16 = std::is_same<T, bf16>::value;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r = tid >> 1;    // tile row: a Q row in the walk, a KV row at the store
  const int half = tid & 1;  // which half of the row's columns it owns
  const int kv_start = blockIdx.x * kBlockN;
  const int h_kv = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv_heads;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;
  const int cols_valid = min(kBlockN, n_kv - kv_start);
  const int off = batch_offset(q_offset, b, off_bound);
  // Rows r >= kv_start - off see the tile's first column; earlier Q tiles
  // see none of it and are skipped.
  const int q_first = max(0, kv_start - off) / kBlockM;
  const int n_q_tiles = (n_q + kBlockM - 1) / kBlockM;

  load_tile<T>(sm.k, k + (kv_rows + kv_start) * kHeadDim, cols_valid);
  load_tile<T>(sm.v, v + (kv_rows + kv_start) * kHeadDim, cols_valid);

  Acc dk_acc[kHeadDim / 16], dv_acc[kHeadDim / 16];
  float dk_reg[kHalf], dv_reg[kHalf];
  if constexpr (kBf16) {
#pragma unroll
    for (int n = 0; n < kHeadDim / 16; ++n) {
      wmma::fill_fragment(dk_acc[n], 0.0f);
      wmma::fill_fragment(dv_acc[n], 0.0f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kHalf; ++j) dk_reg[j] = dv_reg[j] = 0.0f;
  }

  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)b * n_heads + h_kv * group + g;
    const size_t q_rows = bh * n_q;
    int slot = kFused ? first_slot(q_first, n_q, n_kv, off) : 0;  // Q tile qt's first
    for (int qt = q_first; qt < n_q_tiles; ++qt) {
      const int q_start = qt * kBlockM;
      const int rows_valid = min(kBlockM, n_q - q_start);
      load_tile<T>(sm.q, q + (q_rows + q_start) * kHeadDim, rows_valid);
      load_tile<T>(sm.dout, dout + (q_rows + q_start) * kHeadDim, rows_valid);
      load_rows(sm, lse + q_rows + q_start, delta + q_rows + q_start, rows_valid);
      __syncthreads();

      scores_and_dp(sm, warp, r, half);
      __syncthreads();

      softmax_grad(sm, r, half, kv_start, last_visible(q_start + r, n_q, n_kv, off),
                   scale_log2);
      __syncthreads();

      if constexpr (kBf16) {
        mma_atb_bf16(dv_acc, sm.p, sm.dout, warp);
        mma_atb_bf16(dk_acc, sm.ds, sm.q, warp);
      } else {
        mma_atb_f32(dv_reg, sm.p, sm.dout, r, half);
        mma_atb_f32(dk_reg, sm.ds, sm.q, r, half);
      }
      // Row kv_start - off can fall past a ragged last Q tile's valid rows:
      // that tile sees nothing of this KV tile and has no slot for it.
      const int n_cols = kFused ? visible_kv_tiles(qt, n_q, n_kv, off) : 0;
      if (kFused && (int)blockIdx.x < n_cols) {
        // The pair's slot: 64 x 64 fp32, whole tiles.
        float* ws = dq_ws + (bh * n_pairs + slot + blockIdx.x) * dq_slots::kTileElems;
        if constexpr (kBf16) {
          Acc dq_acc[kHeadDim / 16];
#pragma unroll
          for (int n = 0; n < kHeadDim / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.0f);
          mma_ab_bf16(dq_acc, sm.ds, sm.k, warp);
#pragma unroll
          for (int n = 0; n < kHeadDim / 16; ++n) {
            wmma::store_matrix_sync(ws + warp * 16 * kHeadDim + n * 16, dq_acc[n],
                                    kHeadDim, wmma::mem_row_major);
          }
        } else {
          float dq_reg[kHalf];
#pragma unroll
          for (int j = 0; j < kHalf; ++j) dq_reg[j] = 0.0f;
          mma_ab_f32(dq_reg, sm.ds, sm.k, r, half);
#pragma unroll
          for (int j = 0; j < kHalf; ++j) ws[r * kHeadDim + half * kHalf + j] = dq_reg[j];
        }
      }
      slot += n_cols;
      // The next tile's loads overwrite q, dout, lse2 and delta.
      __syncthreads();
    }
  }

  if constexpr (kBf16) {
    // Warp w holds KV rows 16w..16w+15; thread (r, half) stores row r.
    store_acc(sm.s, dk_acc, warp);
    store_acc(sm.dp, dv_acc, warp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      dk_reg[j] = sm.s[r * kLdS + half * kHalf + j];
      dv_reg[j] = sm.dp[r * kLdS + half * kHalf + j];
    }
  }
  if (r < cols_valid) {
    const size_t at = (kv_rows + kv_start + r) * kHeadDim + half * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      dk[at + j] = from_float<T>(dk_reg[j] * sm_scale);
      dv[at + j] = from_float<T>(dv_reg[j]);
    }
  }
}

// One block per (Q tile, q-head, batch): dQ of the tile over its visible
// KV tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ q_offset, int off_bound,
                        T* __restrict__ dq, int n_heads, int n_kv_heads, int n_q,
                        int n_kv, float sm_scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  constexpr bool kBf16 = std::is_same<T, bf16>::value;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int q_start = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int h_kv = h / (n_heads / n_kv_heads);
  const size_t q_rows = ((size_t)b * n_heads + h) * n_q;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;
  const int rows_valid = min(kBlockM, n_q - q_start);
  const int off = batch_offset(q_offset, b, off_bound);
  const int col_limit = last_visible(q_start + r, n_q, n_kv, off);
  // The KV walk stops at the last tile any row of the tile sees.
  const int n_steps = visible_kv_tiles(blockIdx.x, n_q, n_kv, off);

  load_tile<T>(sm.q, q + (q_rows + q_start) * kHeadDim, rows_valid);
  load_tile<T>(sm.dout, dout + (q_rows + q_start) * kHeadDim, rows_valid);
  load_rows(sm, lse + q_rows + q_start, delta + q_rows + q_start, rows_valid);

  Acc dq_acc[kHeadDim / 16];
  float dq_reg[kHalf];
  if constexpr (kBf16) {
#pragma unroll
    for (int n = 0; n < kHeadDim / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.0f);
  } else {
#pragma unroll
    for (int j = 0; j < kHalf; ++j) dq_reg[j] = 0.0f;
  }

  for (int step = 0; step < n_steps; ++step) {
    const int kv_start = step * kBlockN;
    const int cols_valid = min(kBlockN, n_kv - kv_start);
    load_tile<T>(sm.k, k + (kv_rows + kv_start) * kHeadDim, cols_valid);
    load_tile<T>(sm.v, v + (kv_rows + kv_start) * kHeadDim, cols_valid);
    __syncthreads();

    scores_and_dp(sm, warp, r, half);
    __syncthreads();

    softmax_grad(sm, r, half, kv_start, col_limit, scale_log2);
    __syncthreads();

    if constexpr (kBf16) {
      mma_ab_bf16(dq_acc, sm.ds, sm.k, warp);
    } else {
      mma_ab_f32(dq_reg, sm.ds, sm.k, r, half);
    }
    // The next step's loads overwrite k and v.
    __syncthreads();
  }

  if constexpr (kBf16) {
    store_acc(sm.s, dq_acc, warp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kHalf; ++j) dq_reg[j] = sm.s[r * kLdS + half * kHalf + j];
  }
  if (r < rows_valid) {
    const size_t at = (q_rows + q_start + r) * kHeadDim + half * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) dq[at + j] = from_float<T>(dq_reg[j] * sm_scale);
  }
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *q_offset;
  int batch, n_heads, n_kv_heads, n_q, n_kv, causal;
  float sm_scale;
  cudaStream_t stream;
  // The kernels' offsets: q_offset read no higher than off_bound when
  // causal, else n_kv - 1 (every column) with no read.  The split pair's
  // bound is n_kv - 1, which sees what any higher offset sees.
  const int* offsets() const {
    return causal ? static_cast<const int*>(q_offset) : nullptr;
  }
  int bound(int off_bound) const { return causal ? off_bound : n_kv - 1; }
};

// The dK/dV kernel; kFused adds the dQ slots of dq_ws (n_pairs per q-head).
template <typename T, bool kFused>
cudaError_t launch_dkv(const Args& a, int off_bound, void* dk, void* dv, void* dq_ws,
                       int n_pairs) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(Smem<T>);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, kFused>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + kBlockN - 1) / kBlockN, a.n_kv_heads, a.batch);
  flash_bwd_dkv_kernel<T, kFused><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      a.offsets(), a.bound(off_bound), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dq_ws), n_pairs, a.n_heads, a.n_kv_heads, a.n_q, a.n_kv,
      a.sm_scale, a.sm_scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fused(const Args& a, int off_bound, void* dk, void* dv, void* dq,
                         void* dq_ws, int n_pairs) {
  cudaError_t err = launch_dkv<T, true>(a, off_bound, dk, dv, dq_ws, n_pairs);
  if (err != cudaSuccess) return err;
  return dq_slots::launch_reduce<T>(static_cast<const float*>(dq_ws), a.offsets(),
                                    a.bound(off_bound), static_cast<T*>(dq), a.batch,
                                    a.n_heads, a.n_q, a.n_kv, n_pairs, a.sm_scale,
                                    a.stream);
}

template <typename T>
cudaError_t launch_dq(const Args& a, void* dq) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(Smem<T>);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + kBlockM - 1) / kBlockM, a.n_heads, a.batch);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      a.offsets(), a.bound(a.n_kv - 1), static_cast<T*>(dq), a.n_heads,
      a.n_kv_heads, a.n_q, a.n_kv, a.sm_scale, a.sm_scale * kLog2e);
  return cudaGetLastError();
}

bool valid(int batch, int n_heads, int n_kv_heads, int n_q, int n_kv,
           int head_dim) {
  return head_dim == kHeadDim && n_kv_heads >= 1 && n_heads % n_kv_heads == 0 &&
         batch >= 1 && n_q >= 1 && n_kv >= 1;
}

}  // namespace

// C entry points, bound with ctypes (kernels/flash_bwd.py).  Pointers are
// device pointers of contiguous tensors: q, dout [B, H, N_q, 64]; k, v,
// dk, dv [B, H_kv, N_kv, 64]; lse, delta fp32 [B, H, N_q]; q_offset int32
// [B] (read only when causal).  dtype: 0 = bf16, 1 = fp32.  Each returns
// its launch's cudaError_t (0 on success).
extern "C" int fam_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_offset,
                                 void* dk, void* dv, int batch, int n_heads,
                                 int n_kv_heads, int n_q, int n_kv,
                                 int head_dim, float sm_scale, int causal,
                                 int dtype, void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, dout, lse, delta, q_offset, batch, n_heads, n_kv_heads,
               n_q, n_kv, causal, sm_scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_dkv<bf16, false>(a, n_kv - 1, dk, dv, nullptr, 0);
  if (dtype == 1) return (int)launch_dkv<float, false>(a, n_kv - 1, dk, dv, nullptr, 0);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fam_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* q_offset,
                                void* dq, int batch, int n_heads,
                                int n_kv_heads, int n_q, int n_kv, int head_dim,
                                float sm_scale, int causal, int dtype,
                                void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, dout, lse, delta, q_offset, batch, n_heads, n_kv_heads,
               n_q, n_kv, causal, sm_scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_dq<bf16>(a, dq);
  if (dtype == 1) return (int)launch_dq<float>(a, dq);
  return (int)cudaErrorInvalidValue;
}

// Slots of one head's packed dQ workspace (dq_slots.cuh) when row r sees
// columns c <= r + off: the fused backward's n_pairs at its off_bound
// (n_kv - 1 when not causal), the triangular backward's at its offset.
extern "C" int fam_bwd_dq_pairs(int n_q, int n_kv, int off) {
  return dq_slots::visible_pairs(n_q, n_kv, off);
}

// The fused backward: dk, dv as above, dq [B, H, N_q, 64]; dq_ws fp32
// [B * H * n_pairs, 64, 64] with n_pairs = fam_bwd_dq_pairs(n_q, n_kv,
// off_bound) (causal) or fam_bwd_dq_pairs(n_q, n_kv, n_kv - 1).  When
// causal, each q_offset entry is read no higher than off_bound.
extern "C" int fam_flash_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* q_offset,
                                   void* dk, void* dv, void* dq, void* dq_ws,
                                   int n_pairs, int off_bound, int batch, int n_heads,
                                   int n_kv_heads, int n_q, int n_kv, int head_dim,
                                   float sm_scale, int causal, int dtype,
                                   void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim) ||
      n_pairs != dq_slots::visible_pairs(n_q, n_kv, causal ? off_bound : n_kv - 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, dout, lse, delta, q_offset, batch, n_heads, n_kv_heads,
               n_q, n_kv, causal, sm_scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_fused<bf16>(a, off_bound, dk, dv, dq, dq_ws, n_pairs);
  if (dtype == 1) return (int)launch_fused<float>(a, off_bound, dk, dv, dq, dq_ws, n_pairs);
  return (int)cudaErrorInvalidValue;
}
