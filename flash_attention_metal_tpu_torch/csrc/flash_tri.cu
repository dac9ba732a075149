// Triangular causal attention for Hopper (sm_90a), bf16 and fp32: the
// forward and the fused backward, both with a static causal offset.
//
// Replaces flash_attention_metal_tpu/kernels/flash_tri.py::_tri_kernel
// (forward) and ::_tri_bwd_kernel (backward), the JAX routers' default for
// plain causal calls whose offset is a Python int: the benchmark's causal
// sweep and its high-occupancy phase, and the ladder's rungs 5c, 6, 7b, 7c.
//
// Contract, for every batch b, q-head h (KV head h / group) and query row r,
// with row r seeing column c when c < n_kv and c <= r + q_offset (q_offset
// an int given at launch):
//   forward   o[r] = softmax_c(sm_scale * q[r] . k[c]) . V, and optionally
//             lse[r], the natural-log row logsumexp, fp32 [B, H, N_q]; a row
//             with no visible column gives o = 0 and lse = -inf.
//   backward  (equal head counts) with P[r,c] = exp(sm_scale q[r].k[c] -
//             lse[r]) (lse = -inf takes a 1e30 sentinel: P = 0),
//             dS = P (dO V^T - delta), delta = rowsum(dO o O) - dlse (the
//             wrapper's torch op):  dV = P^T dO, dK = sm_scale dS^T Q,
//             dQ = sm_scale dS K, with S and P computed ONCE per visible
//             (Q tile, KV tile) pair for all three.  dK and dV come back
//             fp32 (as the Pallas kernel's do), dQ in q's type.
// Softmax statistics and products accumulate in fp32; P and dS enter the
// bf16 products rounded to bf16; fp32 inputs use IEEE FMA (never TF32).
//
// What bounds it on the H100.  At the benchmark's high-occupancy shape (B16
// H8 N2048 causal, bf16) the forward does 68.7 GFLOP and the backward
// 171.8 GFLOP against ~34 MB and ~75 MB of I/O: both are bound by the
// tensor cores (0.069 ms and 0.174 ms at 989 TF/s), not by HBM.
//
// What the design does about it.
//   * The offset is static, so each 64-row q tile's visible extent is known
//     at launch.  The forward issues blocks heaviest first: block rank 0
//     takes the q tile with the longest row (the grid's slow axis is the
//     rank, the fast one batch x head), so the grid's tail is short tiles,
//     not the diagonal's longest ones.  flash_fwd.cu, whose offsets are a
//     device array, issues tiles in index order.
//   * Only KV tiles that straddle the diagonal (or the ragged end of the KV
//     row) test visibility; interior tiles skip the compare, the counterpart
//     of flash_tri.py's static mask skip.
//   * The backward is one block per (batch x head, 64-column KV tile), KV
//     tile 0 (the most Q tiles) first.  It keeps dK and dV of its tile in
//     fp32 fragments (bf16) or registers (fp32) over every visible Q tile,
//     and writes each pair's dQ contribution to its own fp32 workspace slot
//     (dq_slots.cuh, shared with the fused backward of flash_bwd.cu).  A
//     second small kernel sums each Q tile's slots in a fixed order and
//     scales.  Every output has one owner and a fixed summation order: the
//     backward is deterministic with no atomics.  The workspace is 16 KB
//     per visible pair (1.1 GB at B16 H8 N2048): ~0.66 ms of HBM traffic
//     written and read back, more than the compute bound.
//   * bf16 products run on the tensor cores through WMMA 16x16x16.
// Not yet done (later PRs): wgmma, TMA and a copy pipeline; dQ kept on chip
// instead of the workspace.

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
using namespace nvcuda;

constexpr int kBlockM = 64;  // query rows per tile
constexpr int kBlockN = 64;  // key columns per tile
constexpr int kHeadDim = 64;
constexpr int kThreads = 2 * kBlockM;  // two threads per tile row, 4 warps
constexpr int kHalf = 32;              // columns per thread of a 64-wide row
static_assert(kBlockM == kBlockN && kBlockN == kHeadDim,
              "a thread's row and half map onto every tile alike");
static_assert(kBlockM == dq_slots::kTile, "a dQ slot is one tile pair");
using dq_slots::kTileElems;
using dq_slots::last_visible;
using dq_slots::visible_kv_tiles;
// Shared-memory row pitches: padded to spread banks, multiples of 16 bytes
// (vector copies) and of 32 bytes per 16 rows (WMMA pointers).
constexpr int kLdT = kHeadDim + 8;
constexpr int kLdP = kBlockN + 8;
constexpr int kLdS = kBlockN + 4;
// Finite mask value (config.DEFAULT_MASK_VALUE): exp2(mask - mask) is never
// NaN, and visibility is tested explicitly, so masked entries add nothing.
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Stands in for lse = -inf (a row that sees nothing) and for padding rows:
// exp2(s - kLseSentinel * log2 e) underflows to exactly 0.
constexpr float kLseSentinel = 1e30f;
constexpr int kMaxDevices = 64;

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

// s[16 warp rows][kHeadDim] = P V on the tensor cores (the forward).
__device__ __forceinline__ void pv_bf16(const bf16* p, const bf16* v, float* out,
                                        int warp) {
  Acc acc[kHeadDim / 16];
#pragma unroll
  for (int n = 0; n < kHeadDim / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kBlockN; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, p + warp * 16 * kLdP + kk, kLdP);
#pragma unroll
    for (int n = 0; n < kHeadDim / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, v + kk * kLdT + n * 16, kLdT);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kHeadDim / 16; ++n) {
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

// acc[j] += sum_c X[r][c] Y[c][half cols]  (P V in the forward, dS K)
__device__ __forceinline__ void mma_ab_f32(float (&acc)[kHalf], const float* x,
                                           int ldx, const float* y, int r,
                                           int half) {
  for (int c = 0; c < kBlockN; ++c) {
    const float xv = x[r * ldx + c];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      acc[j] = fmaf(xv, y[c * kLdT + half * kHalf + j], acc[j]);
    }
  }
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

// ---------------------------------------------------------------------------
// Forward.
// ---------------------------------------------------------------------------

template <typename T>
struct FwdSmem {
  T q[kBlockM * kLdT];
  T k[kBlockN * kLdT];
  T v[kBlockN * kLdT];
  T p[kBlockM * kLdP];      // probabilities, in the input type for PV
  float s[kBlockM * kLdS];  // scores, then the PV product of the step
};

// One block per (batch x q-head, q tile), heaviest tile first.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_tri_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int n_heads, int n_kv_heads,
                         int n_q, int n_kv, float scale_log2, int off) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<T>& sm = *reinterpret_cast<FwdSmem<T>*>(smem_raw);
  constexpr bool kBf16 = std::is_same<T, bf16>::value;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r = tid >> 1;    // this thread's row of the tile
  const int half = tid & 1;  // which half of the row's columns it owns
  // Rank 0 is the last q tile, whose rows see the most columns.
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int h_kv = h / (n_heads / n_kv_heads);
  const size_t q_rows = (size_t)bh * n_q;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;

  const int rows_valid = min(kBlockM, n_q - q_start);
  const bool warp_active = warp * 16 < rows_valid;
  const int row = q_start + r;
  const int col_limit = last_visible(row, n_q, n_kv, off);
  // Every row of the tile sees the columns up to first_limit (the tile's
  // first row's limit): KV tiles ending there need no compare.
  const int first_limit = last_visible(q_start, n_q, n_kv, off);
  const int tile_limit = last_visible(q_start + rows_valid - 1, n_q, n_kv, off);
  const int n_steps = tile_limit < 0 ? 0 : tile_limit / kBlockN + 1;

  load_tile<T>(sm.q, q + (q_rows + q_start) * kHeadDim, rows_valid);

  float o_acc[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) o_acc[j] = 0.0f;
  float m_i = -INFINITY;  // running max, log2 units
  float l_i = 0.0f;       // running sum of exp2(s - m_i)

  for (int step = 0; step < n_steps; ++step) {
    const int kv_start = step * kBlockN;
    const int cols_valid = min(kBlockN, n_kv - kv_start);
    load_tile<T>(sm.k, k + (kv_rows + kv_start) * kHeadDim, cols_valid);
    load_tile<T>(sm.v, v + (kv_rows + kv_start) * kHeadDim, cols_valid);
    __syncthreads();

    if constexpr (kBf16) {
      if (warp_active) mm_abt_bf16(sm.q, sm.k, sm.s, warp);
    } else {
      mm_abt_f32(sm.q, sm.k, sm.s, r, half);
    }
    __syncthreads();

    // Online softmax over this thread's half row; the pair of threads that
    // share a row are lanes 2i and 2i+1 of one warp.
    const bool interior = kv_start + kBlockN - 1 <= first_limit;
    float s_reg[kHalf];
    float step_max = kMaskValue;
    const int col0 = kv_start + half * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float x = interior || col0 + j <= col_limit
                          ? sm.s[r * kLdS + half * kHalf + j] * scale_log2
                          : kMaskValue;
      s_reg[j] = x;
      step_max = fmaxf(step_max, x);
    }
    step_max = fmaxf(step_max, __shfl_xor_sync(0xffffffffu, step_max, 1));
    const float m_new = fmaxf(m_i, step_max);
    const float alpha = exp2f(m_i - m_new);  // 0 on the first step
    float row_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float p =
          interior || col0 + j <= col_limit ? exp2f(s_reg[j] - m_new) : 0.0f;
      row_sum += p;
      sm.p[r * kLdP + half * kHalf + j] = from_float<T>(p);
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    l_i = l_i * alpha + row_sum;
    m_i = m_new;
    __syncthreads();

    if constexpr (kBf16) {
      if (warp_active) pv_bf16(sm.p, sm.v, sm.s, warp);
#pragma unroll
      for (int j = 0; j < kHalf; ++j) o_acc[j] *= alpha;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kHalf; ++j) o_acc[j] += sm.s[r * kLdS + half * kHalf + j];
    } else {
#pragma unroll
      for (int j = 0; j < kHalf; ++j) o_acc[j] *= alpha;
      mma_ab_f32(o_acc, sm.p, kLdP, sm.v, r, half);
    }
    // The next step's loads write k/v only; its first write to s and p
    // comes after the barrier that follows them.
    __syncthreads();
  }

  if (r < rows_valid) {
    const float inv_l = l_i > 0.0f ? 1.0f / l_i : 0.0f;
    T* dst = o + (q_rows + row) * kHeadDim + half * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) dst[j] = from_float<T>(o_acc[j] * inv_l);
    if (lse != nullptr && half == 0) {
      lse[q_rows + row] = l_i > 0.0f ? (m_i + log2f(l_i)) * kLn2 : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

template <typename T>
struct BwdSmem {
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

// The Q tile's lse (log2 units) and delta; padding rows get the sentinel.
template <typename T>
__device__ __forceinline__ void load_rows(BwdSmem<T>& sm, const float* lse,
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

// P and dS of one (Q tile, KV tile) pair for this thread's half row, from
// the scores in s and dO V^T in dp.
template <typename T>
__device__ __forceinline__ void softmax_grad(BwdSmem<T>& sm, int r, int half,
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

// One block per (batch x head, KV tile j), KV tile 0 first: dK and dV of the
// tile over its visible Q tiles, and each pair's dQ contribution (unscaled)
// into workspace slot (bh, first_slot(i) + j) (dq_slots.cuh).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_tri_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dq_ws, int n_q, int n_kv, int off,
                         int n_pairs, float sm_scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem<T>& sm = *reinterpret_cast<BwdSmem<T>*>(smem_raw);
  constexpr bool kBf16 = std::is_same<T, bf16>::value;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r = tid >> 1;    // tile row: a Q row in the walk, a KV row at the store
  const int half = tid & 1;  // which half of the row's columns it owns
  const size_t bh = blockIdx.x;
  const int j = blockIdx.y;
  const int kv_start = j * kBlockN;
  const size_t q_rows = bh * n_q;
  const size_t kv_rows = bh * n_kv;
  const int cols_valid = min(kBlockN, n_kv - kv_start);
  const int n_q_tiles = (n_q + kBlockM - 1) / kBlockM;
  float* ws = dq_ws + bh * n_pairs * kTileElems;

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
    for (int jj = 0; jj < kHalf; ++jj) dk_reg[jj] = dv_reg[jj] = 0.0f;
  }

  int slot = 0;  // first workspace slot of Q tile i
  for (int i = 0; i < n_q_tiles; ++i) {
    const int n_cols = visible_kv_tiles(i, n_q, n_kv, off);
    if (j < n_cols) {
      const int q_start = i * kBlockM;
      const int rows_valid = min(kBlockM, n_q - q_start);
      load_tile<T>(sm.q, q + (q_rows + q_start) * kHeadDim, rows_valid);
      load_tile<T>(sm.dout, dout + (q_rows + q_start) * kHeadDim, rows_valid);
      load_rows(sm, lse + q_rows + q_start, delta + q_rows + q_start, rows_valid);
      __syncthreads();

      if constexpr (kBf16) {
        mm_abt_bf16(sm.q, sm.k, sm.s, warp);
        mm_abt_bf16(sm.dout, sm.v, sm.dp, warp);
      } else {
        mm_abt_f32(sm.q, sm.k, sm.s, r, half);
        mm_abt_f32(sm.dout, sm.v, sm.dp, r, half);
      }
      __syncthreads();

      softmax_grad(sm, r, half, kv_start,
                   last_visible(q_start + r, n_q, n_kv, off), scale_log2);
      __syncthreads();

      float* ws_tile = ws + (size_t)(slot + j) * kTileElems;
      if constexpr (kBf16) {
        mma_atb_bf16(dv_acc, sm.p, sm.dout, warp);
        mma_atb_bf16(dk_acc, sm.ds, sm.q, warp);
        Acc dq_acc[kHeadDim / 16];
#pragma unroll
        for (int n = 0; n < kHeadDim / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.0f);
        mma_ab_bf16(dq_acc, sm.ds, sm.k, warp);
#pragma unroll
        for (int n = 0; n < kHeadDim / 16; ++n) {
          wmma::store_matrix_sync(ws_tile + warp * 16 * kHeadDim + n * 16, dq_acc[n],
                                  kHeadDim, wmma::mem_row_major);
        }
      } else {
        mma_atb_f32(dv_reg, sm.p, sm.dout, r, half);
        mma_atb_f32(dk_reg, sm.ds, sm.q, r, half);
        float dq_reg[kHalf];
#pragma unroll
        for (int jj = 0; jj < kHalf; ++jj) dq_reg[jj] = 0.0f;
        mma_ab_f32(dq_reg, sm.ds, kLdP, sm.k, r, half);
#pragma unroll
        for (int jj = 0; jj < kHalf; ++jj) {
          ws_tile[r * kHeadDim + half * kHalf + jj] = dq_reg[jj];
        }
      }
      // The next tile's loads overwrite q, dout, lse2 and delta.
      __syncthreads();
    }
    slot += n_cols;
  }

  if constexpr (kBf16) {
    // Warp w holds KV rows 16w..16w+15; thread (r, half) stores row r.
#pragma unroll
    for (int n = 0; n < kHeadDim / 16; ++n) {
      wmma::store_matrix_sync(sm.s + warp * 16 * kLdS + n * 16, dk_acc[n], kLdS,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(sm.dp + warp * 16 * kLdS + n * 16, dv_acc[n], kLdS,
                              wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      dk_reg[jj] = sm.s[r * kLdS + half * kHalf + jj];
      dv_reg[jj] = sm.dp[r * kLdS + half * kHalf + jj];
    }
  }
  if (r < cols_valid) {
    const size_t at = (kv_rows + kv_start + r) * kHeadDim + half * kHalf;
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      dk[at + jj] = dk_reg[jj] * sm_scale;
      dv[at + jj] = dv_reg[jj];
    }
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

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int batch, int n_heads, int n_kv_heads, int n_q,
                       int n_kv, float sm_scale, int off, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(FwdSmem<T>);
  cudaError_t err = allow_smem(flash_tri_fwd_kernel<T>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (n_q + kBlockM - 1) / kBlockM);
  flash_tri_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      n_heads, n_kv_heads, n_q, n_kv, sm_scale * kLog2e, off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, void* dq_ws, int batch,
                       int n_heads, int n_q, int n_kv, float sm_scale, int off,
                       int n_pairs, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(BwdSmem<T>);
  cudaError_t err = allow_smem(flash_tri_bwd_kernel<T>, smem, done);
  if (err != cudaSuccess) return err;
  const int bh = batch * n_heads;
  const dim3 grid(bh, (n_kv + kBlockN - 1) / kBlockN);
  flash_tri_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dq_ws), n_q, n_kv, off, n_pairs, sm_scale,
      sm_scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dq_slots::launch_reduce<T>(static_cast<const float*>(dq_ws), nullptr, off,
                                    static_cast<T*>(dq), batch, n_heads, n_q, n_kv,
                                    n_pairs, sm_scale, stream);
}

bool valid(int batch, int n_heads, int n_q, int n_kv, int head_dim) {
  return head_dim == kHeadDim && batch >= 1 && n_heads >= 1 && n_q >= 1 &&
         n_kv >= 1 && n_q <= 65535 * kBlockM && n_kv <= 65535 * kBlockN;
}

}  // namespace

// C entry points, bound with ctypes (kernels/flash_tri.py).  Pointers are
// device pointers of contiguous tensors; q_offset is the static causal
// offset (row r sees c <= r + q_offset); dtype: 0 = bf16, 1 = fp32.  Each
// launcher returns its launches' cudaError_t (0 on success).
//
// Forward: q, o [B, H, N_q, 64]; k, v [B, H_kv, N_kv, 64]; lse fp32
// [B, H, N_q] or null.
extern "C" int fam_flash_tri_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int batch, int n_heads,
                                 int n_kv_heads, int n_q, int n_kv,
                                 int head_dim, float sm_scale, int q_offset,
                                 int dtype, void* stream) {
  if (!valid(batch, n_heads, n_q, n_kv, head_dim) || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_fwd<bf16>(q, k, v, o, lse, batch, n_heads, n_kv_heads, n_q,
                                 n_kv, sm_scale, q_offset, s);
  }
  if (dtype == 1) {
    return (int)launch_fwd<float>(q, k, v, o, lse, batch, n_heads, n_kv_heads,
                                  n_q, n_kv, sm_scale, q_offset, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Backward (equal head counts): q, dout, dq [B, H, N_q, 64]; k, v [B, H,
// N_kv, 64]; lse, delta fp32 [B, H, N_q]; dk, dv fp32 [B, H, N_kv, 64];
// dq_ws fp32 [B * H * n_pairs, 64, 64] with n_pairs from
// fam_bwd_dq_pairs(n_q, n_kv, q_offset) (flash_bwd.cu).
extern "C" int fam_flash_tri_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk, void* dv,
                                 void* dq_ws, int batch, int n_heads, int n_q,
                                 int n_kv, int head_dim, float sm_scale,
                                 int q_offset, int n_pairs, int dtype,
                                 void* stream) {
  if (!valid(batch, n_heads, n_q, n_kv, head_dim) ||
      n_pairs != dq_slots::visible_pairs(n_q, n_kv, q_offset)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_bwd<bf16>(q, k, v, dout, lse, delta, dq, dk, dv, dq_ws,
                                 batch, n_heads, n_q, n_kv, sm_scale, q_offset,
                                 n_pairs, s);
  }
  if (dtype == 1) {
    return (int)launch_bwd<float>(q, k, v, dout, lse, delta, dq, dk, dv, dq_ws,
                                  batch, n_heads, n_q, n_kv, sm_scale, q_offset,
                                  n_pairs, s);
  }
  return (int)cudaErrorInvalidValue;
}
