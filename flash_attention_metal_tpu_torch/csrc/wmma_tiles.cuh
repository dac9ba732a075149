// Tile products of the first-generation kernels (flash_mask.cu's forward and
// fp32 backward, and the fp32 split pair and fused backward of
// flash_bwd.cu; the bf16 backward kernels run on wgmma): 64-row tiles in padded
// shared memory, 128 threads, bf16 products on the tensor cores through WMMA
// 16x16x16 fragments with fp32 accumulators, fp32 products in IEEE FMA
// (never TF32), head dim D = 64 or 128.
//
// Thread layout.  Warp w owns tile rows 16w..16w+15 in the WMMA products;
// thread (r = tid / 2, half = tid % 2) owns half of tile row r in the
// elementwise work and the FMA products: 32 of its 64 score columns and
// D / 2 of its output columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kTile = 64;            // rows of a Q tile and of a KV tile
constexpr int kThreads = 2 * kTile;  // two threads per tile row, 4 warps
constexpr int kHalf = kTile / 2;     // score columns per thread
// Finite mask value (config.DEFAULT_MASK_VALUE): exp2(mask - mask) is never
// NaN, and visibility is tested explicitly, so masked entries add nothing.
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Stands in for lse = -inf (a row that sees nothing) and for padding rows:
// exp2(s - kLseSentinel * log2 e) underflows to exactly 0.
constexpr float kLseSentinel = 1e30f;
constexpr int kMaxDevices = 64;

// Pitches for input type T and head dim D.  Padded to spread banks, and
// multiples of 16 bytes (vector copies) and of 32 bytes per 16 rows (WMMA).
template <typename T, int D>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kLdT = D + 8;                        // Q, K, V, dO tiles
  static constexpr int kLdS = (D > kTile ? D : kTile) + 4;  // fp32 scores, staged outputs
  // P and dS: their own tile in bf16, the scores' in fp32 (written over them).
  static constexpr int kLdX = kBf16 ? kTile + 8 : kLdS;
  static constexpr int kOut = D / 2;  // output columns per thread
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Copy `rows_valid` rows of D elements (row pitch D in global memory) into
// a [64][kLdT] shared tile; the other rows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows_valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int kLdT = Cfg<T, D>::kLdT;
  for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = val;
  }
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

// out[warp's 16 rows][64] = A B^T over D on the tensor cores: A and B are
// [64][kLdT] tiles (Q K^T, dO V^T).
template <int D>
__device__ __forceinline__ void mm_abt_bf16(const bf16* a, const bf16* b, float* out, int warp) {
  constexpr int kLdT = Cfg<bf16, D>::kLdT, kLdS = Cfg<bf16, D>::kLdS;
  Acc acc[kTile / 16];
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + warp * 16 * kLdT + kk, kLdT);
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      // B^T as a column-major operand: element (d, c) sits at b[c][d].
      FragBT fb;
      wmma::load_matrix_sync(fb, b + n * 16 * kLdT + kk, kLdT);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    wmma::store_matrix_sync(out + warp * 16 * kLdS + n * 16, acc[n], kLdS, wmma::mem_row_major);
  }
}

// acc += X[warp's 16 rows][64] . Y: X is [64][kLdX] (P, dS), Y [64][kLdT]
// (V, K).  O += P V and dQ += dS K.
template <int D>
__device__ __forceinline__ void mma_ab_bf16(Acc (&acc)[D / 16], const bf16* x, const bf16* y,
                                            int warp) {
  constexpr int kLdT = Cfg<bf16, D>::kLdT, kLdX = Cfg<bf16, D>::kLdX;
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, x + warp * 16 * kLdX + kk, kLdX);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragB fb;
      wmma::load_matrix_sync(fb, y + kk * kLdT + n * 16, kLdT);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// The warp's 16 rows of a [64][D] accumulator into a staged fp32 tile.
template <int D>
__device__ __forceinline__ void store_acc(float* out, Acc (&acc)[D / 16], int warp) {
  constexpr int ld = Cfg<bf16, D>::kLdS;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(out + warp * 16 * ld + n * 16, acc[n], ld, wmma::mem_row_major);
  }
}

// fp32 products in IEEE FMA; thread (r, half) owns half of tile row r.
// out[r][half's 32 columns] = A[r][:] . B[those columns][:] over D.
template <int D>
__device__ __forceinline__ void mm_abt_f32(const float* a, const float* b, float* out, int r,
                                           int half) {
  constexpr int kLdT = Cfg<float, D>::kLdT, kLdS = Cfg<float, D>::kLdS;
  float acc[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) acc[j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float av = a[r * kLdT + d];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) acc[j] = fmaf(av, b[(half * kHalf + j) * kLdT + d], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < kHalf; ++j) out[r * kLdS + half * kHalf + j] = acc[j];
}

// acc[j] += sum_c X[r][c] Y[c][half * D/2 + j]   (P V, dS K)
template <int D>
__device__ __forceinline__ void mma_ab_f32(float (&acc)[D / 2], const float* x, const float* y,
                                           int r, int half) {
  constexpr int kLdT = Cfg<float, D>::kLdT, kLdX = Cfg<float, D>::kLdX;
  for (int c = 0; c < kTile; ++c) {
    const float xv = x[r * kLdX + c];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = fmaf(xv, y[c * kLdT + half * (D / 2) + j], acc[j]);
  }
}

// acc[j] += sum_i X[i][c] Y[i][half * D/2 + j]   (P^T dO, dS^T Q; c: this
// thread's KV row)
template <int D>
__device__ __forceinline__ void mma_atb_f32(float (&acc)[D / 2], const float* x, const float* y,
                                            int c, int half) {
  constexpr int kLdT = Cfg<float, D>::kLdT, kLdX = Cfg<float, D>::kLdX;
  for (int i = 0; i < kTile; ++i) {
    const float xv = x[i * kLdX + c];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = fmaf(xv, y[i * kLdT + half * (D / 2) + j], acc[j]);
  }
}

// ---------------------------------------------------------------------------
// The backward's (Q tile, KV tile) pair: scores, P and dS.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct BwdSmem {
  using C = Cfg<T, D>;
  static_assert(!C::kBf16, "the bf16 backward runs on wgmma (flash_bwd_sm90.cuh)");
  T q[kTile * C::kLdT];
  T k[kTile * C::kLdT];
  T v[kTile * C::kLdT];
  T dout[kTile * C::kLdT];
  float s[kTile * C::kLdS];   // scores, P over them
  float dp[kTile * C::kLdS];  // dO V^T, dS over it
  float lse2[kTile];          // row lse in log2 units, sentinel-guarded
  float delta[kTile];

  // Where P and dS go: over s and dp.
  __device__ __forceinline__ T* p_tile() { return s; }
  __device__ __forceinline__ T* ds_tile() { return dp; }
};

// The Q tile's lse (log2 units) and delta; padding rows get the sentinel.
template <typename T, int D>
__device__ __forceinline__ void load_rows(BwdSmem<T, D>& sm, const float* lse,
                                          const float* delta, int rows_valid) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
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

// S = Q K^T into s and dP = dO V^T into dp.
template <typename T, int D>
__device__ __forceinline__ void bwd_scores(BwdSmem<T, D>& sm, int r, int half) {
  mm_abt_f32<D>(sm.q, sm.k, sm.s, r, half);
  mm_abt_f32<D>(sm.dout, sm.v, sm.dp, r, half);
}

// P and dS of one causal pair for this thread's half row, from the scores
// in s and dO V^T in dp, into sm.p_tile() and sm.ds_tile().  col_limit: the
// last column the row sees (-1: none, also for padding rows).
template <typename T, int D>
__device__ __forceinline__ void softmax_grad(BwdSmem<T, D>& sm, int r, int half, int kv_start,
                                             int col_limit, float scale_log2) {
  using C = Cfg<T, D>;
  T* p = sm.p_tile();
  T* ds = sm.ds_tile();
  const float lse2 = sm.lse2[r];
  const float delta = sm.delta[r];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int c = half * kHalf + j;
    const float pj = kv_start + c <= col_limit
                         ? exp2f(sm.s[r * C::kLdS + c] * scale_log2 - lse2)
                         : 0.0f;
    const float dsj = pj * (sm.dp[r * C::kLdS + c] - delta);
    p[r * C::kLdX + c] = from_float<T>(pj);
    ds[r * C::kLdX + c] = from_float<T>(dsj);
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
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace
