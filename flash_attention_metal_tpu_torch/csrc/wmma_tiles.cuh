// Tile helpers of the first-generation fp32 kernels (flash_mask.cu's
// block-sparse forward and backward, and the fp32 split pair and fused
// backward of flash_bwd.cu; every bf16 kernel runs on wgmma): 64-row tiles
// in padded shared memory, 128 threads, products in IEEE FMA (never TF32),
// head dim D = 64 or 128.  Also the constants and the shared-memory limit
// helper the wgmma backward kernels share with them.
//
// Thread layout.  Thread (r = tid / 2, half = tid % 2) owns half of tile
// row r in the elementwise work and the products: 32 of its 64 score
// columns and D / 2 of its output columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "dropout.cuh"
#include "xf.cuh"

namespace {

using bf16 = __nv_bfloat16;

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
// multiples of 16 bytes (vector copies).
template <typename T, int D>
struct Cfg {
  static constexpr int kLdT = D + 8;                        // Q, K, V, dO tiles
  static constexpr int kLdS = (D > kTile ? D : kTile) + 4;  // fp32 scores, P, dS
  static constexpr int kOut = D / 2;  // output columns per thread
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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
  constexpr int kLdT = Cfg<float, D>::kLdT, kLdS = Cfg<float, D>::kLdS;
  for (int c = 0; c < kTile; ++c) {
    const float xv = x[r * kLdS + c];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = fmaf(xv, y[c * kLdT + half * (D / 2) + j], acc[j]);
  }
}

// acc[j] += sum_i X[i][c] Y[i][half * D/2 + j]   (P^T dO, dS^T Q; c: this
// thread's KV row)
template <int D>
__device__ __forceinline__ void mma_atb_f32(float (&acc)[D / 2], const float* x, const float* y,
                                            int c, int half) {
  constexpr int kLdT = Cfg<float, D>::kLdT, kLdS = Cfg<float, D>::kLdS;
  for (int i = 0; i < kTile; ++i) {
    const float xv = x[i * kLdS + c];
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
  static_assert(std::is_same<T, float>::value,
                "the bf16 backward runs on wgmma (flash_bwd_sm90.cuh)");
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
// last column the row sees (-1: none, also for padding rows); col_lo: the
// first column of its window, and sinks the columns it sees before it;
// kids: the tile's 64 KV segment ids (null: none), qid the row's.  kXf:
// the score transforms xf (xf.cuh, tanhf) with the row at position pos;
// dS * (c - pos) adds into *dslope (a double: xf_warp_store) before the
// softcap's chain.  kDrop: attention dropout (dropout.cuh), drop's keep
// factor of the score whose hash input is dat + (c - kv_start) kMixA (dat
// the row hash plus column kv_start's term): the p tile takes the dropped
// P, dS = P (dP keep - delta) the undropped one.
template <typename T, int D, bool kXf = false, bool kDrop = false>
__device__ __forceinline__ void softmax_grad(BwdSmem<T, D>& sm, int r, int half, int kv_start,
                                             int col_limit, float scale_log2,
                                             int col_lo = INT_MIN, int sinks = 0, int qid = 0,
                                             const int* kids = nullptr,
                                             const XfHead& xf = XfHead(), int pos = 0,
                                             double* dslope = nullptr,
                                             const DropBlock& drop = DropBlock(),
                                             uint32_t dat = 0) {
  using C = Cfg<T, D>;
  T* p = sm.p_tile();
  T* ds = sm.ds_tile();
  const float lse2 = sm.lse2[r];
  const float delta = sm.delta[r];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int c = half * kHalf + j;
    const int cc = kv_start + c;
    const bool seen = cc <= col_limit && (cc >= col_lo || cc < sinks) &&
                      (kids == nullptr || kids[c] == qid);
    float keep = 1.0f;
    if constexpr (kDrop) keep = drop.keep(dat + (uint32_t)c * kMixA);
    if constexpr (kXf) {
      const float t = xf.capped<true>(sm.s[r * C::kLdS + c]);
      const float dist = (float)(cc - pos);
      const float pj = seen ? exp2f(xf.shifted(t, dist, lse2)) : 0.0f;
      const float dpj = kDrop ? sm.dp[r * C::kLdS + c] * keep : sm.dp[r * C::kLdS + c];
      const float dsj = pj * (dpj - delta);
      *dslope = fma((double)dsj, (double)dist, *dslope);
      p[r * C::kLdS + c] = from_float<T>(kDrop ? pj * keep : pj);
      ds[r * C::kLdS + c] = from_float<T>(dsj * xf.chain(t));
    } else {
      const float pj = seen ? exp2f(sm.s[r * C::kLdS + c] * scale_log2 - lse2) : 0.0f;
      const float dsj = pj * (sm.dp[r * C::kLdS + c] - delta);
      p[r * C::kLdS + c] = from_float<T>(pj);
      ds[r * C::kLdS + c] = from_float<T>(dsj);
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
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace
