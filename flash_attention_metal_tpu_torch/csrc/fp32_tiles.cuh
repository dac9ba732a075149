// fp32 tiles on the CUDA cores: the helpers of the naive kernel
// (csrc/naive.cu) and FlashAttention V1 (csrc/flash_v1.cu).
//
// Both hold a Q tile and stream K and V through shared memory as fp32 (bf16
// widened as it is loaded), and both compute S = Q K^T and O += P V as
// register-tiled fp32 outer products in IEEE FMA, never on the tensor cores
// (fp32 products there are TF32).  A thread owns a 4 x 4 patch of a 64-column
// score tile, rows r0 + kRowStep a and columns c0 + 16 b, read as float4
// along the head dim, and the same rows of O at columns g * 64 + 4 tc + e:
// 16 threads share a row.
//
// Tiles use a padded row pitch of D + 4 floats: an odd number of 16-byte
// chunks, so the 8 consecutive rows a quarter of a warp reads at one chunk
// fall on distinct banks (a 16-row read takes the two wavefronts it needs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tiles.cuh"  // cp_async16

namespace {
namespace fp32t {

using bf16 = __nv_bfloat16;

// Floats per row of a Q, K or V tile at head dim D.
template <int D>
constexpr int kPitch = D + 4;

// Rows [0, rows_valid) of a [rows][D] tile (row pitch D in global memory)
// into a [rows][kPitch<D>] fp32 tile; the other rows are zero.  fp32 by
// cp.async (lands at the ring's wait), bf16 widened by ordinary loads
// (lands at once).
template <int D, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int rows,
                                          int rows_valid) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool valid = r < rows_valid;
    sm90::cp_async16(dst + r * kPitch<D> + c * 4, src + (valid ? (size_t)r * D + c * 4 : 0),
                     valid);
  }
}
template <int D, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, const bf16* src, int rows,
                                          int rows_valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < rows_valid) u = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 e = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
    float4* out = reinterpret_cast<float4*>(dst + r * kPitch<D> + c * 8);
    out[0] = make_float4(a.x, a.y, b.x, b.y);
    out[1] = make_float4(e.x, e.y, f.x, f.y);
  }
}

__device__ __forceinline__ void store4(float* dst, const float (&x)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(bf16* dst, const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// The 4 x 4 patch s[a][b] = q[r0 + kRowStep a] . k[c0 + 16 b] of S = Q K^T
// over padded tiles, summed along D in order.
template <int D, int kRowStep>
__device__ __forceinline__ void score_patch(const float* q, const float* k, int r0, int c0,
                                            float (&s)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 qa[4], kb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = *reinterpret_cast<const float4*>(q + (r0 + kRowStep * a) * kPitch<D> + d);
      kb[a] = *reinterpret_cast<const float4*>(k + (c0 + 16 * a) * kPitch<D> + d);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float x = s[a][b];
        x = fmaf(qa[a].x, kb[b].x, x);
        x = fmaf(qa[a].y, kb[b].y, x);
        x = fmaf(qa[a].z, kb[b].z, x);
        x = fmaf(qa[a].w, kb[b].w, x);
        s[a][b] = x;
      }
    }
  }
}

// acc[a][4 g + e] += sum_j p[r0 + kRowStep a][j] v[j][g * 64 + 4 tc + e]
// over the kCols rows of a V tile, in order; p has row pitch p_pitch.
template <int D, int kRowStep, int kCols>
__device__ __forceinline__ void pv_patch(const float* p, int p_pitch, const float* v, int r0,
                                         int tc, float (&acc)[4][D / 16]) {
#pragma unroll 2
  for (int j = 0; j < kCols; j += 4) {
    float4 pa[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      pa[a] = *reinterpret_cast<const float4*>(p + (r0 + kRowStep * a) * p_pitch + j);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 vb =
            *reinterpret_cast<const float4*>(v + (j + jj) * kPitch<D> + g * 64 + 4 * tc);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float pj = jj == 0 ? pa[a].x : jj == 1 ? pa[a].y : jj == 2 ? pa[a].z : pa[a].w;
          acc[a][4 * g + 0] = fmaf(pj, vb.x, acc[a][4 * g + 0]);
          acc[a][4 * g + 1] = fmaf(pj, vb.y, acc[a][4 * g + 1]);
          acc[a][4 * g + 2] = fmaf(pj, vb.z, acc[a][4 * g + 2]);
          acc[a][4 * g + 3] = fmaf(pj, vb.w, acc[a][4 * g + 3]);
        }
      }
    }
  }
}

// x reduced (max or sum) over the kLanes lanes l ^ 1, 2, .. kLanes / 2 of
// the warp: the lanes that share a row.
template <bool kMax, int kLanes>
__device__ __forceinline__ float reduce_lanes(float x) {
#pragma unroll
  for (int s = 1; s < kLanes; s <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, s);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

// A row's value reduced over 16 column groups split across a warp pair:
// 8 lanes of each warp, then the other warp through red[2][kRows].
template <bool kMax, int kRows>
__device__ __forceinline__ float reduce_cols(float x, float* red, int row, int pair,
                                             bool writer) {
  x = reduce_lanes<kMax, 8>(x);
  if (writer) red[pair * kRows + row] = x;
  __syncthreads();
  const float a = red[row], b = red[kRows + row];
  return kMax ? fmaxf(a, b) : a + b;
}

}  // namespace fp32t
}  // namespace
