// Naive O(N^2) attention for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces flash_attention_metal_tpu/kernels/naive.py::_naive_kernel, the
// denominator of the benchmark's speedup and the ladder's first rung.
//
// Contract, for every batch b, head h (equal head counts) and query row r:
//   s[c] = sm_scale * q[b,h,r] . k[b,h,c]   over every column c < n_kv,
//   s[c] = mask value (-0.7 * FLT_MAX) where causal and c > r + (n_kv - n_q)
//   (end-aligned diagonal), then a two-pass softmax over the WHOLE row: the
//   row max first, then exp, sum and P . V.  No online statistics, no lse.
//   Everything is computed in fp32 (IEEE FMA, never TF32) whatever the input
//   type; o comes back in q's type.  A row that sees no column gives
//   mean(V), exactly as the Pallas kernel does.
//
// What bounds it on the H100.  The contract's 4 * N_q * N_kv * D flops per
// head (head dim D = 64 or 128) run in fp32 on the CUDA cores (67 TF/s):
// at the benchmark's sweep points (B * N^2 = 2^23, D = 64) the bound is
// ~32 us.  What makes this kernel the baseline is its function (whole score
// rows, two passes, fp32), not a lack of reuse.
//
// The design: the Pallas kernel's tiling on CUDA cores.  One block per
// (Q tile, head, batch); the Q tile (kBq = 64 rows: 32 measured no faster
// at N = 1024 and slower at N = 128 and D = 128) sits in shared memory as
// fp32 for the whole call, bf16 widened as it is loaded.  K (and
// V) stream through shared memory in 64-row tiles, in a 2-stage ring filled
// with cp.async (16-byte copies; bf16 tiles are widened by ordinary loads).
// The two passes of the contract are two walks over K: pass 1 scores each
// tile and keeps only the row max; pass 2 scores it again, takes
// p = expf(s - m), sums p and accumulates P . V, and o = acc / sum at the
// end.  That is 6 N^2 D flops against the contract's 4 N^2 D, and no score
// row is held anywhere, so no length cap comes from shared memory.
//
// Products are register-tiled fp32 outer products, on the helpers this
// kernel shares with FlashAttention V1 (csrc/fp32_tiles.cuh: the loads,
// the padded pitch, the score and P V patches, the row reductions).
// Thread (tr, tc) owns a 4 x 4 patch of the kBq x 64 score tile (rows
// tr + kBq/4 i, columns tc + 16 j) and reads its operands as float4 along
// the head dim from padded tiles (row pitch D + 4 floats, an odd number of
// 16-byte chunks: the 8 consecutive rows a warp's lanes read fall on
// distinct banks).  P goes to shared memory (pitch 72), and the same
// thread owns rows tr + kBq/4 i of o and columns 4 tc .. 4 tc + 3 of each
// 64-column block, which it accumulates from float4 reads of P and V.  A
// warp is 4 row groups x 8 column groups, so each float4 load serves 4 or
// 8 FMAs per lane with at most one 128-byte wavefront.  Row max and row sum
// are reduced over the 16 column groups (shuffles over 8 lanes, then the
// warp pair through shared memory) once per pass.
//
// Causal tile skipping keeps the contract exact.  A masked score's
// expf(mask - m) is exactly 0 in a row that sees a column, and the mask
// value never wins its max, so the KV tiles past the last column a Q
// tile's last row sees are skipped.  A row that sees nothing needs every
// column (its p is 1 everywhere: mean(V)), so a Q tile holding such a row
// walks the whole of K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "fp32_tiles.cuh"  // the fp32 tile helpers V1 shares
#include "sm90_tiles.cuh"  // cp_async_commit, cp_async_wait_all

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBq = 64;        // rows of a Q tile
constexpr int kBk = 64;        // rows of a K / V tile
constexpr int kPPitch = kBk + 8;  // floats per row of the P tile
// Longest K the wrapper takes (the benchmark's cap on naive, as JAX's).
constexpr int kMaxKv = 8192;
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int kMaxDevices = 64;

template <int D>
struct NaiveCfg {
  static constexpr int kThreads = kBq * 4;  // a 4 x 4 score patch each
  static constexpr int kRowGroups = kBq / 4;
  static constexpr int kPitch = fp32t::kPitch<D>;  // floats per row of the Q, K, V tiles
  static constexpr int kTileFloats = kBk * kPitch;
  // q tile, K ring, V ring, P tile, the warp pairs' row reductions
  static constexpr int kSmemFloats =
      kBq * kPitch + 2 * kTileFloats + 2 * kTileFloats + kBq * kPPitch + 2 * kBq;
  static constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(NaiveCfg<D>::kThreads)
    naive_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n_q, int n_kv,
                 float sm_scale, int causal) {
  using C = NaiveCfg<D>;
  using namespace fp32t;
  constexpr int kPitch = C::kPitch;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + kBq * kPitch;           // [2][kBk][kPitch]
  float* sv = sk + 2 * C::kTileFloats;     // [2][kBk][kPitch]
  float* sp = sv + 2 * C::kTileFloats;     // [kBq][kPPitch]
  float* red = sp + kBq * kPPitch;         // [2][kBq]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = warp % 2;               // which half of the column groups
  const int tc = pair * 8 + lane % 8;      // column group, 0..15
  const int tr = (warp / 2) * 4 + lane / 8;  // row group, 0..kBq/4 - 1
  const bool writer = lane % 8 == 0;

  const int q_start = blockIdx.x * kBq;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const T* k_head = k + bh * n_kv * D;
  const T* v_head = v + bh * n_kv * D;
  const int off = n_kv - n_q;  // row r sees c <= r + off when causal
  const int q_last = min(q_start + kBq, n_q) - 1;
  // KV tiles walked: all of them, or up to the last one the tile's last
  // row sees when every row of the tile sees a column.
  int n_t = (n_kv + kBk - 1) / kBk;
  if (causal && q_start + off >= 0) n_t = min(n_t, (q_last + off) / kBk + 1);
  const int n_steps = 2 * n_t;  // pass 1, then pass 2

  load_rows<D, C::kThreads>(sq, q + (bh * n_q + q_start) * D, kBq, n_q - q_start);
  // Step i's tiles into ring stage i % 2: K in both passes, V in pass 2.
  auto fetch = [&](int i) {
    const int t = i < n_t ? i : i - n_t;
    const int s = i % 2;
    const size_t at = (size_t)t * kBk * D;
    load_rows<D, C::kThreads>(sk + s * C::kTileFloats, k_head + at, kBk, n_kv - t * kBk);
    if (i >= n_t) {
      load_rows<D, C::kThreads>(sv + s * C::kTileFloats, v_head + at, kBk, n_kv - t * kBk);
    }
  };
  fetch(0);
  sm90::cp_async_commit();

  // This thread's rows: tile rows tr + kRowGroups i.
  int row_limit[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row_limit[i] = q_start + tr + C::kRowGroups * i + off;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float l[4] = {};
  float acc[4][D / 16] = {};  // rows i, columns g * 64 + 4 tc + e at [i][4 g + e]

  for (int i = 0; i < n_steps; ++i) {
    sm90::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_steps) fetch(i + 1);
    sm90::cp_async_commit();
    const int s = i % 2;
    const bool second = i >= n_t;
    const int kv_start = (second ? i - n_t : i) * kBk;
    const float* kt = sk + s * C::kTileFloats;

    // The 4 x 4 patch of S = Q K^T, summed along D in order.
    float sc[4][4];
    score_patch<D, C::kRowGroups>(sq, kt, tr, tc, sc);
    // Scaled and masked: the mask value past the diagonal, -inf past n_kv
    // (padding is no column at all).
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = kv_start + tc + 16 * b;
        float x = sc[a][b] * sm_scale;
        if (causal && c > row_limit[a]) x = kMaskValue;
        if (c >= n_kv) x = -INFINITY;
        sc[a][b] = x;
      }
    }

    if (!second) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) m[a] = fmaxf(m[a], sc[a][b]);
      }
      if (i == n_t - 1) {
        // The whole row's max, before pass 2 starts.
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int row = tr + C::kRowGroups * a;
          m[a] = reduce_cols<true, kBq>(m[a], red, row, pair, writer);
          __syncthreads();  // red is read before the next row's writes
        }
      }
      continue;
    }

    // Pass 2: p = exp(s - m), its sum, and P to shared memory.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* prow = sp + (tr + C::kRowGroups * a) * kPPitch;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(sc[a][b] - m[a]);
        l[a] += p;
        prow[tc + 16 * b] = p;
      }
    }
    __syncthreads();

    // o += P V over the tile's 64 rows, in order.
    pv_patch<D, C::kRowGroups, kBk>(sp, kPPitch, sv + s * C::kTileFloats, tr, tc, acc);
  }
  sm90::cp_async_wait_all();

  // The row sums, then o = acc / sum.
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = tr + C::kRowGroups * a;
    __syncthreads();  // the previous reads of red are done
    const float sum = reduce_cols<false, kBq>(l[a], red, row, pair, writer);
    const int r = q_start + row;
    if (r < n_q) {
      T* o_row = o + (bh * n_q + r) * D;
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = acc[a][4 * g + e] / sum;
        store4(o_row + g * 64 + 4 * tc, x);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch,
                   int n_heads, int n_q, int n_kv, float sm_scale, int causal,
                   cudaStream_t stream) {
  using C = NaiveCfg<D>;
  // The dynamic shared-memory limit is raised once per device.
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(naive_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((n_q + kBq - 1) / kBq, n_heads, batch);
  naive_kernel<T, D><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), n_q, n_kv, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (kernels/naive.py).  Pointers are device
// pointers of contiguous [B, H, N, D] tensors, D = head_dim, 64 or 128 (q,
// o: N = n_q; k, v: N = n_kv <= 8192).  dtype: 0 = bf16, 1 = fp32.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int fam_naive(const void* q, const void* k, const void* v, void* o,
                         int batch, int n_heads, int n_q, int n_kv,
                         int head_dim, float sm_scale, int causal, int dtype,
                         void* stream) {
  if (batch < 1 || batch > 65535 || n_heads < 1 || n_heads > 65535 || n_q < 1 ||
      n_kv < 1 || n_kv > kMaxKv) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FAM_LAUNCH(T, D) \
  return (int)launch<T, D>(q, k, v, o, batch, n_heads, n_q, n_kv, sm_scale, causal, s)
  if (dtype == 0 && head_dim == 64) FAM_LAUNCH(bf16, 64);
  if (dtype == 0 && head_dim == 128) FAM_LAUNCH(bf16, 128);
  if (dtype == 1 && head_dim == 64) FAM_LAUNCH(float, 64);
  if (dtype == 1 && head_dim == 128) FAM_LAUNCH(float, 128);
#undef FAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
