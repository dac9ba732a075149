// FlashAttention V1 for Hopper (sm_90a): tiled fp32 attention, streaming and
// folded, bf16 and fp32 inputs, head dim D = 64 or 128.
//
// Replaces flash_attention_metal_tpu/kernels/flash_v1.py::_flash_v1_kernel
// (streaming: one KV tile per step of an online softmax) and
// ::_flash_v1_kernel_folded (one pass over the whole KV row, several batch
// elements per grid step): the ladder's rung 2 and the benchmark sweep's
// FlashV1 column, the reference's FA-1 rung (kernels.metal:66-171).
//
// Contract, for every batch b, head h (equal head counts) and query row r:
//   o[r] = sum_c P[r,c] v[c] / sum_c P[r,c],  P[r,c] = exp(s[r,c] - m[r]),
//   s[r,c] = sm_scale * q[r] . k[c] over every column c < n_kv (causal: only
//   c <= r, with n_q == n_kv), m[r] the row max; a row whose sum is 0 divides
//   by 1.  No lse.  Everything is fp32 (IEEE FMA on the CUDA cores, never
//   TF32) whatever the input type; o comes back in q's type.
//   * Streaming: the row is walked in 64-column KV tiles with a running max
//     m, a running sum l and an accumulator, both rescaled by
//     exp2(m_prev - m_next) on every step; one division by l at the end.
//   * Folded (n_kv <= 512): the block scores the whole row into shared
//     memory first, takes one max over all of it, then exp2, the sum and
//     P V in a second walk: no running statistics, no score recomputed.
//
// What bounds it on the H100.  4 * B * H * N_q * N_kv * D flops of fp32 FMA
// on the CUDA cores (67 TF/s): 0.0321 ms at the benchmark's sweep points
// (B * N^2 = 2^23, H = 1, D = 64), against about 4 MB of inputs (1.3 us at
// 3.35 TB/s): operations.
//
// The design: one warp owns 8 query rows and all 64 columns of each score
// tile, so a row never leaves its warp.  A lane (tr, tc) = (lane / 16,
// lane % 16) owns the 4 x 4 patch of rows r0 + 2a (r0 = 8 warp + tr) and
// columns tc + 16b, and the same rows of o at columns g * 64 + 4 tc + e.
// The products are csrc/fp32_tiles.cuh's, shared with the naive kernel:
// float4 operands from padded tiles (pitch D + 4), 8 FMAs per shared load
// in S = Q K^T, 4 (D = 64) or 8 (D = 128) per load in O += P V.  The step's
// row max is a 16-lane shuffle reduction and the row sum stays a per-lane
// partial until the end, so the softmax adds no block barrier; P is
// warp-private and goes through shared memory under __syncwarp.  (16-row
// warps with 4 x 8 patches, half the shared-memory wavefronts, measured
// no faster on the H100.)
//
// A block is kWarps warps, a Q tile of 8 kWarps rows (16, 32 or 64),
// holding Q in fp32 shared memory (bf16 widened as it is loaded).  K and V
// stream through shared memory by cp.async (fp32; bf16 by ordinary loads):
//   * streaming: a K buffer and a V buffer.  V_t lands while S_t is
//     computed and K_{t+1} while P_t V_t is: two barriers a step, each
//     after the tile it waits for.  P goes through a half tile (32 columns)
//     at a time.
//   * folded: a 2-stage ring of K_0 .. K_{n-1}, then V_0 .. V_{n-1}, one
//     barrier a tile; the score rows (pitch 64 ceil(n_kv / 64) + 16) hold
//     s, then p in place.
// Shared memory per block in bytes (4 * (rows (D + 4) + 128 (D + 4) +
// rows * (48 streaming | pitch folded))):
//   streaming, 64 rows: 64,512 (D = 64), 113,664 (D = 128); 32 rows:
//     49,664, 90,624;
//   folded, D = 64: 64 rows at n_kv 128: 89,088; 32 rows at n_kv 256 /
//     512: 78,336 / 111,104.  D = 128: 32 rows at 128: 102,912; 16 rows at
//     256 / 512: 93,440 / 109,824.
// Registers (ptxas -v, nvcc 12.9, sm_90a), under a 128-register cap that
// leaves room for 16 warps an SM: streaming 128 (every variant), folded
// fp32 112 (D = 64) and 128 (D = 128), bf16 96 and 125; no spills.
//
// Grid and occupancy.  kernels/flash_v1.py::v1_tile_rows picks the Q-tile
// height: folded, the tallest whose block leaves room for two on an SM
// (<= 115,712 bytes); streaming, 32 rows when 64-row tiles would give at
// most one block an SM (132), else 64 (measured per sweep point by
// `python -m flash_attention_metal_tpu_torch.harness.onchip v1_tiles`).
// At the sweep's points (H = 1, D = 64, B = 2^23 / N^2):
//   N = 128 (B 512) folded, 64 rows, 1024 blocks of 8 warps, 2 an SM;
//   N = 256 (B 128) folded, 32 rows, 1024 blocks of 4 warps, 2 an SM;
//   N = 512 (B 32) folded, 32 rows, 512 blocks of 4 warps, 2 an SM;
//   N = 1024 (B 8), 8192 (B 1) streaming, 32 rows, 256 blocks of 4 warps;
//   N = 2048 (B 2), 4096 (B 1) streaming, 32 rows, 128 blocks of 4 warps;
//   N = 16384 (B 1) streaming, 64 rows, 256 blocks of 8 warps.
// (Streaming blocks fit 4 an SM at 32 rows, 2 at 64 by registers.)
//
// Causal tile skipping is exact: a Q tile walks KV tiles up to its last
// row's diagonal and only the tiles that hold a diagonal or the padded end
// compare columns.  With n_q == n_kv every row sees column 0, so no row is
// blind.  Q tiles are launched last first, the longest causal walks ahead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fp32_tiles.cuh"
#include "sm90_tiles.cuh"  // cp_async_commit, cp_async_wait_all

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // K / V rows per tile: the score columns of a step
// A warp owns kWarpRows query rows with all 64 of their columns: kRowGroups
// lanes down (rows r0 + kRowGroups a), kColGroups across (columns tc +
// kColGroups b), each lane a 4 x 4 patch of the scores.
constexpr int kWarpRows = 8;
constexpr int kRowGroups = 2;
constexpr int kColGroups = 16;
// Row pitch of P (streaming: a 32-column half tile; folded: the scores) is
// its columns plus kColGroups floats (16 mod 32), so a patch's scalar
// writes and the float4 reads of P V meet no bank conflict.
constexpr int kHalfPitch = kTile / 2 + kColGroups;
// The longest row the folded kernel scores into shared memory.
constexpr int kFoldedMaxKv = 512;
// Dynamic shared memory a block may take (227 KB).
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

// KV tiles a Q tile whose last row is q_last walks.
__device__ __forceinline__ int kv_tiles(int n_kv, int q_last, int causal) {
  const int n_t = (n_kv + kTile - 1) / kTile;
  return causal ? min(n_t, q_last / kTile + 1) : n_t;
}

// Scores to log2 units; where `edge`, -inf at the padding columns (c >=
// n_kv) and, when causal, past the diagonal (c > row).  row0 and col0 are
// the patch's first row and column.
__device__ __forceinline__ void scale_mask(float (&s)[4][4], float scale_log2, int row0,
                                           int col0, int n_kv, int causal, bool edge) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = col0 + kColGroups * b;
      float x = s[a][b] * scale_log2;
      if (edge && (c >= n_kv || (causal && c > row0 + kRowGroups * a))) x = -INFINITY;
      s[a][b] = x;
    }
  }
}

// o[r0 + kRowGroups a] = acc[a] / (the row's sum over its kColGroups
// lanes), for the rows below rows_valid; o points at the tile's first row.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* o, const float (&acc)[4][D / 16],
                                           const float (&l)[4], int r0, int tc,
                                           int rows_valid) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float sum = fp32t::reduce_lanes<false, kColGroups>(l[a]);
    if (sum == 0.0f) sum = 1.0f;
    const int r = r0 + kRowGroups * a;
    if (r >= rows_valid) continue;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[a][4 * g + e] / sum;
      fp32t::store4(o + (size_t)r * D + g * 64 + 4 * tc, x);
    }
  }
}

// Streaming: one block per (batch x head, Q tile of 8 kWarps rows).
template <typename T, int D, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
    flash_v1_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int n_q, int n_kv,
                           float scale_log2, int causal) {
  using namespace fp32t;
  constexpr int kRows = kWarps * kWarpRows;
  constexpr int kThreads = kWarps * 32;
  constexpr int kTileFloats = kTile * kPitch<D>;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                    // [kRows][kPitch]
  float* sk = sq + kRows * kPitch<D>;  // [kTile][kPitch]: K_t
  float* sv = sk + kTileFloats;        // [kTile][kPitch]: V_t
  float* sp = sv + kTileFloats;        // [kRows][kHalfPitch]: half of P_t

  const int lane = threadIdx.x % 32;
  const int r0 = threadIdx.x / 32 * kWarpRows + lane / kColGroups;  // rows r0 + kRowGroups a
  const int tc = lane % kColGroups;
  const size_t bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int n_t = kv_tiles(n_kv, min(q_start + kRows, n_q) - 1, causal);
  const T* k_head = k + bh * n_kv * D;
  const T* v_head = v + bh * n_kv * D;

  load_rows<D, kThreads>(sq, q + (bh * n_q + q_start) * D, kRows, n_q - q_start);
  load_rows<D, kThreads>(sk, k_head, kTile, n_kv);
  sm90::cp_async_commit();

  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // running max, log2 units
  float l[4] = {};  // this lane's part of the running sum
  float acc[4][D / 16] = {};
  for (int t = 0; t < n_t; ++t) {
    const int kv_start = t * kTile;
    // K_t has landed and every warp is done with V_{t-1}: V_t streams in
    // while S_t is computed.
    sm90::cp_async_wait_all();
    __syncthreads();
    load_rows<D, kThreads>(sv, v_head + (size_t)kv_start * D, kTile, n_kv - kv_start);
    sm90::cp_async_commit();

    float s[4][4];
    score_patch<D, kRowGroups>(sq, sk, r0, tc, s);
    const bool edge = kv_start + kTile > n_kv || (causal && kv_start + kTile - 1 > q_start);
    scale_mask(s, scale_log2, q_start + r0, kv_start + tc, n_kv, causal, edge);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = s[a][0];
#pragma unroll
      for (int b = 1; b < 4; ++b) mx = fmaxf(mx, s[a][b]);
      const float m_next = fmaxf(m[a], reduce_lanes<true, kColGroups>(mx));
      // A row that has seen no column keeps m = -inf and adds nothing.
      const float base = m_next == -INFINITY ? 0.0f : m_next;
      const float alpha = exp2f(m[a] - base);
      float sum = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = exp2f(s[a][b] - base);
        sum += s[a][b];
      }
      l[a] = l[a] * alpha + sum;
#pragma unroll
      for (int e = 0; e < D / 16; ++e) acc[a][e] *= alpha;
      m[a] = m_next;
    }

    // V_t has landed and every warp is done with K_t: K_{t+1} streams in
    // while P_t V_t is computed.
    sm90::cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_t) {
      load_rows<D, kThreads>(sk, k_head + (size_t)(kv_start + kTile) * D, kTile,
                             n_kv - kv_start - kTile);
    }
    sm90::cp_async_commit();
    // P_t V_t, 32 columns at a time through this warp's own rows of sp.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          sp[(r0 + kRowGroups * a) * kHalfPitch + tc + kColGroups * b] = s[a][2 * h + b];
        }
      }
      __syncwarp();
      pv_patch<D, kRowGroups, kTile / 2>(sp, kHalfPitch, sv + h * (kTile / 2) * kPitch<D>, r0,
                                         tc, acc);
      __syncwarp();  // read before the next half overwrites it
    }
  }
  sm90::cp_async_wait_all();
  store_rows<T, D>(o + (bh * n_q + q_start) * D, acc, l, r0, tc, n_q - q_start);
}

// Folded: one block per (batch x head, Q tile of 8 kWarps rows); n_kv <=
// kFoldedMaxKv.  Each warp's score rows live in srow (pitch ld_row).
template <typename T, int D, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
    flash_v1_folded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int n_q, int n_kv,
                           int ld_row, float scale_log2, int causal) {
  using namespace fp32t;
  constexpr int kRows = kWarps * kWarpRows;
  constexpr int kThreads = kWarps * 32;
  constexpr int kTileFloats = kTile * kPitch<D>;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                      // [kRows][kPitch]
  float* ring = sq + kRows * kPitch<D>;  // [2][kTile][kPitch]
  float* srow = ring + 2 * kTileFloats;  // [kRows][ld_row]: s, then p

  const int lane = threadIdx.x % 32;
  const int r0 = threadIdx.x / 32 * kWarpRows + lane / kColGroups;  // rows r0 + kRowGroups a
  const int tc = lane % kColGroups;
  const size_t bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int n_t = kv_tiles(n_kv, min(q_start + kRows, n_q) - 1, causal);
  const T* k_head = k + bh * n_kv * D;
  const T* v_head = v + bh * n_kv * D;

  // Item i of the walk into ring stage i % 2: K_i, then V_{i - n_t}.
  auto fetch = [&](int i) {
    const int t = i < n_t ? i : i - n_t;
    load_rows<D, kThreads>(ring + (i % 2) * kTileFloats,
                           (i < n_t ? k_head : v_head) + (size_t)t * kTile * D, kTile,
                           n_kv - t * kTile);
  };
  load_rows<D, kThreads>(sq, q + (bh * n_q + q_start) * D, kRows, n_q - q_start);
  fetch(0);
  sm90::cp_async_commit();

  // Pass 1: each K tile scored once, into this warp's rows of srow.
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int i = 0; i < n_t; ++i) {
    sm90::cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1
    fetch(i + 1);
    sm90::cp_async_commit();
    const int kv_start = i * kTile;
    float s[4][4];
    score_patch<D, kRowGroups>(sq, ring + (i % 2) * kTileFloats, r0, tc, s);
    const bool edge = kv_start + kTile > n_kv || (causal && kv_start + kTile - 1 > q_start);
    scale_mask(s, scale_log2, q_start + r0, kv_start + tc, n_kv, causal, edge);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        mx[a] = fmaxf(mx[a], s[a][b]);
        srow[(r0 + kRowGroups * a) * ld_row + kv_start + tc + kColGroups * b] = s[a][b];
      }
    }
  }

  // One max over the whole scored row: this lane's columns, then the row's
  // 16 lanes.  A row that sees nothing adds nothing.
  float base[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float m = reduce_lanes<true, kColGroups>(mx[a]);
    base[a] = m == -INFINITY ? 0.0f : m;
  }

  // Pass 2: p = exp2(s - m) in place and its sum (each lane its own
  // scores), then P V, a V tile at a time.
  float l[4] = {};
  float acc[4][D / 16] = {};
  for (int i = n_t; i < 2 * n_t; ++i) {
    sm90::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < 2 * n_t) fetch(i + 1);
    sm90::cp_async_commit();
    const int kv_start = (i - n_t) * kTile;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float* x = srow + (r0 + kRowGroups * a) * ld_row + kv_start + tc + kColGroups * b;
        const float p = exp2f(*x - base[a]);
        l[a] += p;
        *x = p;
      }
    }
    __syncwarp();  // the warp's P rows, before any lane reads them
    pv_patch<D, kRowGroups, kTile>(srow + kv_start, ld_row, ring + (i % 2) * kTileFloats, r0, tc,
                                   acc);
  }
  sm90::cp_async_wait_all();
  store_rows<T, D>(o + (bh * n_q + q_start) * D, acc, l, r0, tc, n_q - q_start);
}

// Raise a kernel's dynamic shared-memory limit to kMaxSmem once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

int folded_row_pitch(int n_kv) { return (n_kv + kTile - 1) / kTile * kTile + kColGroups; }

// Bytes of shared memory a block takes (the header's table).
int smem_bytes(int folded, int rows, int n_kv, int head_dim) {
  const int pitch = head_dim + 4;
  return 4 * (rows * pitch + 2 * kTile * pitch +
              rows * (folded ? folded_row_pitch(n_kv) : kHalfPitch));
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int batch, n_heads, n_q, n_kv, head_dim, rows;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, int kWarps, bool kFolded>
cudaError_t launch(const Args& a) {
  static bool done[kMaxDevices] = {};
  constexpr int kRows = kWarps * kWarpRows;
  const dim3 grid(a.batch * a.n_heads, (a.n_q + kRows - 1) / kRows);
  const int smem = smem_bytes(kFolded, kRows, a.n_kv, D);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  if constexpr (kFolded) {
    cudaError_t err = allow_smem(flash_v1_folded_kernel<T, D, kWarps>, done);
    if (err != cudaSuccess) return err;
    flash_v1_folded_kernel<T, D, kWarps><<<grid, kWarps * 32, smem, a.stream>>>(
        q, k, v, o, a.n_q, a.n_kv, folded_row_pitch(a.n_kv), a.sm_scale * kLog2e, a.causal);
  } else {
    cudaError_t err = allow_smem(flash_v1_stream_kernel<T, D, kWarps>, done);
    if (err != cudaSuccess) return err;
    flash_v1_stream_kernel<T, D, kWarps><<<grid, kWarps * 32, smem, a.stream>>>(
        q, k, v, o, a.n_q, a.n_kv, a.sm_scale * kLog2e, a.causal);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool kFolded>
cudaError_t by_rows(const Args& a) {
  if (a.rows == 64) return launch<T, D, 64 / kWarpRows, kFolded>(a);
  if (a.rows == 32) return launch<T, D, 32 / kWarpRows, kFolded>(a);
  if constexpr (kFolded) {
    if (a.rows == 16) return launch<T, D, 16 / kWarpRows, true>(a);
  }
  return cudaErrorInvalidValue;
}

template <bool kFolded>
int dispatch(const Args& a, int dtype) {
  const bool ok = (a.head_dim == 64 || a.head_dim == 128) && a.batch >= 1 && a.n_heads >= 1 &&
                  (long long)a.batch * a.n_heads <= 0x7fffffffLL && a.n_q >= 1 &&
                  a.n_kv >= 1 && (!a.causal || a.n_q == a.n_kv) && a.rows >= 16 &&
                  (a.n_q + a.rows - 1) / a.rows <= 65535 &&
                  (!kFolded || a.n_kv <= kFoldedMaxKv) &&
                  smem_bytes(kFolded, a.rows, a.n_kv, a.head_dim) <= kMaxSmem;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && a.head_dim == 64) return (int)by_rows<bf16, 64, kFolded>(a);
  if (dtype == 0 && a.head_dim == 128) return (int)by_rows<bf16, 128, kFolded>(a);
  if (dtype == 1 && a.head_dim == 64) return (int)by_rows<float, 64, kFolded>(a);
  if (dtype == 1 && a.head_dim == 128) return (int)by_rows<float, 128, kFolded>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points, bound with ctypes (kernels/flash_v1.py).  Pointers are
// device pointers of contiguous tensors: q, o [B, H, N_q, D]; k, v [B, H,
// N_kv, D] (equal head counts), D = head_dim, 64 or 128; causal requires
// n_q == n_kv.  rows: query rows per block (kernels/flash_v1.py::
// v1_tile_rows), 32 or 64 streaming, 16, 32 or 64 folded.  dtype: 0 =
// bf16, 1 = fp32.  Each returns its launch's cudaError_t (0 on success).
extern "C" int fam_flash_v1(const void* q, const void* k, const void* v, void* o,
                            int batch, int n_heads, int n_q, int n_kv, int head_dim,
                            int rows, float sm_scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, o, batch, n_heads, n_q, n_kv, head_dim, rows, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, dtype);
}

// Folded: n_kv <= 512, and the block of `rows` must fit its shared memory.
// The grid covers every (batch element, head, Q tile); the JAX kernel's
// fold of batch elements per step only picks this route (the wrapper
// checks that it divides the batch).
extern "C" int fam_flash_v1_folded(const void* q, const void* k, const void* v, void* o,
                                   int batch, int n_heads, int n_q, int n_kv, int head_dim,
                                   int rows, float sm_scale, int causal, int dtype,
                                   void* stream) {
  const Args a{q, k, v, o, batch, n_heads, n_q, n_kv, head_dim, rows, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, dtype);
}
