// The split backward pair redesigned for Hopper (sm_90a), bf16, head dim 64
// or 128: dK/dV and dQ.  Included by flash_bwd.cu, whose C entries
// (fam_flash_bwd_dkv, fam_flash_bwd_dq) launch these kernels for bf16 and
// the WMMA/FMA template there for fp32.
//
// Replaces flash_attention_metal_tpu/kernels/flash_bwd.py::_dkv_kernel
// (dK, dV over KV tiles) and ::_dq_kernel (dQ over Q tiles), the backward
// of every untuned training step.  The contract is flash_bwd.cu's: native
// GQA with dK/dV summed over the group in fp32 inside the block, per-batch
// device offsets, lse = -inf (and padding) rows held at a sentinel so their
// P is exactly 0, P and dS rounded to bf16 before their products, one owner
// per output tile and no atomics (deterministic).
//
// What bounds it on the H100.  At the training shape (q [4,16,2048,64],
// kv [4,8,2048,64], causal) the pair does 8 D + 6 D flops per visible
// (row, column) pair: 68.7 + 51.5 GFLOP against ~50 MB of I/O.  That is
// the tensor cores' side of the roofline: 0.0695 + 0.0521 ms at 989 TF/s.
//
// What the design does about the three faults of the first design (every
// product round-tripped through shared memory; no load overlapped compute;
// two 128-thread blocks of ~90 KB per SM):
//   * Products run on wgmma and stay in registers.  A block is one
//     warpgroup (4 warps of 16 rows); each product is wgmma.m64nNk16 (bf16
//     in, fp32 accumulate).  The dK/dV block computes the scores
//     transposed, S^T = K Q^T and dP^T = V dO^T, so the accumulator rows
//     are the block's 64 KV rows.  P^T and dS^T are formed there, rounded
//     to bf16 and packed straight into the register A operand of dV += P^T
//     dO and dK += dS^T Q (a 64-row accumulator's layout is the A-register
//     layout of the next product, two n8 tiles per k16 step).  The dQ block
//     does the same with S = Q K^T, dP = dO V^T and dQ += dS K.  Nothing of
//     S, P, dP or dS touches shared memory; dK, dV and dQ live in fp32
//     registers for the whole walk.  B operands (and the A of S and dP) are
//     read by the tensor cores from shared memory through descriptors:
//     K-major where the product's K runs along a tile row, MN-major
//     (transposed) where it runs down the rows, one copy of each tile
//     serving both.
//   * Loads overlap compute.  The walked tiles (Q, dO, lse and delta rows
//     for dK/dV; K and V for dQ) come through a 2-stage ring filled with
//     cp.async: tile i + 1 is in flight while tile i computes, and one
//     barrier per step orders the ring.  Tiles are stored in wgmma's
//     128-byte-swizzle layout (16-byte chunk c of row r at c ^ (r & 7), in
//     64-column blocks), so neither the copies nor the tensor cores' reads
//     conflict on banks and no padding is spent.
//   * More warps per SM.  Shared memory is 49.5 KB (dK/dV) and 48 KB (dQ)
//     at D = 64, so registers, not shared memory, bound the blocks per SM.
//     Blocks are launched heaviest first (KV tile 0, the last Q tile).
//
// Tiles, from the 227 KB and 255-register budgets: one warpgroup, a 64-row
// KV tile per dK/dV block and a 64-row Q tile per dQ block.  The dK/dV
// block walks Q tiles of 64 rows at D = 64 and 32 rows at D = 128 (S^T and
// dP^T take rows / 2 fp32 registers a thread each beside the D / 2 of dK
// and of dV: 128 at D = 64, 160 at D = 128); the dQ block walks KV tiles of
// 64 rows.  Shared memory at D = 128: 65 KB (dK/dV), 96 KB (dQ).
//
// Not done yet: TMA with mbarriers in place of cp.async, a producer warp
// and two consumer warpgroups per block (warp specialisation), and
// overlapping one step's softmax with the next step's products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tiles.cuh"
#include "wmma_tiles.cuh"  // kLseSentinel, allow_smem

namespace {
namespace sm90 {

// Q rows per step of the dK/dV walk.
template <int D>
struct DkvStep {
  static constexpr int kRows = D == 64 ? 64 : 32;
};

// lse in log2 units, sentinel-guarded.
__device__ __forceinline__ float lse_log2(float x) {
  return (x == -INFINITY ? kLseSentinel : x) * kLog2e;
}

template <int D>
struct DkvSmem {
  static constexpr int kRows = DkvStep<D>::kRows;
  bf16 k[kTile * D];
  bf16 v[kTile * D];
  bf16 q[kStages][kRows * D];
  bf16 dout[kStages][kRows * D];
  float lse[kStages][kRows];
  float delta[kStages][kRows];
};

// One block per (KV head x batch, KV tile), KV tile 0 first: dK and dV of
// the tile over the group's q-heads and their visible Q tiles.  Warp w owns
// KV rows 16w..16w+15 of every product; q_offset null: every column
// visible.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const int* __restrict__ q_offset, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int n_heads, int n_kv_heads, int n_q,
                              int n_kv, float sm_scale, float scale_log2) {
  constexpr int kRows = DkvStep<D>::kRows;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(aligned_smem(smem_raw));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int kv_start = blockIdx.y * kTile;
  const int b = blockIdx.x / n_kv_heads;
  const int h_kv = blockIdx.x % n_kv_heads;
  const int group = n_heads / n_kv_heads;
  const size_t kv_rows = (size_t)blockIdx.x * n_kv;
  const int off = q_offset == nullptr ? n_kv - 1 : min(q_offset[b], n_kv - 1);
  // Rows r >= kv_start - off see the tile's first column; earlier Q tiles
  // see none of it and are skipped.
  const int q_first = max(0, kv_start - off) / kRows;
  const int per_head = max(0, (n_q + kRows - 1) / kRows - q_first);
  const int n_steps = group * per_head;
  // This thread's two KV rows (accumulator rows g and g + 8 of its warp).
  const int c_lo = kv_start + warp * 16 + (lane >> 2);

  load_tile<D, kTile>(sm.k, k + (kv_rows + kv_start) * D, n_kv - kv_start);
  load_tile<D, kTile>(sm.v, v + (kv_rows + kv_start) * D, n_kv - kv_start);
  // Step i's Q tile, dO tile, lse and delta rows into ring stage i % 2.
  auto fetch = [&](int i) {
    const int qt = q_first + i % per_head;
    const size_t q_rows = ((size_t)b * n_heads + h_kv * group + i / per_head) * n_q;
    const int q_start = qt * kRows;
    const int rows_valid = n_q - q_start;
    const int s = i % kStages;
    load_tile<D, kRows>(sm.q[s], q + (q_rows + q_start) * D, rows_valid);
    load_tile<D, kRows>(sm.dout[s], dout + (q_rows + q_start) * D, rows_valid);
    load_rows<kRows>(sm.lse[s], lse + q_rows + q_start, rows_valid);
    load_rows<kRows>(sm.delta[s], delta + q_rows + q_start, rows_valid);
  };
  if (n_steps > 0) fetch(0);
  cp_async_commit();

  float dk_acc[D / 2] = {};
  float dv_acc[D / 2] = {};
  for (int i = 0; i < n_steps; ++i) {
    // Step i's tiles have landed, and every warp is done with step i - 1's
    // stage, which step i + 1's copies overwrite.
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_steps) fetch(i + 1);
    cp_async_commit();
    const int s = i % kStages;
    const int q_start = (q_first + i % per_head) * kRows;

    // S^T = K Q^T and dP^T = V dO^T: 64 KV rows by kRows q rows.
    float st[kRows / 2] = {};
    float dpt[kRows / 2] = {};
    fence_acc(st);
    fence_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma(st, desc_k<kTile>(sm.k, kk), desc_k<kRows>(sm.q[s], kk));
      wgmma(dpt, desc_k<kTile>(sm.v, kk), desc_k<kRows>(sm.dout[s], kk));
    }
    wgmma_wait(st);
    fence_acc(dpt);

    // P^T and dS^T in place.  Element e of n8 tile j: KV row c_lo (+ 8 for
    // e >= 2), q row q_start + 8 j + 2 t + (e & 1).  Steps whose every pair
    // is visible skip the compare.
    const bool full = kv_start + kTile - 1 <= q_start + off && q_start + kRows <= n_q;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[s][col]);
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[s][col]);
      const float lse2[2] = {lse_log2(l2.x), lse_log2(l2.y)};
      const float dlt[2] = {dl.x, dl.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q_start + col + (e & 1);
        const int c = c_lo + (e >> 1) * 8;
        float p = exp2f(st[4 * j + e] * scale_log2 - lse2[e & 1]);
        if (!full && (r >= n_q || c > r + off)) p = 0.0f;
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt[e & 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the A operands from registers.
    uint32_t ap[kRows / 16][4], ads[kRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      acc_to_a(ap[kk], st + 8 * kk);
      acc_to_a(ads[kk], dpt + 8 * kk);
    }
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma(dv_acc, ap[kk], desc_mn<kRows>(sm.dout[s], kk));
      wgmma(dk_acc, ads[kk], desc_mn<kRows>(sm.q[s], kk));
    }
    wgmma_wait(dv_acc);
    fence_acc(dk_acc);
  }
  cp_async_wait_all();

  for (int half = 0; half < 2; ++half) {
    const int c = c_lo + half * 8;
    if (c < n_kv) {
      store_row<D>(dk + (kv_rows + c) * D, dk_acc, half, sm_scale, t);
      store_row<D>(dv + (kv_rows + c) * D, dv_acc, half, 1.0f, t);
    }
  }
}

template <int D>
struct DqSmem {
  bf16 q[kTile * D];
  bf16 dout[kTile * D];
  bf16 k[kStages][kTile * D];
  bf16 v[kStages][kTile * D];
};

// One block per (q-head x batch, Q tile), the last Q tile first: dQ of the
// tile over its visible KV tiles.  Warp w owns Q rows 16w..16w+15.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const int* __restrict__ q_offset, bf16* __restrict__ dq,
                             int n_heads, int n_kv_heads, int n_q, int n_kv, float sm_scale,
                             float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(aligned_smem(smem_raw));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int b = blockIdx.x / n_heads;
  const int h_kv = blockIdx.x % n_heads / (n_heads / n_kv_heads);
  const size_t q_rows = (size_t)blockIdx.x * n_q;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;
  const int rows_valid = min(kTile, n_q - q_start);
  const int off = q_offset == nullptr ? n_kv - 1 : min(q_offset[b], n_kv - 1);
  // The KV walk stops at the last tile the tile's last row sees.
  const int limit = min(q_start + rows_valid - 1 + off, n_kv - 1);
  const int n_steps = limit < 0 ? 0 : limit / kTile + 1;

  load_tile<D, kTile>(sm.q, q + (q_rows + q_start) * D, rows_valid);
  load_tile<D, kTile>(sm.dout, dout + (q_rows + q_start) * D, rows_valid);
  // Step i's K and V tiles into ring stage i % 2.
  auto fetch = [&](int i) {
    const int kv_start = i * kTile;
    const int s = i % kStages;
    load_tile<D, kTile>(sm.k[s], k + (kv_rows + kv_start) * D, n_kv - kv_start);
    load_tile<D, kTile>(sm.v[s], v + (kv_rows + kv_start) * D, n_kv - kv_start);
  };
  if (n_steps > 0) fetch(0);
  cp_async_commit();

  // This thread's two Q rows (accumulator rows g and g + 8 of its warp):
  // lse in log2 units and delta; padding rows take the sentinel.
  const int r_lo = q_start + warp * 16 + (lane >> 2);
  float lse2[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + half * 8;
    lse2[half] = r < n_q ? lse_log2(lse[q_rows + r]) : kLseSentinel * kLog2e;
    dlt[half] = r < n_q ? delta[q_rows + r] : 0.0f;
  }

  float dq_acc[D / 2] = {};
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_steps) fetch(i + 1);
    cp_async_commit();
    const int s = i % kStages;
    const int kv_start = i * kTile;

    // S = Q K^T and dP = dO V^T: 64 Q rows by 64 KV columns.
    float st[kTile / 2] = {};
    float dpt[kTile / 2] = {};
    fence_acc(st);
    fence_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma(st, desc_k<kTile>(sm.q, kk), desc_k<kTile>(sm.k[s], kk));
      wgmma(dpt, desc_k<kTile>(sm.dout, kk), desc_k<kTile>(sm.v[s], kk));
    }
    wgmma_wait(st);
    fence_acc(dpt);

    // dS in place of dP.  Element e of n8 tile j: Q row r_lo (+ 8 for
    // e >= 2), KV column kv_start + 8 j + 2 t + (e & 1).
    const bool full = kv_start + kTile - 1 <= q_start + off && kv_start + kTile <= n_kv;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kv_start + j * 8 + 2 * t + (e & 1);
        const int r = r_lo + (e >> 1) * 8;
        float p = exp2f(st[4 * j + e] * scale_log2 - lse2[e >> 1]);
        if (!full && (c >= n_kv || c > r + off)) p = 0.0f;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt[e >> 1]);
      }
    }

    // dQ += dS K, the A operand from registers.
    uint32_t ads[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) acc_to_a(ads[kk], dpt + 8 * kk);
    fence_acc(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) wgmma(dq_acc, ads[kk], desc_mn<kTile>(sm.k[s], kk));
    wgmma_wait(dq_acc);
  }
  cp_async_wait_all();

  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + half * 8;
    if (r < n_q) store_row<D>(dq + (q_rows + r) * D, dq_acc, half, sm_scale, t);
  }
}

// Launchers: q, dout [B, H, N_q, D]; k, v, dk, dv [B, H_kv, N_kv, D]; lse,
// delta fp32 [B, H, N_q]; q_offset int32 [B] or null (every column).
template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const int* q_offset, void* dk,
                       void* dv, int batch, int n_heads, int n_kv_heads, int n_q, int n_kv,
                       float sm_scale, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(DkvSmem<D>) + kAlign;
  cudaError_t err = allow_smem(flash_bwd_dkv_sm90_kernel<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_kv_heads, (n_kv + kTile - 1) / kTile);
  flash_bwd_dkv_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), q_offset, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n_heads, n_kv_heads, n_q, n_kv, sm_scale, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const int* q_offset, void* dq,
                      int batch, int n_heads, int n_kv_heads, int n_q, int n_kv,
                      float sm_scale, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(DqSmem<D>) + kAlign;
  cudaError_t err = allow_smem(flash_bwd_dq_sm90_kernel<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (n_q + kTile - 1) / kTile);
  flash_bwd_dq_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), q_offset, static_cast<bf16*>(dq), n_heads, n_kv_heads,
      n_q, n_kv, sm_scale, sm_scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace
