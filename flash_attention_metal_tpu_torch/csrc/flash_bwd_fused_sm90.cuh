// The fused 5-matmul backward redesigned for Hopper (sm_90a), bf16, head dim
// 64 or 128.  Included by flash_bwd.cu, whose C entry fam_flash_bwd_fused
// launches it for bf16 (dK and dV stored in bf16) and the FMA template
// there for fp32; and by flash_tri.cu, whose C entry fam_flash_tri_bwd
// launches it for bf16 with one int offset and dK and dV stored in fp32.
//
// Replaces flash_attention_metal_tpu/kernels/flash_bwd.py::_fused_bwd_kernel
// (flash_attention_bwd_fused), which the backward router takes where the
// autotuner's saved decision names it, and flash_tri.py::_tri_bwd_kernel
// (flash_attention_bwd_tri), the router's default for causal calls with a
// static offset and equal head counts: both compute S and P once per
// visible pair for dQ, dK and dV.  The contract is flash_bwd.cu's: native
// GQA with dK/dV summed over the group in fp32 inside the block, per-batch
// device offsets read no higher than the host's bound (or one int offset),
// the lse sentinel, P and dS rounded to bf16 before their products, dQ
// summed over KV tiles in KV-tile order and then scaled, deterministic.
// The fp32 sums of dK and dV are stored in TKV: bf16 for the fused entry,
// fp32 for the triangular one (the Pallas kernel's output type).
//
// What bounds it on the H100.  At the training shape (q [4,16,2048,64],
// kv [4,8,2048,64], causal) the five products are ~86 GFLOP of visible
// pairs: 0.0869 ms at 989 TF/s; its I/O is ~50 MB.  The first design (the
// WMMA template) lost 3.4x to SDPA's backward for two reasons: every
// product round-tripped through shared memory, and each visible (Q tile,
// KV tile) pair wrote a 64 x D fp32 dQ slot that a second kernel read back
// (1.1 GB at D = 64, 0.33 ms of HBM traffic alone).
//
// The design.
//   * The mainloop is the split pair's dK/dV kernel (flash_bwd_sm90.cuh):
//     one consumer warpgroup per 64-row KV tile; S^T = K Q^T and dP^T =
//     V dO^T on wgmma; P^T and dS^T formed in registers and packed by
//     acc_to_a into the register A operands of dV += P^T dO and dK += dS^T
//     Q; Q, dO, lse and delta in a 2-stage ring, in Q steps of 64 rows
//     (D = 64) or 32 rows (D = 128).
//   * The fifth product needs the step's dS, which the consumers hold
//     transposed (rows = KV), as a shared-memory operand: stmatrix.trans
//     writes it once per step from the packed registers the dK product
//     reads into a swizzled bf16 [q rows][64] tile (K-major).  At D = 64
//     the step has 64 q rows, so it is dQ = dS K (M = 64 q rows, A the dS
//     tile, B the K tile through the MN-major descriptor); at D = 128 the
//     step has 32 rows and wgmma needs M >= 64, so it is dQ^T = K^T dS^T
//     (M = the head dim in two m64 products, A the K tile transposed, B
//     the dS tile).  Either costs 32 fp32 registers a thread.
//   * dQ is accumulated in place, in KV-tile order (dq_ordered.cuh): one
//     fp32 [B, H, N_q, D] accumulator and a counter per 32 query rows, in
//     place of N^2 slots and a reduce kernel.  The consumers stage each
//     step's dQ in one of two padded fp32 [q rows][D] tiles; a producer
//     warpgroup waits for the turn and adds float4s of contiguous columns
//     (red.global.add.v4.f32) while the consumers run the next step, and
//     fills the ring with cp.async.  Named barriers hand stages and tiles
//     between the two; the producer gives registers to the consumers
//     (setmaxnreg 64 / 192), so two 256-thread blocks share an SM.
//   * Blocks claim (KV tile, batch x KV head) items from a ticket, KV tile
//     0 first.  A block walks its Q steps from the last one down: KV tile
//     j's walk is then one step shorter than tile j - 1's at its start, so
//     the wait for tile j - 1's add is absorbed by the shorter walk instead
//     of growing with j (an ascending walk would meet tile j - 1 at every
//     step, j steps late).
//   * Under a sliding window with sinks (window.cuh) a KV tile walks only
//     the Q steps that see it, and a Q step's adders are the KV tiles of its
//     own walk (kv_runs: the sink tiles, then the window's): a block adds
//     when the step's counter reaches its rank among them, and the last of
//     them writes dQ.  Every adder walks the step, so every turn comes.
//     Segment ids are an element test (the step's Q ids ride the ring, the
//     block's KV ids are read once per thread).
//   * KV tile 0's block writes zeros to the dQ rows of the Q steps that
//     see no column (causal with a negative offset) and which no
//     block adds to.
//   * Measured slower on the H100 and not taken (PERF.md, section 6): two
//     consumer warpgroups per 128-row KV block (half the adds' bytes, one
//     block per SM), adds straight from the fragment with per-warp turns,
//     the dQ tile over the ring stage for a third block per SM, a relaxed
//     spin with an acquire fence, the adds by the consumers themselves
//     (5% slower), and a producer warp without setmaxnreg (spills).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dq_ordered.cuh"
#include "flash_bwd_sm90.cuh"
#include "sm90_tiles.cuh"
#include "window.cuh"

namespace {
namespace sm90 {

// Row pitch of the step's fp32 dQ tile: 4 floats of padding, so the
// fragment's writes and the float4 row reads fall on distinct banks.
template <int D>
constexpr int kDqPitchOf = D + 4;

// The block: a warpgroup of consumers (the products) and a producer
// warpgroup (the ring's copies and the ordered dQ adds), which gives its
// registers to the consumers (setmaxnreg): 2 blocks of 256 threads share
// an SM's 64K registers as 2 x 128 x (kConsumerRegs + kProducerRegs).
constexpr int kProducer = kThreads;            // first thread of the producer warpgroup
constexpr int kFusedThreads = 2 * kThreads;
constexpr int kProducerRegs = 64;
constexpr int kConsumerRegs = 192;
// Named barriers (0 is __syncthreads): the consumers' own, the producers'
// own, then per ring stage "full" (copies landed) and "empty" (products
// done), then per dQ buffer "full" (staged) and "empty" (added).
enum : int {
  kBarConsumers = 1, kBarProducers = 2, kBarFull = 3, kBarEmpty = 5, kBarDqFull = 7,
  kBarDqEmpty = 9
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int D>
struct FusedSmem {
  static constexpr int kRows = DkvStep<D>::kRows;
  bf16 k[kTile * D];
  bf16 v[kTile * D];
  bf16 q[kStages][kRows * D];
  bf16 dout[kStages][kRows * D];
  bf16 ds[kRows * kTile];  // the step's dS, [Q rows][64 KV columns], swizzled
  float lse[kStages][kRows];
  float delta[kStages][kRows];
  int qids[kStages][kRows];  // the step's Q segment ids
  float dq[2][kRows * kDqPitchOf<D>];  // staged dQ, [q row][head dim], two buffers
};

// One block per (KV tile, batch x KV head) work item, claimed in that order
// from counters[0]: dK and dV of the tile over the group's q-heads and
// their visible Q steps, and each step's dQ contribution added to dq_acc in
// KV-tile order.  Consumer warp w owns KV rows 16w..16w+15 of S^T, dP^T, dK
// and dV.  q_offset null: off_bound is every batch's offset (n_kv - 1: every
// column visible).  dK and dV are stored in TKV (bf16 or float).  f: the
// window and the segment ids, read only with kFeat (without, the kernel
// holds no feature state).
template <int D, typename TKV, bool kFeat>
__global__ void __launch_bounds__(kFusedThreads, 2)
    flash_bwd_fused_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                const int* __restrict__ q_offset, int off_bound,
                                TKV* __restrict__ dk, TKV* __restrict__ dv,
                                bf16* __restrict__ dq, float* __restrict__ dq_acc,
                                int* __restrict__ counters, int batch, int n_heads,
                                int n_kv_heads, int n_q, int n_kv, float sm_scale,
                                float scale_log2, Feat f) {
  constexpr int kRows = DkvStep<D>::kRows;
  constexpr int kDqPitch = kDqPitchOf<D>;
  extern __shared__ unsigned char smem_raw[];
  FusedSmem<D>& sm = *reinterpret_cast<FusedSmem<D>*>(aligned_smem(smem_raw));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g8 = lane >> 2;
  const int t = lane & 3;
  const int ticket = dq_ordered::claim(counters);
  const int kv_tile = ticket / (batch * n_kv_heads);
  const int bkv = ticket % (batch * n_kv_heads);  // batch x KV head
  const int kv_start = kv_tile * kTile;
  const int b = bkv / n_kv_heads;
  const int h_kv = bkv % n_kv_heads;
  const int group = n_heads / n_kv_heads;
  const size_t kv_rows = (size_t)bkv * n_kv;
  const int off = q_offset == nullptr ? off_bound : min(q_offset[b], off_bound);
  // Rows r >= kv_start - off see the tile's first column; earlier Q steps
  // see none of it and are skipped, and so are the Q steps past the last
  // whose window reaches the tile.
  const int q_first = max(0, kv_start - off) / kRows;
  const int q_last = (kFeat ? q_end<kRows>(kv_start, min(kv_start + kTile, n_kv) - 1, off, n_q,
                                           f.window, f.sinks)
                            : (n_q + kRows - 1) / kRows) - 1;
  const int per_head = max(0, q_last + 1 - q_first);
  const int n_steps = group * per_head;
  // The KV tiles the Q step at q_start sees, in its order: the adders of
  // its dQ rows (without a window, tiles 0 .. its last row's diagonal).
  auto adders_at = [&](int q_start) {
    const int row_end = min(q_start + kRows, n_q) - 1;
    if constexpr (kFeat) {
      return kv_runs<kTile>(q_start + off, row_end + off, n_kv, f.window, f.sinks);
    }
    const int limit = min(row_end + off, n_kv - 1);
    return TileRuns{0, 0, 0, limit < 0 ? 0 : limit / kTile + 1};
  };

  // KV tile 0: the Q steps that see no column at all; no block adds to them.
  if (kv_tile == 0) {
    for (int q_start = 0; q_start < n_q; q_start += kRows) {
      if (adders_at(q_start).steps() > 0) continue;
      const int rows = min(kRows, n_q - q_start);
      for (int g = 0; g < group; ++g) {
        bf16* dst = dq + (((size_t)b * n_heads + h_kv * group + g) * n_q + q_start) * D;
        for (int i = threadIdx.x; i < rows * D / 8; i += kFusedThreads) {
          reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
        }
      }
    }
  }

  // Step i: q-head i / per_head, Q step q_last - i % per_head (the walk
  // runs down), ring stage i % 2.
  auto q_start_of = [&](int i) { return (q_last - i % per_head) * kRows; };
  auto q_rows_of = [&](int i) {
    return ((size_t)b * n_heads + h_kv * group + i / per_head) * n_q;
  };

  // Warp-uniform role, as the compiler can see it.
  if (__shfl_sync(0xffffffffu, threadIdx.x >= kProducer, 0)) {
    // The producer warpgroup.  Step i's Q, dO, lse and delta go to stage
    // i % 2 once the consumers are done with step i - 2; the dQ of each
    // adding step is added in KV-tile order while the consumers run the
    // next.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int p = threadIdx.x - kProducer;
    auto fetch = [&](int i) {
      const int q_start = q_start_of(i);
      const size_t q_rows = q_rows_of(i);
      const int rows_valid = n_q - q_start;
      const int s = i % kStages;
      constexpr int kChunks = D / 8;
      for (int c = p; c < kRows * kChunks; c += kThreads) {
        const int r = c / kChunks;
        const int ch = c % kChunks;
        const bool valid = r < rows_valid;
        const size_t at = valid ? (q_rows + q_start + r) * D + ch * 8 : 0;
        cp_async16(sm.q[s] + swz<kRows>(r, ch), q + at, valid);
        cp_async16(sm.dout[s] + swz<kRows>(r, ch), dout + at, valid);
      }
      for (int r = p; r < kRows; r += kThreads) {
        const bool valid = r < rows_valid;
        const size_t at = valid ? q_rows + q_start + r : 0;
        cp_async4(sm.lse[s] + r, lse + at, valid);
        cp_async4(sm.delta[s] + r, delta + at, valid);
        if (kFeat && f.q_seg != nullptr) {
          cp_async4(sm.qids[s] + r, f.q_seg + (valid ? (size_t)b * n_q + q_start + r : 0), valid);
        }
      }
      cp_async_commit();
    };
    int n_add = 0;
    auto add_step = [&](int i) {
      const int q_start = q_start_of(i);
      const TileRuns adders = adders_at(q_start);
      const int rank = adders.rank(kv_tile);
      if (rank < 0) return;
      const int last = adders.steps() - 1;
      const int buf = n_add++ % 2;
      const size_t q_rows = q_rows_of(i);
      int* cnt = dq_ordered::counter(counters, q_rows / n_q, n_q, q_start);
      bar_sync(kBarDqFull + buf, kFusedThreads);
      if (p == 0) {
        while (dq_ordered::load_acquire(cnt) < rank) {
        }
      }
      bar_sync(kBarProducers, kThreads);
      const float* tile = sm.dq[buf];
      constexpr int kVec = 4;  // float4s in flight a thread
      constexpr int kChunks = kRows * D / 4 / kThreads / kVec;
#pragma unroll 1
      for (int u0 = 0; u0 < kChunks; ++u0) {
        dq_ordered::add4<bf16, kVec>(
            dq_acc, dq,
            [&](int u) {
              const int i4 = p + (u0 * kVec + u) * kThreads;
              const int r = i4 / (D / 4);
              const int c = i4 % (D / 4) * 4;
              return dq_ordered::Part{*reinterpret_cast<const float4*>(&tile[r * kDqPitch + c]),
                                      (q_rows + q_start + r) * D + c, q_start + r < n_q};
            },
            rank, last, sm_scale);
      }
      bar_sync(kBarProducers, kThreads);
      if (p == 0) dq_ordered::store_release(cnt, rank + 1);
      bar_arrive(kBarDqEmpty + buf, kFusedThreads);
    };
    // Both dQ buffers start empty.
    bar_arrive(kBarDqEmpty + 0, kFusedThreads);
    bar_arrive(kBarDqEmpty + 1, kFusedThreads);
    for (int i = 0; i < min(n_steps, kStages); ++i) {
      fetch(i);
      cp_async_wait_all();
      bar_arrive(kBarFull + i, kFusedThreads);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStages;
      const bool refill = i + kStages < n_steps;
      if (refill) {
        bar_sync(kBarEmpty + s, kFusedThreads);  // step i's products are done
        fetch(i + kStages);
      }
      add_step(i);
      if (refill) {
        cp_async_wait_all();
        bar_arrive(kBarFull + s, kFusedThreads);
      }
    }
    // The consumers' "empty" of the last two steps.
    for (int i = max(0, n_steps - kStages); i < n_steps; ++i) {
      bar_sync(kBarEmpty + i % kStages, kFusedThreads);
    }
    return;
  }

  // The consumer warpgroup.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // This thread's two KV rows (accumulator rows g8 and g8 + 8 of its warp),
  // and their segment ids.
  const int c_lo = kv_start + warp * 16 + g8;
  int kid[2] = {0, 0};
  if (kFeat && f.kv_seg != nullptr) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      kid[half] = f.kv_seg[(size_t)b * n_kv + min(c_lo + half * 8, n_kv - 1)];
    }
  }
  load_tile<D, kTile>(sm.k, k + (kv_rows + kv_start) * D, n_kv - kv_start);
  load_tile<D, kTile>(sm.v, v + (kv_rows + kv_start) * D, n_kv - kv_start);
  cp_async_commit();
  cp_async_wait_all();
  bar_sync(kBarConsumers, kThreads);

  float dk_acc[D / 2] = {};
  float dv_acc[D / 2] = {};
  int n_add = 0;
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kStages;
    const int q_start = q_start_of(i);
    bar_sync(kBarFull + s, kFusedThreads);

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
    // e >= 2), q row q_start + 8 j + 2 t + (e & 1).
    bool full = kv_start + kTile - 1 <= q_start + off && q_start + kRows <= n_q;
    if constexpr (kFeat) {
      full = full && f.q_seg == nullptr &&
             tile_in_window(kv_start, kTile, q_start + kRows - 1 + off, f.window, f.sinks);
    }
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
        float pv = exp2f(st[4 * j + e] * scale_log2 - lse2[e & 1]);
        bool hidden = r >= n_q || c > r + off;
        if constexpr (kFeat) {
          hidden = hidden || !in_window(c, r + off, f.window, f.sinks) ||
                   (f.q_seg != nullptr && sm.qids[s][col + (e & 1)] != kid[e >> 1]);
        }
        if (!full && hidden) pv = 0.0f;
        st[4 * j + e] = pv;
        dpt[4 * j + e] = pv * (dpt[4 * j + e] - dlt[e & 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the A operands from registers.  The
    // packed dS^T operands go to the dS tile transposed (stmatrix.trans:
    // the four 8 x 8 blocks of k16 step kk are q rows 16 kk .. 16 kk + 15
    // by this warp's 16 KV columns, chunks 2 w and 2 w + 1 of each row), so
    // the tile holds the same bf16 values the dK product reads.
    uint32_t ap[kRows / 16][4], ads[kRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      acc_to_a(ap[kk], st + 8 * kk);
      acc_to_a(ads[kk], dpt + 8 * kk);
      const int m = lane >> 3;  // the 8 x 8 block whose row this lane addresses
      const int row = kk * 16 + (m >> 1) * 8 + (lane & 7);
      stmatrix_trans(&sm.ds[swz<kRows>(row, 2 * warp + (m & 1))], ads[kk]);
    }
    // The dS tile is read by the tensor cores (the async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(kBarConsumers, kThreads);
    // The fifth product, as dQ = dS K at D = 64 (M = the step's 64 q rows,
    // A the dS tile, B the K tile through the MN-major descriptor), and as
    // dQ^T = K^T dS^T at D = 128 (M = the head dim in two m64 products,
    // since the step has 32 rows; A the K tile transposed, B the dS tile).
    float dqt[D / 64][kRows / 2] = {};
    fence_acc(dv_acc);
    fence_acc(dk_acc);
#pragma unroll
    for (int mh = 0; mh < D / 64; ++mh) fence_acc(dqt[mh]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma(dv_acc, ap[kk], desc_mn<kRows>(sm.dout[s], kk));
      wgmma(dk_acc, ads[kk], desc_mn<kRows>(sm.q[s], kk));
    }
    if constexpr (D == 64) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma_tb(dqt[0], desc_k<kRows>(sm.ds, kk), desc_mn<kTile>(sm.k, kk));
      }
    } else {
#pragma unroll
      for (int mh = 0; mh < D / 64; ++mh) {
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          wgmma_ta(dqt[mh], desc_mn<kTile>(sm.k + mh * kTile * 64, kk),
                   desc_k<kRows>(sm.ds, kk));
        }
      }
    }
    wgmma_wait(dv_acc);
    fence_acc(dk_acc);
#pragma unroll
    for (int mh = 0; mh < D / 64; ++mh) fence_acc(dqt[mh]);
    bar_arrive(kBarEmpty + s, kFusedThreads);  // stage s may be refilled

    if (adders_at(q_start).rank(kv_tile) >= 0) {
      // dQ to a staging buffer, [q row][head dim], for the producer's adds.
      // D = 64, element e of n8 tile j: q row 16 w + g8 (+ 8 for e >= 2),
      // column 8 j + 2 t + (e & 1).  D = 128 (dQ^T), element e of n8 tile
      // j of half mh: column mh * 64 + 16 w + g8 (+ 8 for e >= 2), q row
      // 8 j + 2 t + (e & 1).
      const int buf = n_add++ % 2;
      float* tile = sm.dq[buf];
      bar_sync(kBarDqEmpty + buf, kFusedThreads);
      if constexpr (D == 64) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g8 + h * 8;
            *reinterpret_cast<float2*>(&tile[r * kDqPitch + j * 8 + 2 * t]) =
                make_float2(dqt[0][4 * j + 2 * h], dqt[0][4 * j + 2 * h + 1]);
          }
        }
      } else {
#pragma unroll
        for (int mh = 0; mh < D / 64; ++mh) {
#pragma unroll
          for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = j * 8 + 2 * t + (e & 1);
              const int d = mh * 64 + warp * 16 + g8 + (e >> 1) * 8;
              tile[r * kDqPitch + d] = dqt[mh][4 * j + e];
            }
          }
        }
      }
      bar_arrive(kBarDqFull + buf, kFusedThreads);
    }
  }
  // The producer's arrivals on both buffers not yet waited for: its
  // starting ones, or its last adds; then every add is done.
  bar_sync(kBarDqEmpty + 0, kFusedThreads);
  bar_sync(kBarDqEmpty + 1, kFusedThreads);

  for (int half = 0; half < 2; ++half) {
    const int c = c_lo + half * 8;
    if (c < n_kv) {
      store_row<D>(dk + (kv_rows + c) * D, dk_acc, half, sm_scale, t);
      store_row<D>(dv + (kv_rows + c) * D, dv_acc, half, 1.0f, t);
    }
  }
}

// q, dout, dq [B, H, N_q, D]; k, v [B, H_kv, N_kv, D], dk, dv the same in
// TKV; lse, delta fp32 [B, H, N_q]; q_offset int32 [B] or null (off_bound
// for every batch); dq_acc fp32 [B, H, N_q, D]; counters int32
// [dq_ordered::counter_count], zero.  kFeat: the kernel that reads f.
template <int D, typename TKV, bool kFeat = false>
cudaError_t launch_fused(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const int* q_offset, int off_bound,
                         void* dk, void* dv, void* dq, float* dq_acc, int* counters, int batch,
                         int n_heads, int n_kv_heads, int n_q, int n_kv, float sm_scale,
                         cudaStream_t stream, const Feat& f = Feat{}) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(FusedSmem<D>) + kAlign;
  cudaError_t err = allow_smem(flash_bwd_fused_sm90_kernel<D, TKV, kFeat>, smem, done);
  if (err != cudaSuccess) return err;
  const int items = (n_kv + kTile - 1) / kTile * batch * n_kv_heads;
  flash_bwd_fused_sm90_kernel<D, TKV, kFeat><<<items, kFusedThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), q_offset, off_bound, static_cast<TKV*>(dk),
      static_cast<TKV*>(dv), static_cast<bf16*>(dq), dq_acc, counters, batch, n_heads,
      n_kv_heads, n_q, n_kv, sm_scale, sm_scale * kLog2e, f);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace
