// The fused backward's dQ: one fp32 accumulator [B, H, N_q, D] that the
// KV tiles' blocks add to in KV-tile order, deterministic without slots.
//
// A fused block owns one KV tile j of one (batch, KV head) and computes,
// for each Q step it walks, that step's dQ contribution dS K (unscaled).
// Every 32 query rows of every q-head have one int32 counter: the number
// of KV tiles that have added to those rows so far.  The block of the
// KV tile of rank j among the tiles a step sees, in KV-tile order (tile j
// itself without a window), adds to the step's rows only once the counter
// reads j, then releases it as j + 1.  So each dQ element is
// ((s_0 + s_1) + s_2) + ..., summed in KV-tile order whatever the blocks'
// timing: the same bits on every run.  The first KV tile stores, the
// middle ones add in
// L2 (red.global.add: the turn orders them, the atomic only spares a
// read), and the last one a step sees reads the sum, adds its own, scales
// by sm_scale and writes dQ in q's dtype, so a step that sees one KV tile
// never touches the accumulator.
//
// Memory order: the threads that add (a block, or the fused kernel's
// producer warpgroup) write, meet a barrier, and one of them releases the
// counter (st.release.gpu); in the next KV tile's block one thread
// acquires it (ld.acquire.gpu) and the adding threads meet a barrier
// before any reads or adds.  The barriers carry the other threads'
// accesses into the release and out of the acquire (the pattern of
// CUTLASS's generic barrier).
//
// Forward progress.  A block spins only on blocks of lower KV tiles of its
// own (batch, KV head).  Blocks take their work item from a ticket
// (atomicAdd on counters[0]) in KV-tile-major order, not from blockIdx, so
// every item a spinning block waits on belongs to a block that is already
// running: no wait depends on the hardware's launch order.
//
// Bytes: the accumulator is N_q * D * 4 per q-head (33.5 MB at the training
// shape, D = 64), whatever the offset or n_kv.  The first design (one
// 64 x D fp32 slot per visible (Q tile, KV tile) pair, summed by a second
// kernel) grew with the visible pairs, N^2: 1.1 GB at B16 H8 N2048 D64,
// written to HBM and read back.  The adds still move one 64 x D fp32 tile
// per visible pair, but into a working set the H100's 50 MB L2 can hold.
//
// Users: the fused backward (flash_bwd.cu: the bf16 kernel of
// flash_bwd_fused_sm90.cuh and the fp32 template) and the triangular
// backward (flash_tri.cu), which launches the same kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {
namespace dq_ordered {

constexpr int kRows = 32;  // query rows per counter

// Visibility: row r sees column c when c < n_kv and c <= r + off, with off
// a static int (the triangular backward), or per batch on the device and
// read no higher than the host's bound (batch_offset); no causal mask is
// off = n_kv - 1.  A window narrows it further (window.cuh); the KV tiles
// a Q tile sees, in the order they add to it, are window.cuh's kv_runs.

// Last column row `row` sees (-1: none, also for padding rows).
__host__ __device__ __forceinline__ int last_visible(int row, int n_q, int n_kv, int off) {
  if (row >= n_q) return -1;
  return row + off < n_kv - 1 ? row + off : n_kv - 1;
}

// Batch b's offset: q_offset[b] read no higher than off_bound, or
// off_bound itself when q_offset is null.
__device__ __forceinline__ int batch_offset(const int* q_offset, int b, int off_bound) {
  return q_offset == nullptr ? off_bound : min(q_offset[b], off_bound);
}

// The counters' layout: [0] the ticket, then per (batch x q-head, 32-row
// chunk), chunk-fastest.
__host__ __device__ __forceinline__ int counter_count(int batch, int n_heads, int n_q) {
  return 1 + batch * n_heads * ((n_q + kRows - 1) / kRows);
}
__device__ __forceinline__ int* counter(int* counters, size_t bh, int n_q, int q_start) {
  return counters + 1 + bh * (size_t)((n_q + kRows - 1) / kRows) + q_start / kRows;
}

// The block's work item, in claim order: KV tile (slowest), then batch x KV
// head.  Every thread gets it.
__device__ __forceinline__ int claim(int* counters) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(counters, 1);
  __syncthreads();
  return ticket;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Wait until KV tiles 0 .. rank - 1 have added to the rows of `cnt`; the
// block's threads may then read and add.
__device__ __forceinline__ void wait_turn(const int* cnt, int rank) {
  if (threadIdx.x == 0) {
    while (load_acquire(cnt) < rank) {
    }
  }
  __syncthreads();
}

// Block-wide, after every thread's adds and a block barrier: hand the rows
// to KV tile rank + 1.
__device__ __forceinline__ void pass_turn(int* cnt, int rank) {
  if (threadIdx.x == 0) store_release(cnt, rank + 1);
}

template <typename T>
__device__ __forceinline__ T cast(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16(x);
  } else {
    return x;
  }
}

// One element's share: x is KV tile `rank`'s contribution to element idx,
// `last` the last KV tile its rows see.  The middle tiles add in L2
// (red.global.add.f32); the turn makes the adds ordered, not the atomic.
template <typename T>
__device__ __forceinline__ void add(float* acc, T* dq, size_t idx, float x, int rank, int last,
                                    float sm_scale) {
  if (rank == last) {
    const float sum = rank == 0 ? x : __ldcg(acc + idx) + x;
    dq[idx] = cast<T>(sum * sm_scale);
  } else if (rank == 0) {
    __stcg(acc + idx, x);
  } else {
    atomicAdd(acc + idx, x);  // no return value: red.global.add.f32 in L2
  }
}

__device__ __forceinline__ float4 plus(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ void store_scaled(__nv_bfloat16* dst, float4 x, float s) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x * s, x.y * s);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z * s, x.w * s);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// One float4 of add4's input: value, element index, row below n_q.
struct Part {
  float4 x;
  size_t at;
  bool ok;
};

// KV tile `rank`'s contribution to N float4s, float4 u of this thread
// (4 contiguous head-dim columns) read by get(u) as a Part.  The first
// tile stores, a middle one adds in L2 (red.global.add.v4.f32: fire and
// forget), the last reads the running sums (all N loads issued before any
// is used), adds its own after them, scales and writes dQ.
template <typename T, int N, typename Get>
__device__ __forceinline__ void add4(float* acc, T* dq, Get get, int rank, int last,
                                     float sm_scale) {
  if (rank == last) {
    float4 sum[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const Part p = get(u);
      sum[u] = rank > 0 && p.ok ? __ldcg(reinterpret_cast<const float4*>(acc + p.at))
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const Part p = get(u);
      if (p.ok) store_scaled(dq + p.at, rank > 0 ? plus(sum[u], p.x) : p.x, sm_scale);
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const Part p = get(u);
    if (!p.ok) continue;
    if (rank == 0) {
      __stcg(reinterpret_cast<float4*>(acc + p.at), p.x);
    } else {
      atomicAdd(reinterpret_cast<float4*>(acc + p.at), p.x);
    }
  }
}

}  // namespace dq_ordered
}  // namespace
