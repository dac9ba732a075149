// The dQ workspace of the backward kernels that keep dK and dV of one KV tile
// in a block: the triangular backward (flash_tri.cu) and the fused one
// (flash_bwd.cu).
//
// Each (Q tile, KV tile) pair that a head's rows see has one fp32 64 x 64
// slot, into which the KV tile's block writes the pair's dQ contribution
// dS K (unscaled).  A head's slots are packed: Q tile i owns slots
// first_slot(i) .. first_slot(i) + visible_kv_tiles(i) - 1, in KV-tile order,
// and a head holds visible_pairs slots.  reduce_kernel sums each Q tile's
// slots in that order and scales: every dQ element is summed in a fixed
// order, so the backward is deterministic with no atomics.
//
// Visibility: row r sees column c when c < n_kv and c <= r + off.  The
// triangular backward's offset is static; the fused backward's are per batch
// on the device, read no higher than the bound its workspace was sized for
// (batch_offset); no causal mask is off = n_kv - 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {
namespace dq_slots {

constexpr int kTile = 64;  // rows of a Q tile, columns of a KV tile, head dim
constexpr int kTileElems = kTile * kTile;  // one slot
constexpr int kReduceThreads = 256;

// Last column row `row` sees (-1: none, also for padding rows).
__host__ __device__ __forceinline__ int last_visible(int row, int n_q, int n_kv,
                                                     int off) {
  if (row >= n_q) return -1;
  return row + off < n_kv - 1 ? row + off : n_kv - 1;
}

// KV tiles that Q tile i sees: tiles 0 .. visible_kv_tiles - 1.
__host__ __device__ __forceinline__ int visible_kv_tiles(int i, int n_q, int n_kv,
                                                         int off) {
  const int last_row = (i + 1) * kTile < n_q ? (i + 1) * kTile - 1 : n_q - 1;
  const int limit = last_visible(last_row, n_q, n_kv, off);
  return limit < 0 ? 0 : limit / kTile + 1;
}

// Q tile i's first slot: the visible pairs of the Q tiles before it.
__host__ __device__ __forceinline__ int first_slot(int i, int n_q, int n_kv, int off) {
  int slot = 0;
  for (int ii = 0; ii < i; ++ii) slot += visible_kv_tiles(ii, n_q, n_kv, off);
  return slot;
}

// Slots of one head.
inline int visible_pairs(int n_q, int n_kv, int off) {
  return first_slot((n_q + kTile - 1) / kTile, n_q, n_kv, off);
}

// Batch b's offset: q_offset[b] read no higher than off_bound (the offset
// the workspace was sized for), or off_bound itself when q_offset is null.
__device__ __forceinline__ int batch_offset(const int* q_offset, int b, int off_bound) {
  return q_offset == nullptr ? off_bound : min(q_offset[b], off_bound);
}

// One block per (batch x head, Q tile i): dQ of the tile, the sum of its
// slots in KV-tile order, scaled.  A tile that sees nothing gets 0.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const float* __restrict__ ws, const int* __restrict__ q_offset,
                  int off_bound, T* __restrict__ dq, int n_heads, int n_q, int n_kv,
                  int n_pairs, float sm_scale) {
  const size_t bh = blockIdx.x;
  const int i = blockIdx.y;
  const int off = batch_offset(q_offset, (int)(bh / n_heads), off_bound);
  const int n_slots = visible_kv_tiles(i, n_q, n_kv, off);
  const float* base = ws + (bh * n_pairs + first_slot(i, n_q, n_kv, off)) * kTileElems;
  const int rows_valid = min(kTile, n_q - i * kTile);
  T* dst = dq + (bh * n_q + (size_t)i * kTile) * kTile;
  for (int e = threadIdx.x; e < rows_valid * kTile; e += kReduceThreads) {
    float acc = 0.0f;
    for (int j = 0; j < n_slots; ++j) acc += base[(size_t)j * kTileElems + e];
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      dst[e] = __float2bfloat16(acc * sm_scale);
    } else {
      dst[e] = acc * sm_scale;
    }
  }
}

template <typename T>
cudaError_t launch_reduce(const float* ws, const int* q_offset, int off_bound, T* dq,
                          int batch, int n_heads, int n_q, int n_kv, int n_pairs,
                          float sm_scale, cudaStream_t stream) {
  const dim3 grid(batch * n_heads, (n_q + kTile - 1) / kTile);
  reduce_kernel<T><<<grid, kReduceThreads, 0, stream>>>(
      ws, q_offset, off_bound, dq, n_heads, n_q, n_kv, n_pairs, sm_scale);
  return cudaGetLastError();
}

}  // namespace dq_slots
}  // namespace
