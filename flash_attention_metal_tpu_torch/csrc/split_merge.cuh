// The merge of a split-KV grid's partials, shared by the two grids that
// split a KV row across blocks: the decode grid (flash_decode.cuh, n_q <=
// 16) and the wgmma forward's folded walk (flash_fwd_sm90.cuh, FoldWalk:
// bf16 GQA-folded calls of more than 16 rows).
//
// Layout of the partials, fp32 in one workspace (kernels/flash_fwd.py::
// split_args): partial (unit, s, r) of split s, row r of a unit (a
// (q-head, batch) of n_q rows) is p = (unit * n_splits + s) * n_q + r; its
// unnormalised o at part[p * D], its row max m (log2 units; -inf when the
// split saw no column of the row) at part[n_part * D + p] and its row sum l
// at part[n_part * (D + 1) + p], n_part the partials of the whole call.
//
// The last block of a group of splits to arrive (the splits of a (q-head,
// batch) on the decode grid, of a (q tile, q-head, batch) on the folded
// grid), told by a ticket it resets itself, merges the group's rows in
// split order: one launch, the same bits on every run.  The barrier, then
// one thread's acq_rel add, publish this block's partial and see the
// earlier blocks' (as dq_ordered.cuh's turns do).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {
namespace split_merge {

constexpr float kMergeLn2 = 0.6931471805599453f;

// Whether this block is the last of the n_splits blocks that share
// `ticket` to arrive (every thread of the block gets the answer).
__device__ __forceinline__ bool last_to_arrive(int* ticket, int n_splits) {
  __shared__ int is_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int arrived;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(arrived) : "l"(ticket) : "memory");
    is_last = arrived == n_splits - 1;
  }
  __syncthreads();
  return is_last;
}

// Four consecutive outputs at dst (16-byte aligned for fp32, 8 for bf16).
__device__ __forceinline__ void put4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void put4(__nv_bfloat16* dst, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// Rows r0 .. r0 + rows - 1 of `unit` merged from its n_splits partials
// into o (rows q_rows + r, D elements each; T bf16 or fp32) and, when lse
// is set, the natural-log lse, by a block of kThreads threads; a split with
// m = -inf weighs 0, and a row that no split saw gives o = 0 and lse =
// -inf.  Then the ticket is reset, ready for the next call on this stream.
// A thread takes 4 columns of a row at a time (one 16-byte load a split),
// and the split loops are unrolled so that a thread's loads are in flight
// together: the merge is a chain of L2 round trips, n_splits long a pass
// (a 40-row fold's merge was most of its call with one column a thread).
template <int D, int kThreads, typename T>
__device__ __forceinline__ void merge_rows(const float* part, size_t n_part, int unit,
                                           int n_splits, int n_q, int r0, int rows, T* o,
                                           float* lse, size_t q_rows, int* ticket) {
  constexpr int kQuads = D / 4;  // 4-column pieces of a row
  const int tid = threadIdx.x;
  const float* part_m = part + n_part * D;
  const float* part_l = part_m + n_part;
  for (int i = tid; i < rows * kQuads; i += kThreads) {
    const int r = r0 + i / kQuads, d = (i % kQuads) * 4;
    const size_t p0 = (size_t)unit * n_splits * n_q + r;  // split s's row at p0 + s * n_q
    float mx = -INFINITY;
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, __ldcg(part_m + p0 + (size_t)s * n_q));
    float4 om = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float lm = 0.0f;
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) {  // in split order: the same bits on every run
      const size_t p = p0 + (size_t)s * n_q;
      const float ms = __ldcg(part_m + p);
      const float weight = ms == -INFINITY ? 0.0f : exp2f(ms - mx);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(part + p * D + d));
      om.x += weight * x.x;
      om.y += weight * x.y;
      om.z += weight * x.z;
      om.w += weight * x.w;
      lm += weight * __ldcg(part_l + p);
    }
    const float inv_l = lm > 0.0f ? 1.0f / lm : 0.0f;
    put4(o + (q_rows + r) * D + d,
         make_float4(om.x * inv_l, om.y * inv_l, om.z * inv_l, om.w * inv_l));
    if (lse != nullptr && d == 0) {
      lse[q_rows + r] = lm > 0.0f ? (mx + log2f(lm)) * kMergeLn2 : -INFINITY;
    }
  }
  if (tid == 0) *ticket = 0;
}

}  // namespace split_merge
}  // namespace
