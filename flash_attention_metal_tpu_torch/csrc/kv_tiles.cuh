// What the forward kernels over a KV cache share: the cache's addressing
// (dense or paged), its 8-bit element types, and the call of the split-KV
// decode grid, of the wgmma prefill and of the folded grid, whose instances
// live in translation units of their own (flash_decode*.cu, one per KV
// element type, flash_kv_sm90.cu and flash_fold_sm90.cu: nvcc builds them
// in parallel).  Users: flash_fwd.cu (its 64-row grid and the C entries),
// flash_decode.cuh, kv_sources_sm90.cuh and the two wgmma units.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "window.cuh"

namespace fam {

// Where the KV cache lives.  Dense: k, v [B, H_kv, n_kv, D] and scales
// [B, H_kv, n_kv].  Paged: k, v [n_pages, H_kv, page, D], scales
// [n_pages, H_kv, page], table [B, max_pages], n_kv = max_pages * page.
struct KvArgs {
  const void* k;
  const void* v;
  const float* k_scale;  // null for a bf16 / fp32 cache
  const float* v_scale;
  const int* table;      // null for a dense cache
  int n_kv;
  int page;
  int max_pages;
  int n_pages;
};

// One call of the decode grid (n_q <= 16), of the wgmma prefill or of the
// wgmma forward's folded grid: the 64-row grid's arguments and the split.
// kv_chunk: KV columns per split, a multiple of 64; part and tickets: the
// partials' workspace (split_merge.cuh) and one zeroed int32 per (q-head,
// batch) on the decode grid, per (64-row Q tile, q-head, batch) on the
// folded grid, read only when the chunk leaves more than one split (never
// by the prefill, which takes one split).
struct DecodeCall {
  const void* q;
  KvArgs kv;
  const int* q_offset;  // per batch, or null: fixed_offset for every batch
  void* o;
  float* lse;           // or null
  int batch;
  int n_heads;
  int n_kv_heads;
  int n_q;
  float sm_scale;
  int causal;
  int pos_div;
  int fixed_offset;
  int kv_chunk;
  float* part;
  int* tickets;
  cudaStream_t stream;
  int window = kNoWindow;  // a row sees c > position - window, or c < sinks
  int sinks = 0;
  float softcap = 0.0f;       // the score transforms (xf.cuh): 0 for no cap,
  const float* slopes = nullptr;  // fp32 [H_q] ALiBi slopes or null
  const int* kv_pos = nullptr;    // a rolling cache's int32 [B, n_kv] positions, or null
};

// The decode grid for a cache in q's own type (bf16 / fp32), int8, e4m3 and
// e5m2: dtype 0 = bf16 q, 1 = fp32 q; head_dim 64 or 128.
cudaError_t flash_decode_native(const DecodeCall& call, int dtype, int head_dim, bool paged);
cudaError_t flash_decode_int8(const DecodeCall& call, int dtype, int head_dim, bool paged);
cudaError_t flash_decode_e4m3(const DecodeCall& call, int dtype, int head_dim, bool paged);
cudaError_t flash_decode_e5m2(const DecodeCall& call, int dtype, int head_dim, bool paged);

// The bf16 prefill (bf16 q, pos_div 1, n_q > 16) of the 8-bit and paged
// caches on the wgmma forward (flash_kv_sm90.cu): kv_dtype 0 for a bf16
// cache (paged only), 1 int8, 2 e4m3, 3 e5m2; head_dim 64 or 128.
cudaError_t flash_kv_sm90(const DecodeCall& call, int kv_dtype, int head_dim, bool paged);

// The GQA-folded calls (bf16 q, pos_div > 1, n_q > 16, causal) of all four
// entries on the wgmma forward's split-KV folded grid (flash_fold_sm90.cu):
// kv_dtype 0 for a bf16 cache (dense or paged), 1 int8, 2 e4m3, 3 e5m2.
cudaError_t flash_fold_sm90(const DecodeCall& call, int kv_dtype, int head_dim, bool paged);

}  // namespace fam

namespace {

using bf16 = __nv_bfloat16;
using fam::KvArgs;

constexpr int kBlockN = 64;      // rows of a KV tile (a page holds whole tiles)
constexpr int kDecodeRows = 16;  // the most query rows the decode grid takes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

// Tags of the two 8-bit float formats (their bytes are loaded as uint8_t).
struct E4M3 {};
struct E5M2 {};

// The exact float value of one stored 8-bit element.
template <typename KV>
__device__ __forceinline__ float widen(uint8_t x);
template <>
__device__ __forceinline__ float widen<int8_t>(uint8_t x) {
  return static_cast<float>(static_cast<int8_t>(x));
}
template <>
__device__ __forceinline__ float widen<E4M3>(uint8_t x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}
template <>
__device__ __forceinline__ float widen<E5M2>(uint8_t x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E5M2)));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Row index (in head_dim rows of the K/V storage) of the KV tile that
// starts at logical column kv_start; the tile's rows are contiguous.
template <bool kPaged>
__device__ __forceinline__ size_t tile_row0(const KvArgs& kv, int b, int h_kv, int n_kv_heads,
                                            int kv_start) {
  if constexpr (kPaged) {
    const int logical = min(kv_start / kv.page, kv.max_pages - 1);
    const int phys = min(max(kv.table[(size_t)b * kv.max_pages + logical], 0), kv.n_pages - 1);
    return ((size_t)phys * n_kv_heads + h_kv) * kv.page + kv_start % kv.page;
  } else {
    return ((size_t)b * n_kv_heads + h_kv) * kv.n_kv + kv_start;
  }
}

}  // namespace
