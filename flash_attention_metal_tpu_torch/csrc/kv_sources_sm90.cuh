// The KV sources of the wgmma forward (flash_fwd_sm90.cuh) over the
// serving caches, beside its own DenseBf16: PagedBf16 (a bf16 page pool
// through an int32 table) and Src8<kPaged>, Dense8 and Paged8 (int8, e4m3
// or e5m2 tiles with per-token fp32 scales, widened exactly to bf16 while
// the products run).  Included by flash_kv_sm90.cu (the caches' bf16
// prefill) and flash_fold_sm90.cu (their GQA-folded calls), each of which
// instantiates its own kernels from them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "kv_tiles.cuh"

namespace {
namespace sm90 {

// A bf16 page pool through its table.
struct PagedBf16 {
  static constexpr bool kRaw = false;
  static constexpr bool kPaged = true;
  KvArgs kv;
  __device__ size_t row(size_t, int b, int h_kv, int n_kv_heads, int kv_start) const {
    return tile_row0<true>(kv, b, h_kv, n_kv_heads, kv_start);
  }
};

// Two floats that bf16 holds exactly, as bf16x2: their high halves (the
// low halves are zero), one byte permute.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// a * b + c on bf16x2 (exact here: a power of two times a bf16).
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Chunk x (8 stored bytes) widened to 8 bf16, the values kv_tiles.cuh::widen
// gives, with no conversion instruction (those run at a fraction of the
// integer and FMA rate, and the pass is on every step's CUDA-core chain).
// int8 (fmt 1): the byte b as the float 2^23 + (b ^ 0x80), less 2^23 + 128,
// packed by its high half.  e4m3 (2) and e5m2 (3): the byte's exponent and
// mantissa moved into a bf16's fields (e4m3 shifted left 4, e5m2 left 5; the
// sign to bit 15), then one bf16x2 FMA rescales by 2^(127 - bias), 2^120 or
// 2^112, which also makes the formats' subnormals bf16's normals.  Every
// finite value is exact.  A NaN or Inf byte would widen to a finite value;
// the caches hold none (quantize_tokens maps a token's absmax to the
// format's largest finite value), and the scales, read beside the bytes,
// still carry a NaN.  Timed against cvt-based widening in PERF.md, Findings.
__device__ __forceinline__ uint4 widen8(uint2 x, int fmt) {
  const uint32_t w[2] = {x.x, x.y};
  uint32_t out[4];
  if (fmt == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[j] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | j)) - 8388736.0f;
      }
      out[2 * i] = pack_exact(f[0], f[1]);
      out[2 * i + 1] = pack_exact(f[2], f[3]);
    }
  } else {
    const bool e4m3 = fmt == 2;
    const int shift = e4m3 ? 4 : 5;
    const uint32_t fields = e4m3 ? 0x07F007F0u : 0x0FE00FE0u;
    const uint32_t scale = e4m3 ? 0x7B807B80u : 0x77807780u;  // bf16x2 2^120, 2^112
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // Bytes 2h and 2h + 1 of the word, each in the low byte of a half.
        const uint32_t y = __byte_perm(w[i], 0u, h ? 0x4342 : 0x4140);
        const uint32_t bits = ((y << shift) & fields) | ((y << 8) & 0x80008000u);
        out[2 * i + h] = bf16x2_fma(bits, scale, 0x80008000u);  // + -0 keeps -0
      }
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// An 8-bit cache, dense [B, H_kv, N, D] with scales [B, H_kv, N] or paged
// [P, H_kv, page, D] with scales [P, H_kv, page]; fmt: 1 int8, 2 e4m3,
// 3 e5m2 (quant.py::KV_CODES).
template <bool kPaged_>
struct Src8 {
  static constexpr bool kRaw = true;
  static constexpr bool kPaged = kPaged_;
  KvArgs kv;
  const float* k_scale;
  const float* v_scale;
  int fmt;
  __device__ size_t row(size_t kv_rows, int b, int h_kv, int n_kv_heads, int kv_start) const {
    if constexpr (kPaged_) {
      return tile_row0<true>(kv, b, h_kv, n_kv_heads, kv_start);
    } else {
      return kv_rows + kv_start;
    }
  }
  __device__ uint4 widen(uint2 x) const { return widen8(x, fmt); }
};

}  // namespace sm90
}  // namespace
