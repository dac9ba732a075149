// The bf16 prefill of the 8-bit and paged KV caches on the wgmma forward
// (flash_fwd_sm90.cuh): every call of fam_flash_quant, fam_flash_paged and
// fam_flash_paged_quant (flash_fwd.cu) with bf16 q, pos_div 1 and more than
// kDecodeRows query rows, which the first-generation 64-row template of
// flash_fwd.cu ran before.  A translation unit of its own, so nvcc builds it
// beside the others.
//
// Replaces, at prefill, flash_attention_metal_tpu/kernels/quant.py::
// _quant_fwd_kernel (a dense int8 / e4m3 / e5m2 cache with per-token fp32
// scales [B, H_kv, N]), paged.py::flash_attention_paged (a bf16 page pool
// [P, H_kv, page, D] through an int32 table [B, max_pages]) and paged.py::
// flash_attention_paged_quant (an 8-bit pool with scales [P, H_kv, page]).
// The contract is flash_fwd.cu's; here it runs on the kernel's walks, one
// instance a (source, walk, head dim):
//   * the sources: PagedBf16 (a tile's rows from kv_tiles.cuh::tile_row0:
//     the logical page clamped to max_pages - 1, the physical one to
//     [0, P - 1]; a page holds whole 64-row tiles, so a tile is contiguous
//     and its 16-byte copies are the dense ones), and Src8<kPaged>, Dense8
//     and Paged8: the raw 8-bit tiles and their scales through the kernel's
//     raw ring, widened exactly to bf16 (the values of kv_tiles.cuh::widen,
//     by integer and FMA operations: widen8) while the products run; the
//     format (int8, e4m3, e5m2) is read at run time inside the widen pass,
//     outside every product, so one instance serves all three;
//   * the walks: DenseWalk (causal or not), FeatWalk<false> (a window with
//     its sinks), FeatWalk<false, true> (the softcap and ALiBi, with or
//     without a window) and, for Dense8 only, PosWalk (a rolling 8-bit
//     cache's kv_pos: every tile walked, the positions in the K ring's bit
//     stage).  The paged entries are always causal and take no positions;
//     none of the three takes segment ids or dropout, as in JAX.
// Arithmetic, as the template's: the K scale multiplies each fp32 score
// column (then sm_scale log2 e, the cap, the bias); the V scale multiplies
// P before it is rounded to bf16 for the PV product; the row sums take P
// unscaled.  A row with no visible column gives o = 0 and lse = -inf.
//
// What bounds it on the H100: at the serving prefill chunk (q [1,16,512,D]
// over a [1,8,2048,D] cache at offset 512) the products, ~n_q / 2 flops a
// KV byte: the tensor cores' side, as the dense prefill.  What the design
// does about the template's faults (K/V through registers and stored on
// the critical path, WMMA, S, P and PV through shared memory behind four
// barriers a step): the tiles come by cp.async a step ahead, the products
// are the dense kernel's wgmma with S, P and O in registers, and the widen
// pass is the one extra: ~2.5-3 integer and FMA instructions an element on
// the CUDA cores while S_{i+1} and PV_i run.  Shared memory: the dense
// kernel's 40 / 80 KB (D 64 / 128) plus the raw ring's 17.5 / 33.5 KB for
// an 8-bit source.

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

// The call's walk from `src`: the position walk for kv_pos (dense 8-bit
// only), the transformed walk under a cap or slopes, the windowed walk
// under a window, else the dense walk.
template <int D, class Src>
cudaError_t launch_src(const fam::DecodeCall& c, const Src& src) {
  const dim3 grid((c.n_q + kTile - 1) / kTile, c.n_heads, c.batch);
  const int n_kv = c.kv.n_kv;
  if (c.kv_pos != nullptr) {
    if constexpr (Src::kRaw && !Src::kPaged) {
      return launch<D>(c.q, c.kv.k, c.kv.v, c.o, c.lse, c.n_heads, c.n_kv_heads, c.n_q, n_kv,
                       c.sm_scale,
                       PosWalk{{c.q_offset, c.kv_pos, c.window, c.sinks, c.softcap, c.sm_scale,
                                c.slopes}},
                       grid, c.stream, src);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (c.softcap > 0.0f || c.slopes != nullptr) {
    return launch<D>(c.q, c.kv.k, c.kv.v, c.o, c.lse, c.n_heads, c.n_kv_heads, c.n_q, n_kv,
                     c.sm_scale,
                     FeatWalk<false, true>{c.q_offset, c.fixed_offset, c.causal, c.window,
                                           c.sinks, nullptr, nullptr, c.softcap, c.sm_scale,
                                           c.slopes},
                     grid, c.stream, src);
  }
  if (c.window != kNoWindow) {
    return launch<D>(c.q, c.kv.k, c.kv.v, c.o, c.lse, c.n_heads, c.n_kv_heads, c.n_q, n_kv,
                     c.sm_scale,
                     FeatWalk<false>{c.q_offset, c.fixed_offset, c.causal, c.window, c.sinks},
                     grid, c.stream, src);
  }
  return launch<D>(c.q, c.kv.k, c.kv.v, c.o, c.lse, c.n_heads, c.n_kv_heads, c.n_q, n_kv,
                   c.sm_scale, DenseWalk{c.q_offset, c.fixed_offset, c.causal}, grid, c.stream,
                   src);
}

template <class Src>
cudaError_t launch_dim(const fam::DecodeCall& c, int head_dim, const Src& src) {
  return head_dim == 64 ? launch_src<64>(c, src) : launch_src<128>(c, src);
}

}  // namespace sm90
}  // namespace

cudaError_t fam::flash_kv_sm90(const DecodeCall& call, int kv_dtype, int head_dim, bool paged) {
  if (call.n_q <= kDecodeRows || call.pos_div != 1 || (head_dim != 64 && head_dim != 128)) {
    return cudaErrorInvalidValue;
  }
  if (kv_dtype == 0) {
    return paged ? sm90::launch_dim(call, head_dim, sm90::PagedBf16{call.kv})
                 : cudaErrorInvalidValue;
  }
  if (kv_dtype < 1 || kv_dtype > 3) return cudaErrorInvalidValue;
  if (paged) {
    return sm90::launch_dim(call, head_dim, sm90::Src8<true>{call.kv, call.kv.k_scale,
                                                             call.kv.v_scale, kv_dtype});
  }
  return sm90::launch_dim(call, head_dim, sm90::Src8<false>{call.kv, call.kv.k_scale,
                                                            call.kv.v_scale, kv_dtype});
}
