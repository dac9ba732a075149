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

#include "kv_sources_sm90.cuh"

namespace {
namespace sm90 {

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
