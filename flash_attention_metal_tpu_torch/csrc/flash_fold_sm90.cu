// The GQA-folded calls of more than kDecodeRows rows on the wgmma forward
// (flash_fwd_sm90.cuh, FoldWalk) with a split-KV grid: every call of
// fam_flash_fwd, fam_flash_quant, fam_flash_paged and fam_flash_paged_quant
// (flash_fwd.cu) with bf16 q, pos_div > 1 and n_q > 16, which the
// first-generation 64-row template of flash_fwd.cu ran before.  Such a call
// is a speculative verify window: (gamma + 1) tokens of a KV head's group
// of q-heads folded into rows, 40 rows at gamma 4 and group 8.  A
// translation unit of its own, so nvcc builds it beside the others.
//
// Replaces, for these calls, flash_attention_metal_tpu/kernels/flash_fwd.py::
// _fwd_kernel (a dense bf16 cache), quant.py::_quant_fwd_kernel (a dense
// int8 / e4m3 / e5m2 cache with per-token scales), paged.py::
// flash_attention_paged (a bf16 page pool) and ::flash_attention_paged_quant
// (an 8-bit page pool).  The contract is flash_fwd.cu's, with row r at
// position r / pos_div + q_offset[b] (the slot's length on the paged
// entries); the window with its sinks and the tanh softcap fold, ALiBi,
// segment ids, dropout and position maps do not (the C entries refuse
// them).  One instance a (KV source, walk, head dim): DenseBf16 (the dense
// entry), PagedBf16, Dense8 and Paged8 (kv_sources_sm90.cuh, whose 8-bit
// sources read their format at run time), each on FoldWalk<false> and,
// under a softcap, FoldWalk<true>.
//
// What bounds it on the H100.  A verify window reads each visible K/V row
// once for 4 * n_q flops per row and KV head: at TinyLlama-1.1B's group 8
// and gamma 4 (40 rows) 2.3 flops a byte of a bf16 cache, far below the
// ~295 of the tensor cores' line, so HBM bytes bound it.  What counts is
// how many SMs the grid keeps reading: one block per (64-row tile, KV
// head, batch) is 4 blocks at batch 1 for TinyLlama's 4 KV heads, each
// walking the whole row in series.
//
// What the design does about it.  The KV row is cut into splits, a chunk of
// kv_chunk columns each (kernels/flash_fwd.py::decode_kv_chunk picks it
// from static shapes and the SM count), so the grid is (Q tile x split, KV
// head, batch) and a batch-1 verify call spreads over the card; the last
// block of a (Q tile, KV head, batch) merges the fp32 partials in split
// order (split_merge.cuh).  A grid that already fills the card takes one
// chunk and writes o directly.  The 40 folded rows fill 40 of wgmma's 64:
// the padded products cost flops that a bytes-bound call has to spare, and
// rows past n_q are neither written nor merged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_sources_sm90.cuh"

namespace {
namespace sm90 {

// The folded walk of a call from `src`: with the softcap FoldWalk<true>,
// else FoldWalk<false>; grid (Q tile x split, KV head, batch).
template <int D, class Src>
cudaError_t launch_fold(const fam::DecodeCall& c, const Src& src) {
  const int n_kv = c.kv.n_kv;
  const int n_splits = (n_kv + c.kv_chunk - 1) / c.kv_chunk;
  if (n_splits > 1 && (c.part == nullptr || c.tickets == nullptr)) return cudaErrorInvalidValue;
  const dim3 grid((c.n_q + kTile - 1) / kTile * n_splits, c.n_heads, c.batch);
  if (c.softcap > 0.0f) {
    return launch<D>(c.q, c.kv.k, c.kv.v, c.o, c.lse, c.n_heads, c.n_kv_heads, c.n_q, n_kv,
                     c.sm_scale,
                     FoldWalk<true>{c.q_offset, c.pos_div, c.window, c.sinks, c.softcap,
                                    c.sm_scale, c.kv_chunk, n_splits, c.part, c.tickets},
                     grid, c.stream, src);
  }
  return launch<D>(c.q, c.kv.k, c.kv.v, c.o, c.lse, c.n_heads, c.n_kv_heads, c.n_q, n_kv,
                   c.sm_scale,
                   FoldWalk<false>{c.q_offset, c.pos_div, c.window, c.sinks, 0.0f, c.sm_scale,
                                   c.kv_chunk, n_splits, c.part, c.tickets},
                   grid, c.stream, src);
}

template <class Src>
cudaError_t launch_fold_dim(const fam::DecodeCall& c, int head_dim, const Src& src) {
  return head_dim == 64 ? launch_fold<64>(c, src) : launch_fold<128>(c, src);
}

}  // namespace sm90
}  // namespace

cudaError_t fam::flash_fold_sm90(const DecodeCall& call, int kv_dtype, int head_dim, bool paged) {
  if (call.n_q <= kDecodeRows || call.pos_div < 2 || !call.causal || call.q_offset == nullptr ||
      call.slopes != nullptr || call.kv_pos != nullptr || call.kv_chunk < sm90::kTile ||
      call.kv_chunk % sm90::kTile != 0 || (head_dim != 64 && head_dim != 128)) {
    return cudaErrorInvalidValue;
  }
  if (kv_dtype == 0) {
    return paged ? sm90::launch_fold_dim(call, head_dim, sm90::PagedBf16{call.kv})
                 : sm90::launch_fold_dim(call, head_dim, sm90::DenseBf16{});
  }
  if (kv_dtype < 1 || kv_dtype > 3) return cudaErrorInvalidValue;
  if (paged) {
    return sm90::launch_fold_dim(call, head_dim, sm90::Src8<true>{
                                                     call.kv, call.kv.k_scale, call.kv.v_scale,
                                                     kv_dtype});
  }
  return sm90::launch_fold_dim(call, head_dim, sm90::Src8<false>{
                                                   call.kv, call.kv.k_scale, call.kv.v_scale,
                                                   kv_dtype});
}
