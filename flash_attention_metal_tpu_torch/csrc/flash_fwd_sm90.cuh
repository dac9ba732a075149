// The bf16 forward redesigned for Hopper (sm_90a), head dim 64 or 128: one
// mainloop for its walks and KV sources.  Included by flash_fwd.cu
// (fam_flash_fwd, bf16 with pos_div == 1: the training forward, serving's
// prefill chunks, the ladder's and bench's general calls), by flash_lean.cu
// (fam_flash_lean, bf16) and by flash_tri.cu (fam_flash_tri_fwd, bf16: the
// bench's causal calls), which launch it on the dense walk; by flash_mask.cu
// (fam_flash_sparse_fwd, bf16), which launches it on the sparse walk; and by
// flash_kv_sm90.cu (the bf16 prefill of fam_flash_quant, fam_flash_paged and
// fam_flash_paged_quant), which launches it from the 8-bit and paged caches'
// KV sources; and by flash_fold_sm90.cu (the bf16 calls of all four cache
// entries folded by GQA, pos_div > 1, of more than 16 rows), which launches
// it on the folded walk from every KV source.
//
// Replaces flash_attention_metal_tpu/kernels/flash_fwd.py::_fwd_kernel (the
// general kernel, a per-batch device offset), ::_fwd_kernel_lean (the
// whole KV row of n_kv <= 1024 in one block, an int offset given at
// launch), flash_tri.py::_tri_kernel (causal, an int offset given at
// launch, any n_kv) and flash_mask.py::_fwd_sparse_kernel (each Q block
// over its KV skip list, the mask elementwise on visited blocks), and at
// prefill quant.py::_quant_fwd_kernel, paged.py::flash_attention_paged and
// ::flash_attention_paged_quant: one function, so one kernel serves all
// seven, each entry with its own launch.  Lean's exact two-pass softmax
// becomes the online one here, which changes only rounding.
//
// Contract, for batch b, q-head h (KV head h / group) and query row r:
//   o[b,h,r] = softmax_c(sm_scale * q[b,h,r] . k[c]) . v
// over the visible columns c.  Dense walk: c < n_kv and, when causal,
// c <= r + off: off is q_offset[b] (a device array) or, with q_offset
// null, fixed_offset (an int, negative allowed).  Sparse walk: the columns
// a block-sparse mask's tables mark (kernels/flash_mask.py::
// compile_tables).  The dense walk also takes a sliding window with
// attention sinks and segment ids (window.cuh): row r at position p = r +
// off sees c <= p with c > p - window or c < sinks, and with segment ids
// only columns of its own id, the score transforms of xf.cuh (the tanh
// softcap, ALiBi) and attention dropout (dropout.cuh: the P of the PV
// product times its keep factor, the statistics and the lse those of the
// undropped P).  Softmax statistics and both products accumulate in
// fp32; P is rounded to bf16 before the PV product.  The optional lse is
// the natural-log logsumexp per row, fp32 [B, H, N_q].  A row with no
// visible column gives o = 0 and lse = -inf.
//
// What bounds it on the H100.  At the training shape (q [4,16,2048,64],
// kv [4,8,2048,64], causal) the kernel does 4 D flops per visible (row,
// column) pair, 34.4 GFLOP against ~50 MB of I/O: the tensor cores' side
// (0.0348 ms at 989 TF/s).  Lean's sweep point N = 1024 (B 8, H 1,
// non-causal) does 2.1 GFLOP on 4 MB, near the balance point (~295 flops
// per byte); N = 128 (B 512) is bound by bytes.  Under ladder rung 11's
// block-sparse mask at the training shape, 23.6 GFLOP over the visible
// pairs: the tensor cores' side too.
//
// What the design does about the first design's faults (every step's S,
// P and PV tile round-tripped through shared memory behind four barriers;
// K/V prefetched through registers and stored on the critical path; WMMA;
// every score compared against its row's limit; lean's 16-row blocks each
// reading all of K and V into a [16, n_kv] fp32 score row):
//   * One warpgroup per 64 Q rows of one (q-head, batch).  S = Q K^T is
//     wgmma.m64n64k16 with Q and K from shared memory (K-major).  S stays
//     in registers; the online softmax (row max and sum over the 4 threads
//     of a row quad, exp2 with the scale folded into one FMA) runs there;
//     P is rounded to bf16 in registers and is the register A operand of
//     O += P V (V read through the MN-major descriptor).  O lives in fp32
//     registers for the whole walk, and the row sums are reduced across the
//     quad once, at the end.  Nothing of S, P or PV touches shared memory.
//   * The walk is software-pipelined: S_{i+1} is issued just before
//     O += P_i V_i, and its softmax runs while PV_i is on the tensor cores.
//   * K and V come through 2-stage cp.async rings of their own, in the
//     swizzled layout, one barrier per step: K_{i+2} and V_{i+1} are in
//     flight while step i computes.
//   * Only steps whose tile holds a hidden element test their columns;
//     full steps skip it.
//   * Lean's blocks are 64 rows too, so K and V are read once per 64 query
//     rows (16 times at N = 1024, not 64), and shared memory no longer
//     grows with n_kv.
//
// The walks.  A kernel takes a walk policy: which (Q tile, q-head, batch) a
// block owns, its steps, each step's KV tile, whether a step is full and the
// element test.  The test selects on the scores after the product, so no
// wgmma sits under a branch that differs between steps or blocks.
//   * DenseWalk (rows 1-3): one block per (Q tile, q-head, batch), the last
//     Q tile first (the longest walks); KV tiles 0 .. the tile's last
//     visible column, in order; only tiles that cross the diagonal or the
//     n_kv edge compare columns.  Under a window the walk is the sink tiles
//     then the window's tiles (window.cuh, kv_runs), so an out-of-window
//     tile is neither fetched nor computed; tiles that cross the window's
//     edge compare columns too (FeatWalk, a walk of its own, so that an
//     unwindowed call runs DenseWalk's code with no window state).  Under
//     the score transforms (FeatWalk<kSeg, true>, with or without a
//     window) the softmax of a step first caps its scores and measures the
//     bias into its exponents (online_softmax).  Under dropout
//     (FeatWalk<kSeg, true, true>, whatever the transforms) a thread hashes
//     its two rows once per block and each score once.  With
//     segment ids (FeatWalk<true>, row 1 only) every step compares: the KV
//     tile's 64 ids come through the K ring's bit stage beside K, and each
//     thread reads its two rows' ids once.
//   * SparseFwdWalk (row 14): one block per (q-head x batch, Q tile), the Q
//     tiles issued by a host-made order, longest list first, across heads
//     (the heads are grid x, the fastest dimension); the steps are the Q
//     tile's list of visited (KV tile, bits) pairs.  A partial pair's
//     64 x 2-word bit tile comes through the K ring beside K (the softmax
//     of a step reads it right after its scores) and a thread reads the two
//     words of each of its two Q rows once per step; a full pair fetches
//     and tests nothing.  An empty list walks no step: o = 0, lse = -inf.
//     Step entries are read from the list a step ahead of their fetches.
//   * FoldWalk (rows 1 and 11-13 over a GQA fold, pos_div > 1: a KV
//     head's group of q-heads folded into rows, more than 16 of them, as a
//     speculative verify window of (gamma + 1) * group rows is): row r
//     of the 64-row tile sits at position r / pos_div + q_offset[b], and
//     each element compares its column with its own row's position (a
//     thread's two rows' positions taken once a block; pos_div need not
//     divide 64, so one position's rows may straddle a tile edge).  A tile
//     is full only when its last column is at most the tile's first row's
//     position (and inside every row's window).  The window and the sinks
//     walk as FeatWalk's (kv_runs over the tile's first and last rows'
//     positions), and FoldWalk<true> takes the tanh softcap; ALiBi, segment
//     ids, dropout and position maps never fold (the C entries refuse
//     them).  Split-KV: the grid is (Q tile x split, KV head, batch), split
//     s walking only its chunk [s * kv_chunk, (s + 1) * kv_chunk) of the
//     tiles, so a verify call of a few (tile, head, batch) units still
//     fills the card; a split whose chunk holds no tile of its walk reads
//     nothing and leaves an empty partial (m = -inf, l = 0, o = 0).  With
//     more than one split each block writes its fp32 partial, and the last
//     of a (Q tile, q-head, batch) merges them in split order
//     (split_merge.cuh, shared with the decode grid).  Every KV source
//     takes it (flash_fold_sm90.cu launches it).
//   * PosWalk (row 1 over a rolling cache, flash_fwd.py::_fwd_kernel's
//     kv_positions): the KV slots carry the positions they hold (kv_pos
//     [B, N_kv], -1 for none), and the mask, the window and ALiBi's
//     distance act on those: slot j is visible to row r when 0 <= pos <=
//     r + off and, under the window, pos > r + off - window or pos < sinks.
//     Slot order is not position order after a wrap, so the walk visits
//     every KV tile and compares every element (JAX turns its block skip
//     off too, flash_fwd.py:319); the tile's 64 positions ride the K ring's
//     bit stage beside K.  It reads the window, sinks, cap and slopes at run
//     time (one instance a head dim).  With segment ids (PosSegWalk, an
//     instance of its own, so PosWalk keeps no id state) the tile's 64 ids
//     ride the bit stage after its positions, and a slot is seen only by
//     rows of its id; a segmented call takes this walk at any n_q (a
//     decode-sized one included: the decode grid takes no segment ids).
// The KV sources.  A kernel takes a source policy beside its walk: where a
// step's KV tile lives and in what type.
//   * DenseBf16 (every walk above): a bf16 cache [B, H_kv, N, D]; a tile's
//     rows from the batch's KV head base.
//   * PagedBf16 (kv_sources_sm90.cuh; DenseWalk, FeatWalk, FoldWalk): a bf16 page
//     pool [P, H_kv, page, D] through an int32 table [B, max_pages], a
//     tile's rows from kv_tiles.cuh::tile_row0 (the logical page clamped to
//     max_pages - 1, the physical to [0, P - 1]); a page holds whole tiles,
//     so the copies are the dense ones.  The table is read a step before a
//     tile's copies (and the first three steps' at once), so its load hides
//     behind a step.
//   * Dense8 and Paged8 (Src8<kPaged>, kv_sources_sm90.cuh; Dense8 also on
//     PosWalk): int8, e4m3 or e5m2 tiles with per-token fp32 scales
//     ([.., H_kv, N] or [P, H_kv, page]).  Their raw tiles and scales come
//     by cp.async into a raw ring (RawRing: 2 stages each of K and V, 16 /
//     32 KB at D 64 / 128), a step ahead of the bf16 schedule; the
//     warpgroup widens each raw tile exactly into the swizzled bf16 stage
//     that desc_k / desc_mn read (8 raw bytes a 16-byte chunk at c ^ (r &
//     7)), the format picked at run time inside the widen pass, outside
//     every product.  The ring hazard: a widened stage is written only after
//     the product that read it has finished (K_{i+2} into S_i's stage while
//     S_{i+1} runs, V_{i+1} into PV_{i-1}'s while PV_i runs), and the raw
//     stage being refilled is never the one being widened; the barrier at
//     each step's top publishes both.  The K scale multiplies the fp32
//     score columns in online_softmax, before the transforms (the widened
//     K stage's scales are copied beside it by the widen pass, since its
//     raw stage is refilled a step before its softmax); the V scale
//     multiplies P before it is rounded to bf16, read in place from the raw
//     V stage, which outlives its step's P; the row sums take P unscaled.
//     A bf16 source compiles both scale steps away.
// Block shape: one warpgroup, not two.  At lean's N = 1024, B 8, H 1 there
// are only 128 tiles of 64 rows: 128-row blocks would leave half of the
// 132 SMs idle.  At the training shape (2048 tiles) two consumer
// warpgroups sharing each K/V tile halve the tile reads, but measured on
// an H100 (PERF.md, Findings) 256-thread blocks were slower than this
// kernel at every shape: the exposed chain of each step, not L2 traffic,
// held the first design, and the pipelining addresses the chain.
// Shared memory: 40 KB at D = 64, 80 KB at D = 128; the sparse walk's two
// bit stages add 1 KB, an 8-bit source's raw ring 17.5 / 33.5 KB.
// Not done yet: TMA with mbarriers and warp specialisation (a producer
// warp, two consumer warpgroups in ping-pong); for an 8-bit source, a
// producer warpgroup that widens while the consumer's softmax runs (the
// widen pass is the gap to the bf16 source, PERF.md Findings).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_tiles.cuh"
#include "split_merge.cuh"
#include "window.cuh"

namespace {
namespace sm90 {

template <int D, bool kBits>
struct FwdSmem {
  bf16 q[kTile * D];
  bf16 k[kStages][kTile * D];
  bf16 v[kStages][kTile * D];
  alignas(16) uint32_t bits[kStages][kBits ? kTile * 2 : 4];  // a partial pair's bit tile
};

// An 8-bit source's raw ring, after FwdSmem: the K and V tiles as stored
// (row-major, D bytes a row) and their per-token scales as they land, and
// the scales of the widened K stages (copied by the widen pass, since a raw
// K stage is refilled while its widened tile is still ahead of its softmax).
// The V scales are read in place: a raw V stage outlives its step's P.
template <int D>
struct RawRing {
  alignas(16) uint8_t k[kStages][kTile * D];
  alignas(16) uint8_t v[kStages][kTile * D];
  alignas(16) float ks[kStages][kTile];
  alignas(16) float vs[kStages][kTile];
  alignas(16) float sk[kStages][kTile];
};

// `rows_valid` rows of D bytes (row pitch D) into a raw stage, 16 bytes a
// copy; the other rows are zero.
template <int D>
__device__ __forceinline__ void load_raw(uint8_t* dst, const uint8_t* src, int rows_valid) {
  constexpr int kChunks = D / 16;
#pragma unroll
  for (int j = 0; j < kTile * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const bool valid = i / kChunks < rows_valid;
    cp_async16(dst + i * 16, src + (valid ? (size_t)i * 16 : 0), valid);
  }
}

// A raw stage widened into a bf16 stage in the swizzled layout that
// desc_k / desc_mn read: the 8 bytes of chunk c of row r become the 16-byte
// chunk at swz(r, c).  src.widen (the source's exact widening) picks the
// 8-bit format at run time, outside every product.
template <int D, class Src>
__device__ __forceinline__ void widen_tile(bf16* dst, const uint8_t* raw, const Src& src) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int j = 0; j < kTile * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const uint2 x = *reinterpret_cast<const uint2*>(raw + i * 8);
    *reinterpret_cast<uint4*>(dst + swz<kTile>(i / kChunks, i % kChunks)) = src.widen(x);
  }
}

// The KV sources (a kernel's second policy, beside its walk): where a KV
// tile lives and in what type.  row(kv_rows, b, h_kv, n_kv_heads,
// kv_start): the row (in rows of D elements) of the tile that starts at
// logical column kv_start, kv_rows being the dense cache's first row of
// (b, h_kv).  kRaw: 8-bit tiles through the raw ring, widened to bf16 (the
// source then has k_scale, v_scale and widen, see flash_kv_sm90.cu).
// kPaged: row reads a page table, so the kernel asks for it a step early.
// DenseBf16 is every walk's source here; PagedBf16, Dense8 and Paged8
// live in kv_sources_sm90.cuh (flash_kv_sm90.cu and flash_fold_sm90.cu
// launch them).
struct DenseBf16 {
  static constexpr bool kRaw = false;
  static constexpr bool kPaged = false;
  __device__ size_t row(size_t kv_rows, int, int, int, int kv_start) const {
    return kv_rows + kv_start;
  }
};

// The K and V scales of one step of an 8-bit source, from this thread's
// first column (2 t) on: sk multiplies the scores' columns, sv the P that
// the PV product takes.  NoScales (a bf16 source) compiles both away.
struct NoScales {
  static constexpr bool kOn = false;
};
struct StepScales {
  static constexpr bool kOn = true;
  const float* sk;
  const float* sv;
};

// 2^x on the special-function unit (ex2.approx.ftz): exp2f without its
// fix-up of subnormal results, which P, rounded to bf16, does not need.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The dense walk (rows 1-3).  q_offset: int32 [B], row r sees columns
// c <= r + q_offset[b]; null: c <= r + fixed_offset; not causal: every
// column below n_kv.
struct DenseWalk {
  static constexpr bool kBits = false;
  const int* q_offset;
  int fixed_offset, causal;

  // One step's element test.  Element e of n8 tile j: Q row r0 (+ 8 for
  // e >= 2), KV column c0 + 8 j + (e & 1).
  struct Mask {
    static constexpr bool kXf = false;
    static constexpr bool kDrop = false;
    bool full;
    int c0, r0, off, n_kv;
    __device__ bool seen(int j, int e) const {
      const int c = c0 + j * 8 + (e & 1);
      return c < n_kv && c <= r0 + (e >> 1) * 8 + off;
    }
  };

  // A block per (Q tile, q-head, batch), the last Q tile first, over the
  // KV tiles up to its last row's last visible column.
  struct Blk {
    int b, h, q_start, n_steps, off, n_kv;
    __device__ Blk(const DenseWalk& w, int, int n_q, int n_kv_) {
      n_kv = n_kv_;
      b = blockIdx.z;
      h = blockIdx.y;
      q_start = (gridDim.x - 1 - blockIdx.x) * kTile;
      const int rows_valid = min(kTile, n_q - q_start);
      off = !w.causal ? n_kv : w.q_offset != nullptr ? w.q_offset[b] : w.fixed_offset;
      // The KV walk stops at the last tile the tile's last row sees.
      const int limit = min(q_start + rows_valid - 1 + off, n_kv - 1);
      n_steps = limit < 0 ? 0 : limit / kTile + 1;
    }
    // Step j: (KV tile, bits); the dense walk has no bit tiles.
    __device__ int2 entry(int j) const { return make_int2(j, -1); }
    __device__ void fetch_bits(uint32_t*, int2) const {}
    // row: this thread's first Q row within the tile.  Tiles that cross the
    // diagonal or the n_kv edge compare columns, interior tiles skip it.
    __device__ Mask mask(int2 entry, const uint32_t*, int row, int t) const {
      const int kv_start = entry.x * kTile;
      const bool full = kv_start + kTile - 1 <= q_start + off && kv_start + kTile <= n_kv;
      return {full, kv_start + 2 * t, q_start + row, off, n_kv};
    }
  };
};

// The dense walk under a window and, with kSeg, segment ids (row 1): row r
// at position p = r + q_offset[b] sees c <= p inside its window (window,
// sinks; kNoWindow: none), and with kSeg only columns whose segment id
// (kv_seg [B, N_kv]) is the row's (q_seg [B, N_q]).  kXf: the score
// transforms (xf.cuh: softcap, slopes; the bias measured from r +
// q_offset[b] also when not causal), with or without a window.  kDrop
// (with kXf, whose cap may be 0 and slopes null): attention dropout
// (dropout.cuh), each P of O += P V times its keep factor, the row
// statistics of the undropped P.  A call without any runs DenseWalk, which
// holds no such state.
template <bool kSeg, bool kXf_ = false, bool kDrop_ = false>
struct FeatWalk {
  static_assert(kXf_ || !kDrop_, "dropout rides the transformed walk");
  static constexpr bool kBits = kSeg;  // the bit stage holds the KV tile's ids
  const int* q_offset;
  int fixed_offset, causal;
  int window = kNoWindow, sinks = 0;
  const int* q_seg = nullptr;
  const int* kv_seg = nullptr;
  float softcap = 0.0f, sm_scale = 0.0f;
  const float* slopes = nullptr;
  Drop drop = {};

  // One step's element test.  Element e of n8 tile j: Q row r0 (+ 8 for
  // e >= 2), KV column c0 + 8 j + (e & 1); ids: the step's KV ids from
  // this thread's first column on, qid: its two rows' ids.  With kXf, xf
  // and the distances of the score transforms (xoff: the offset the bias
  // measures rows from; online_softmax).  With kDrop, drop and this
  // thread's two rows' hash inputs at column c0 (dropout.cuh).
  struct Mask {
    static constexpr bool kXf = kXf_;
    static constexpr bool kDrop = kDrop_;
    bool full;
    int c0, r0, off, n_kv, window, sinks;
    const uint32_t* ids;
    int qid[2];
    XfHead xf;
    float base;  // this thread's first distance c0 - (r0 + xoff), as a float
    DropBlock drop;
    uint32_t dat[2];
    __device__ bool seen(int j, int e) const {
      const int c = c0 + j * 8 + (e & 1);
      const int p = r0 + (e >> 1) * 8 + off;
      bool ok = c < n_kv && c <= p && in_window(c, p, window, sinks);
      if constexpr (kSeg) ok = ok && (int)ids[j * 8 + (e & 1)] == qid[e >> 1];
      return ok;
    }
    // Element (j, e)'s distance c - p: the step's base plus a constant of
    // the unrolled loop (the int-to-float conversion, a MUFU-rate op, taken
    // once a step in mask()).
    __device__ float dist(int j, int e) const {
      return base + (float)(j * 8 + (e & 1) - (e >> 1) * 8);
    }
    // Element (j, e)'s keep factor: its column's term a constant away.
    __device__ float keep(int j, int e) const {
      return drop.keep(dat[e >> 1] + (uint32_t)(j * 8 + (e & 1)) * kMixA);
    }
  };

  // A block per (Q tile, q-head, batch), the last Q tile first, over the
  // sink tiles and then the window's tiles up to its last row's last
  // visible column.
  struct Blk {
    int b, h, q_start, n_steps, off, n_kv, window, sinks;
    TileRuns runs;
    const int* kv_ids;
    int qid[2];
    XfHead xf;
    int xoff;
    DropBlock drop;
    uint32_t drow[2];  // this thread's two rows' row hashes (kDrop)
    __device__ Blk(const FeatWalk& w, int, int n_q, int n_kv_) {
      n_kv = n_kv_;
      b = blockIdx.z;
      h = blockIdx.y;
      q_start = (gridDim.x - 1 - blockIdx.x) * kTile;
      const int rows_valid = min(kTile, n_q - q_start);
      off = !w.causal ? n_kv : w.q_offset != nullptr ? w.q_offset[b] : w.fixed_offset;
      xoff = 0;
      if constexpr (kXf_) {
        xf = XfHead(w.softcap, w.slopes, h, w.sm_scale);
        xoff = w.q_offset != nullptr ? w.q_offset[b] : w.fixed_offset;
      }
      window = w.window;
      sinks = w.sinks;
      runs = kv_runs<kTile>(q_start + off, q_start + rows_valid - 1 + off, n_kv, window, sinks);
      n_steps = runs.steps();
      kv_ids = nullptr;
      qid[0] = qid[1] = 0;
      if constexpr (kSeg) {
        kv_ids = w.kv_seg + (size_t)b * n_kv;
        // This thread's two Q rows (accumulator rows g and g + 8 of its warp).
        const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          qid[half] = w.q_seg[(size_t)b * n_q + min(q_start + row + half * 8, n_q - 1)];
        }
      }
      drow[0] = drow[1] = 0;
      if constexpr (kDrop_) {
        // The rows are the block's for the whole walk: their hashes once.
        drop = DropBlock(w.drop, b);
        const uint32_t head = drop.head_hash(h);
        const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          drow[half] = drop.row_hash(head, q_start + row + half * 8);
        }
      }
    }
    // Step j: (KV tile, bits); no bit tiles here either.
    __device__ int2 entry(int j) const { return make_int2(runs.tile(j), -1); }
    // With segment ids the KV tile's ids ride the K ring's bit stage.
    __device__ void fetch_bits(uint32_t* dst, int2 entry) const {
      if constexpr (kSeg) load_ids<kTile>(dst, kv_ids + entry.x * kTile, n_kv - entry.x * kTile);
    }
    // row: this thread's first Q row within the tile.  Tiles that cross the
    // diagonal, the window's edge or the n_kv edge compare columns, interior
    // tiles skip it (never with segment ids).
    __device__ Mask mask(int2 entry, const uint32_t* bits, int row, int t) const {
      const int kv_start = entry.x * kTile;
      const bool full = !kSeg && kv_start + kTile - 1 <= q_start + off &&
                        kv_start + kTile <= n_kv &&
                        tile_in_window(kv_start, kTile, q_start + kTile - 1 + off, window, sinks);
      const float base = kXf_ ? (float)(kv_start + 2 * t - (q_start + row) - xoff) : 0.0f;
      Mask m{full, kv_start + 2 * t, q_start + row, off, n_kv, window, sinks, bits + 2 * t,
             {qid[0], qid[1]}, xf, base};
      if constexpr (kDrop_) {
        m.drop = drop;
        const uint32_t col = drop.col_term(kv_start + 2 * t);
        m.dat[0] = drow[0] + col;
        m.dat[1] = drow[1] + col;
      }
      return m;
    }
  };
};

// The folded walk (see the header): q_offset int32 [B], row r at position
// r / pos_div + q_offset[b] (causal); the window (kNoWindow: none) and
// sinks; with kXf the tanh softcap (the cap, 0 for none, read at run time;
// no slopes: ALiBi never folds).  kv_chunk columns a split (a multiple of
// 64), n_splits of them over n_kv; part and tickets (split_merge.cuh: the
// partials, one zeroed int32 per (Q tile, q-head, batch)), read only with
// more than one split.
template <bool kXf_>
struct FoldWalk {
  static constexpr bool kBits = false;
  static constexpr bool kSplit = true;
  const int* q_offset;
  int pos_div;
  int window = kNoWindow, sinks = 0;
  float softcap = 0.0f, sm_scale = 0.0f;
  int kv_chunk = 0, n_splits = 1;
  float* part = nullptr;
  int* tickets = nullptr;

  // One step's element test.  Element e of n8 tile j: this thread's row
  // e >> 1 (at position p[e >> 1]), KV column c0 + 8 j + (e & 1).
  struct Mask {
    static constexpr bool kXf = kXf_;
    static constexpr bool kDrop = false;
    bool full;
    int c0, n_kv, window, sinks;
    int p[2];
    XfHead xf;
    __device__ bool seen(int j, int e) const {
      const int c = c0 + j * 8 + (e & 1);
      const int pr = p[e >> 1];
      return c < n_kv && c <= pr && in_window(c, pr, window, sinks);
    }
    // The bias's distance: no ALiBi under a fold, so its slope is 0.
    __device__ float dist(int, int) const { return 0.0f; }
  };

  // A block per (Q tile x split, q-head, batch), the last Q tile first,
  // over the sink and window tiles of its split's chunk up to its last
  // row's diagonal.
  struct Blk {
    int b, h, q_start, n_steps, n_kv, window, sinks, split, n_splits, tile, p_lo, p_hi;
    TileRuns runs;
    int p[2];  // this thread's two rows' positions
    XfHead xf;
    __device__ Blk(const FoldWalk& w, int, int n_q, int n_kv_) {
      n_kv = n_kv_;
      b = blockIdx.z;
      h = blockIdx.y;
      n_splits = w.n_splits;
      split = blockIdx.x % n_splits;
      tile = gridDim.x / n_splits - 1 - blockIdx.x / n_splits;
      q_start = tile * kTile;
      const int rows_valid = min(kTile, n_q - q_start);
      const int off = w.q_offset[b];
      p_lo = q_start / w.pos_div + off;
      p_hi = (q_start + rows_valid - 1) / w.pos_div + off;
      window = w.window;
      sinks = w.sinks;
      const int t0 = split * (w.kv_chunk / kTile);
      runs = kv_runs<kTile>(p_lo, p_hi, n_kv, window, sinks).within(t0, t0 + w.kv_chunk / kTile);
      n_steps = runs.steps();
      const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
      for (int half = 0; half < 2; ++half) p[half] = (q_start + row + half * 8) / w.pos_div + off;
      if constexpr (kXf_) xf = XfHead(w.softcap, nullptr, h, w.sm_scale);
    }
    __device__ int2 entry(int j) const { return make_int2(runs.tile(j), -1); }
    __device__ void fetch_bits(uint32_t*, int2) const {}
    // Tiles that cross the first row's position, the window's edge or the
    // n_kv edge compare columns; interior tiles skip it.
    __device__ Mask mask(int2 entry, const uint32_t*, int, int t) const {
      const int kv_start = entry.x * kTile;
      const bool full = kv_start + kTile - 1 <= p_lo && kv_start + kTile <= n_kv &&
                        tile_in_window(kv_start, kTile, p_hi, window, sinks);
      return Mask{full, kv_start + 2 * t, n_kv, window, sinks, {p[0], p[1]}, xf};
    }
  };
};

// Whether a walk splits the KV row across blocks (FoldWalk).
template <class W, class = void>
struct SplitWalk : std::false_type {};
template <class W>
struct SplitWalk<W, std::void_t<decltype(W::kSplit)>> : std::bool_constant<W::kSplit> {};

// The dense walk over a rolling cache (see the header): q_offset int32
// [B] (causal), kv_pos int32 [B, N_kv]; the window (kNoWindow: none), the
// sinks and the transforms (xf.cuh: cap 0 for none, slopes null for none)
// read at run time.  Positions below 2^23 convert to float exactly by one
// integer and one float add (pos_float), not an int-to-float conversion per
// score, which runs at the special-function unit's rate (PERF.md §6).
// kSeg (PosSegWalk): segment ids too, as FeatWalk<true> takes them (q_seg
// [B, N_q], kv_seg [B, N_kv]; only a slot whose id is the row's is seen):
// the tile's 64 ids ride the second half of the bit stage, after its
// positions.  PosWalk holds no id state.
template <bool kSeg>
struct PosWalkT {
  static constexpr bool kBits = true;  // the bit stage holds the KV tile's positions
  const int* q_offset;
  const int* kv_pos;
  int window = kNoWindow, sinks = 0;
  float softcap = 0.0f, sm_scale = 0.0f;
  const float* slopes = nullptr;

  // 0 <= x < 2^23 as a float: the bits of 2^23 + x, less 2^23.
  static __device__ __forceinline__ float pos_float(int x) {
    return __int_as_float(0x4B000000 + x) - 8388608.0f;
  }

  // One step's element test.  Element e of n8 tile j: Q row r0 (+ 8 for
  // e >= 2), slot c0 + 8 j + (e & 1) holding position pos[8 j + (e & 1)];
  // rowf: this thread's two rows' positions as floats.  With kSeg, ids:
  // the step's KV ids from this thread's first column on, qid: its two
  // rows' ids.
  struct Mask {
    static constexpr bool kXf = true;
    static constexpr bool kDrop = false;
    bool full;
    int c0, r0, off, n_kv, window, sinks;
    const uint32_t* pos;
    XfHead xf;
    float rowf[2];
    const uint32_t* ids;
    int qid[2];
    __device__ bool seen(int j, int e) const {
      const int c = c0 + j * 8 + (e & 1);
      const int p = r0 + (e >> 1) * 8 + off;
      const int cp = (int)pos[j * 8 + (e & 1)];
      if constexpr (kSeg) {
        if ((int)ids[j * 8 + (e & 1)] != qid[e >> 1]) return false;
      }
      return c < n_kv && cp >= 0 && cp <= p && in_window(cp, p, window, sinks);
    }
    // Element (j, e)'s distance pos - p (read only where seen, pos >= 0).
    __device__ float dist(int j, int e) const {
      return pos_float((int)pos[j * 8 + (e & 1)]) - rowf[e >> 1];
    }
  };

  // A block per (Q tile, q-head, batch), the last Q tile first, over every
  // KV tile.
  struct Blk {
    int b, h, q_start, n_steps, off, n_kv, window, sinks;
    const int* kv_pos;
    XfHead xf;
    float rowf[2];
    const int* kv_ids;
    int qid[2];
    template <class Walk>
    __device__ Blk(const Walk& w, int, int n_q, int n_kv_) {
      n_kv = n_kv_;
      b = blockIdx.z;
      h = blockIdx.y;
      q_start = (gridDim.x - 1 - blockIdx.x) * kTile;
      off = w.q_offset[b];
      window = w.window;
      sinks = w.sinks;
      xf = XfHead(w.softcap, w.slopes, h, w.sm_scale);
      n_steps = (n_kv + kTile - 1) / kTile;
      kv_pos = w.kv_pos + (size_t)b * n_kv;
      // This thread's two Q rows' positions, once a block.
      const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
      rowf[0] = (float)(q_start + row + off);
      rowf[1] = rowf[0] + 8.0f;
      kv_ids = nullptr;
      qid[0] = qid[1] = 0;
      if constexpr (kSeg) {
        kv_ids = w.kv_seg + (size_t)b * n_kv;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          qid[half] = w.q_seg[(size_t)b * n_q + min(q_start + row + half * 8, n_q - 1)];
        }
      }
    }
    __device__ int2 entry(int j) const { return make_int2(j, -1); }
    // The KV tile's positions ride the K ring's bit stage (0 past n_kv,
    // where the column test hides them), with kSeg its ids after them.
    __device__ void fetch_bits(uint32_t* dst, int2 entry) const {
      load_ids<kTile>(dst, kv_pos + entry.x * kTile, n_kv - entry.x * kTile);
      if constexpr (kSeg) {
        load_ids<kTile>(dst + kTile, kv_ids + entry.x * kTile, n_kv - entry.x * kTile);
      }
    }
    __device__ Mask mask(int2 entry, const uint32_t* bits, int row, int t) const {
      return Mask{false, entry.x * kTile + 2 * t, q_start + row, off, n_kv, window, sinks,
                  bits + 2 * t, xf, {rowf[0], rowf[1]}, bits + kTile + 2 * t,
                  {qid[0], qid[1]}};
    }
  };
};

// The position walk (one instance a head dim), and with segment ids.
struct PosWalk : PosWalkT<false> {};
struct PosSegWalk : PosWalkT<true> {
  const int* q_seg;
  const int* kv_seg;
};

// The block-sparse walk (row 14) over a MaskTables (kernels/flash_mask.py::
// compile_tables): q_ptr [n_q tiles + 1] and q_list [nnz] of (KV tile,
// bits), bits -1 for a full pair or the index of a 64 x 2-word bit tile of
// bit_tiles; order [n_q tiles]: the Q tiles in issue order, longest list
// first.  Elements past n_q or n_kv are 0 in the bit tiles, so an edge pair
// is never full and needs no compare.
struct SparseFwdWalk {
  static constexpr bool kBits = true;
  const int* q_ptr;
  const int2* q_list;
  const uint32_t* bit_tiles;
  const int* order;

  // One step's element test: bit 8 j + 2 t + (e & 1) of this thread's two
  // bit rows (e >= 2: the second).  w holds both words of each row shifted
  // down by 2 t, this thread's first column of every n8 tile, so each test
  // shifts by a constant.
  struct Mask {
    static constexpr bool kXf = false;
    static constexpr bool kDrop = false;
    bool full;
    uint32_t w[2][2];
    __device__ bool seen(int j, int e) const {
      return (w[e >> 1][j >> 2] >> (8 * (j & 3) + (e & 1))) & 1u;
    }
  };

  // A block per (q-head x batch, order[blockIdx.y]): the Q tile's KV list.
  struct Blk {
    const int2* list;
    const uint32_t* bit_tiles;
    int b, h, q_start, n_steps, first;
    __device__ Blk(const SparseFwdWalk& w, int n_heads, int, int) {
      list = w.q_list;
      bit_tiles = w.bit_tiles;
      b = blockIdx.x / n_heads;
      h = blockIdx.x % n_heads;
      const int tile = w.order[blockIdx.y];
      q_start = tile * kTile;
      first = w.q_ptr[tile];
      n_steps = w.q_ptr[tile + 1] - first;
    }
    __device__ int2 entry(int j) const {
      return j < n_steps ? list[first + j] : make_int2(0, -1);
    }
    __device__ void fetch_bits(uint32_t* dst, int2 entry) const {
      if (entry.y >= 0) load_bits<kTile>(dst, bit_tiles, entry.y, 0);
    }
    // bits: the step's stage; row: this thread's first Q row within the
    // tile (its second is row + 8).
    __device__ Mask mask(int2 entry, const uint32_t* bits, int row, int t) const {
      Mask m{};
      m.full = entry.y < 0;
      if (!m.full) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint2 x = *reinterpret_cast<const uint2*>(bits + (row + half * 8) * 2);
          m.w[half][0] = x.x >> (2 * t);
          m.w[half][1] = x.y >> (2 * t);
        }
      }
      return m;
    }
  };
};

// Step i's raw scores st (64 Q rows by the 64 KV columns of the step's
// tile) to P in place, online: the row max over the quad into m_i (log2
// units, the scale is positive), each row's rescale factor of the earlier
// steps into alpha, this thread's share of the row sums of P into sum.
// Element e of n8 tile j: Q row r_lo (+ 8 for e >= 2), the tile's column
// 8 j + 2 t + (e & 1).  A full step skips the test; a hidden element
// scores -inf.  Rows that have seen nothing yet keep a reference of 0, so
// exp2 never takes (-inf) - (-inf).  Under the score transforms
// (Mask::kXf, xf.cuh) st first becomes the capped scores t, already in
// log2 units; the row max takes t + bias, and P = exp2(t + fma(slope2,
// dist, -max)), the bias and the max in one FMA (xf.cuh, "Precision").
// Under dropout (Mask::kDrop) the row sums take P as it is and st keeps P
// times its keep factor, the P of O += P V (dropout.cuh).
template <class Mask, class Scales = NoScales>
__device__ __forceinline__ void online_softmax(float (&st)[kTile / 2], float (&m_i)[2],
                                               float (&alpha)[2], float (&sum)[2],
                                               const Mask& mask, float scale_log2,
                                               const Scales& sc = Scales{}) {
  if constexpr (Scales::kOn) {
    // The K scale multiplies the fp32 score column, before the transforms.
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const float2 s_k = *reinterpret_cast<const float2*>(sc.sk + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) st[4 * j + e] *= (e & 1) ? s_k.y : s_k.x;
    }
  }
  if constexpr (Mask::kXf) {
    xf_cap<false>(mask.xf, st);
    scale_log2 = 1.0f;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!mask.full && !mask.seen(j, e)) st[4 * j + e] = -INFINITY;
      if constexpr (Mask::kXf) {
        mx[e >> 1] = fmaxf(mx[e >> 1], st[4 * j + e] + mask.xf.bias(mask.dist(j, e)));
      } else {
        mx[e >> 1] = fmaxf(mx[e >> 1], st[4 * j + e]);
      }
    }
  }
  float m_ref[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    const float m_new = fmaxf(m_i[half], mx[half] * scale_log2);
    m_ref[half] = m_new == -INFINITY ? 0.0f : m_new;
    alpha[half] = exp2f(m_i[half] - m_ref[half]);  // 0 until the row sees a column
    m_i[half] = m_new;
    sum[half] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p;
      if constexpr (Mask::kXf) {
        p = exp2_ftz(mask.xf.shifted(st[4 * j + e], mask.dist(j, e), m_ref[e >> 1]));
      } else {
        p = exp2_ftz(fmaf(st[4 * j + e], scale_log2, -m_ref[e >> 1]));
      }
      sum[e >> 1] += p;
      if constexpr (Mask::kDrop) p *= mask.keep(j, e);
      // The V scale folds into P before P is rounded (the sums take P).
      if constexpr (Scales::kOn) p *= sc.sv[8 * j + (e & 1)];
      st[4 * j + e] = p;
    }
  }
}

// One block per 64-row Q tile of a (q-head, batch), over the KV tiles of
// its walk.  Warp w owns Q rows 16w..16w+15 of every product.
//
// The walk is software-pipelined: while step i's O += P_i V_i runs on the
// tensor cores, S_{i+1} = Q K_{i+1} (issued just before it) is already
// done and its softmax runs.  K and V have rings of their own: K_{i+2} (and
// its bit tile) is fetched once S_i has finished everywhere, V_{i+1} once
// PV_{i-1} has.  No product sits under a branch (ptxas serialises wgmma on
// a divergent path): the last step's S_{i+1} reads a stale stage and is
// dropped, and so is the first S of a walk with no step.
//
// An 8-bit source (Src::kRaw) copies each tile a step earlier into the raw
// ring: step i's top fetches raw K_{i+3} and raw V_{i+2} (and the bit tile
// of step i + 2, on the bf16 schedule); while S_{i+1} runs the warpgroup
// widens raw K_{i+2} into the bf16 K stage S_i has left, and after S_{i+1}'s
// softmax, while PV_i runs, raw V_{i+1} into the V stage PV_{i-1} has left;
// the barrier at step i + 1's top publishes them.  So no stage an in-flight
// product reads is written, and the pipelining of S_{i+1} under PV_i is
// kept (both widens before the S wait, or both after the softmax, measured
// 0-4% slower on the H100, PERF.md Findings).
template <int D, class Walk, class Src = DenseBf16>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int n_heads, int n_kv_heads, int n_q,
                          int n_kv, float scale_log2, const Walk walk, const Src src) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  FwdSmem<D, Walk::kBits>& sm = *reinterpret_cast<FwdSmem<D, Walk::kBits>*>(base);
  RawRing<D>& raw = *reinterpret_cast<RawRing<D>*>(base + sizeof(FwdSmem<D, Walk::kBits>));
  const typename Walk::Blk blk(walk, n_heads, n_q, n_kv);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int q_start = blk.q_start;
  const int h_kv = blk.h / (n_heads / n_kv_heads);
  const size_t q_rows = ((size_t)blk.b * n_heads + blk.h) * n_q;
  const size_t kv_rows = ((size_t)blk.b * n_kv_heads + h_kv) * n_kv;
  const int rows_valid = min(kTile, n_q - q_start);
  const int n_steps = blk.n_steps;
  // The first row of the tile of a step's entry (KV tile, bits).
  auto row_of = [&](int2 entry) {
    return src.row(kv_rows, blk.b, h_kv, n_kv_heads, entry.x * kTile);
  };
  // Step j's K tile (and, from a bf16 source, its bit tile) into K ring
  // stage j % 2, its V tile into V ring stage j % 2 (an 8-bit source's into
  // the raw ring's, with their scales); entry: the step's (KV tile, bits),
  // r: its tile's first row.
  auto fetch_k = [&](int j, int2 entry, size_t r) {
    const int kv_start = entry.x * kTile;
    if constexpr (Src::kRaw) {
      load_raw<D>(raw.k[j % kStages], reinterpret_cast<const uint8_t*>(k) + r * D,
                  n_kv - kv_start);
      load_rows<kTile>(raw.ks[j % kStages], src.k_scale + r, n_kv - kv_start);
    } else {
      load_tile<D, kTile>(sm.k[j % kStages], k + r * D, n_kv - kv_start);
      blk.fetch_bits(sm.bits[j % kStages], entry);
    }
  };
  auto fetch_v = [&](int j, int2 entry, size_t r) {
    const int kv_start = entry.x * kTile;
    if constexpr (Src::kRaw) {
      load_raw<D>(raw.v[j % kStages], reinterpret_cast<const uint8_t*>(v) + r * D,
                  n_kv - kv_start);
      load_rows<kTile>(raw.vs[j % kStages], src.v_scale + r, n_kv - kv_start);
    } else {
      load_tile<D, kTile>(sm.v[j % kStages], v + r * D, n_kv - kv_start);
    }
  };
  // An 8-bit source's raw K_j (with its scales) and raw V_j into their bf16
  // stages j % 2.
  auto widen_k = [&](int j) {
    if constexpr (Src::kRaw) {
      widen_tile<D>(sm.k[j % kStages], raw.k[j % kStages], src);
      if (threadIdx.x < kTile) raw.sk[j % kStages][threadIdx.x] = raw.ks[j % kStages][threadIdx.x];
    }
  };
  auto widen_v = [&](int j) {
    if constexpr (Src::kRaw) widen_tile<D>(sm.v[j % kStages], raw.v[j % kStages], src);
  };
  // Step j's scales: its widened K stage's and its raw V stage's.
  auto scales = [&](int j) {
    if constexpr (Src::kRaw) {
      return StepScales{raw.sk[j % kStages] + 2 * t, raw.vs[j % kStages] + 2 * t};
    } else {
      return NoScales{};
    }
  };
  // st = Q K_j, issued as one group (not waited for).
  auto issue_scores = [&](float (&st)[kTile / 2], int j) {
#pragma unroll
    for (int x = 0; x < kTile / 2; ++x) st[x] = 0.0f;
    fence_acc(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma(st, desc_k<kTile>(sm.q, kk), desc_k<kTile>(sm.k[j % kStages], kk));
    }
    wgmma_commit();
  };

  // Steps 0, i + 1 and i + 2's entries, each read a step before its fetch;
  // a paged source's rows of the first three steps, its table's loads all
  // issued at once (the other sources compute a row where it is fetched).
  const int2 e0 = blk.entry(0);
  int2 e1 = blk.entry(1), e2 = blk.entry(2);
  size_t paged_rows[3] = {};
  if constexpr (Src::kPaged) {
    paged_rows[0] = row_of(e0);
    paged_rows[1] = row_of(e1);
    paged_rows[2] = row_of(e2);
  }
  auto first_row = [&](int j, int2 entry) {
    return Src::kPaged ? paged_rows[j] : row_of(entry);
  };
  load_tile<D, kTile>(sm.q, q + (q_rows + q_start) * D, rows_valid);
  if constexpr (Src::kRaw) {
    // Raw K_0, K_1 and V_0 (and step 0's bits) land and are widened; then
    // raw K_2 and V_1 and step 1's bits are put in flight.
    if (n_steps > 0) {
      fetch_k(0, e0, first_row(0, e0));
      fetch_v(0, e0, first_row(0, e0));
      blk.fetch_bits(sm.bits[0], e0);
    }
    if (n_steps > 1) fetch_k(1, e1, first_row(1, e1));
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (n_steps > 0) {
      widen_k(0);
      widen_v(0);
    }
    if (n_steps > 1) widen_k(1);
    cp_async_wait_all();  // its proxy fence: the widened stages are wgmma's to read
    __syncthreads();
    if (n_steps > 1) {
      fetch_v(1, e1, first_row(1, e1));
      blk.fetch_bits(sm.bits[1], e1);
    }
    if (n_steps > 2) fetch_k(2, e2, first_row(2, e2));
    cp_async_commit();
  } else {
    if (n_steps > 0) fetch_k(0, e0, first_row(0, e0));
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (n_steps > 0) fetch_v(0, e0, first_row(0, e0));
    if (n_steps > 1) fetch_k(1, e1, first_row(1, e1));
    cp_async_commit();
  }
  // A paged source's rows of the loop's next V and K fetches (steps i + 1
  // and i + 2, from an 8-bit source i + 2 and i + 3), read from its table a
  // step before their fetches, so that the table's load hides behind a step.
  constexpr int kLead = Src::kRaw ? 1 : 0;
  size_t row_v = 0, row_k = 0;
  if constexpr (Src::kPaged) {
    row_v = Src::kRaw ? paged_rows[2] : paged_rows[1];
    row_k = Src::kRaw ? row_of(blk.entry(3)) : paged_rows[2];
  }

  // This thread's two Q rows (accumulator rows g and g + 8 of its warp).
  const int row = warp * 16 + (lane >> 2);
  const int r_lo = q_start + row;
  float o_acc[D / 2] = {};
  float m_i[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float l_i[2] = {0.0f, 0.0f};            // this thread's share of the row sums
  float st[kTile / 2];                    // the next step's scores, then its P
  uint32_t ap[kTile / 16][4];             // this step's P, bf16: PV's A operand
  float alpha[2], sum[2];
  // The P of online_softmax in st: O and the sums rescaled to the new
  // running max, P to bf16 A operands.
  auto take_p = [&]() {
#pragma unroll
    for (int half = 0; half < 2; ++half) l_i[half] = l_i[half] * alpha[half] + sum[half];
#pragma unroll
    for (int x = 0; x < D / 8; ++x) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[4 * x + e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) acc_to_a(ap[kk], st + 8 * kk);
  };

  issue_scores(st, 0);
  wgmma_wait_groups<0>();
  fence_acc(st);
  if (n_steps > 0) {
    online_softmax(st, m_i, alpha, sum, blk.mask(e0, sm.bits[0], row, t), scale_log2,
                   scales(0));
    take_p();
  }
  for (int i = 0; i < n_steps; ++i) {
    // V_i and K_{i+1} (with its bits) have landed, and every warp is done
    // with S_i and PV_{i-1}, whose stages V_{i+1} and K_{i+2} overwrite.
    // From an 8-bit source: raw K_{i+2} and V_{i+1} have landed, and K_{i+1}
    // and V_i are widened, their raw stages free for K_{i+3} and V_{i+2}.
    cp_async_wait_all();
    __syncthreads();
    if constexpr (Src::kRaw) {
      const int2 e_k = blk.entry(i + 3);
      if (i + 3 < n_steps) fetch_k(i + 3, e_k, Src::kPaged ? row_k : row_of(e_k));
      if (i + 2 < n_steps) {
        fetch_v(i + 2, e2, Src::kPaged ? row_v : row_of(e2));
        blk.fetch_bits(sm.bits[i % kStages], e2);
      }
    } else {
      if (i + 1 < n_steps) fetch_v(i + 1, e1, Src::kPaged ? row_v : row_of(e1));
      if (i + 2 < n_steps) fetch_k(i + 2, e2, Src::kPaged ? row_k : row_of(e2));
    }
    cp_async_commit();
    if constexpr (Src::kPaged) {
      row_v = row_k;
      row_k = row_of(blk.entry(i + 3 + kLead));
    }
    const int2 e3 = blk.entry(i + 3);

    // S_{i+1} = Q K_{i+1}, then O += P_i V_i with P_i from registers.
    fence_acc(o_acc);
    issue_scores(st, i + 1);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma(o_acc, ap[kk], desc_mn<kTile>(sm.v[i % kStages], kk));
    }
    wgmma_commit();
    // While both run: K_{i+2} into the K stage S_i read (before S_{i+1}'s
    // softmax), and below, while PV_i runs on, V_{i+1} into the V stage
    // PV_{i-1} read.
    if constexpr (Src::kRaw) {
      if (i + 2 < n_steps) widen_k(i + 2);
    }
    // S_{i+1} is done (groups finish in order) while PV_i still runs.
    wgmma_wait_groups<1>();
    fence_acc(st);
    const bool next = i + 1 < n_steps;
    if (next) {
      online_softmax(st, m_i, alpha, sum, blk.mask(e1, sm.bits[(i + 1) % kStages], row, t),
                     scale_log2, scales(i + 1));
    }
    if constexpr (Src::kRaw) {
      if (i + 1 < n_steps) widen_v(i + 1);
    }
    wgmma_wait_groups<0>();
    fence_acc(o_acc);
    if (next) take_p();
    e1 = e2;
    e2 = e3;
  }
  cp_async_wait_all();

  if constexpr (SplitWalk<Walk>::value) {
    if (blk.n_splits > 1) {
      // This split's partial: o unnormalised, the row max in log2 units
      // (-inf for a row it saw nothing of), the row sum; then the last
      // split of this (Q tile, q-head, batch) to arrive merges them.
      const int unit = blk.b * n_heads + blk.h;
      const size_t n_part = (size_t)gridDim.z * n_heads * blk.n_splits * n_q;
      float* part_m = walk.part + n_part * D;
      float* part_l = part_m + n_part;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float l = l_i[half];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int r = r_lo + half * 8;
        if (r < n_q) {
          const size_t p = ((size_t)unit * blk.n_splits + blk.split) * n_q + r;
          store_row<D>(walk.part + p * D, o_acc, half, 1.0f, t);
          if (t == 0) {
            part_m[p] = m_i[half];
            part_l[p] = l;
          }
        }
      }
      int* ticket = walk.tickets + (size_t)unit * (gridDim.x / blk.n_splits) + blk.tile;
      if (!split_merge::last_to_arrive(ticket, blk.n_splits)) return;
      split_merge::merge_rows<D, kThreads>(walk.part, n_part, unit, blk.n_splits, n_q, q_start,
                                           rows_valid, o, lse, q_rows, ticket);
      return;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_i[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r_lo + half * 8;
    if (r < n_q) {
      store_row<D>(o + (q_rows + r) * D, o_acc, half, l > 0.0f ? 1.0f / l : 0.0f, t);
      if (lse != nullptr && t == 0) {
        lse[q_rows + r] = l > 0.0f ? (m_i[half] + log2f(l)) * kLn2 : -INFINITY;
      }
    }
  }
}

// The kernel on a walk over `grid` from a KV source: q, o [B, H, N_q, D];
// k, v [B, H_kv, N_kv, D] (DenseBf16; the other sources' storage, see
// flash_kv_sm90.cu); lse fp32 [B, H, N_q] or null.
template <int D, class Walk, class Src = DenseBf16>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int n_heads, int n_kv_heads, int n_q, int n_kv, float sm_scale,
                   const Walk& walk, dim3 grid, cudaStream_t stream, const Src& src = Src{}) {
  // The dynamic shared-memory limit is raised once per device.
  static bool smem_set[kMaxDevices] = {};
  const int smem = (int)sizeof(FwdSmem<D, Walk::kBits>) +
                   (Src::kRaw ? (int)sizeof(RawRing<D>) : 0) + kAlign;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D, Walk, Src>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  flash_fwd_sm90_kernel<D, Walk, Src><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), n_heads, n_kv_heads, n_q, n_kv,
      sm_scale * kLog2e, walk, src);
  return cudaGetLastError();
}

// The dense walk: q_offset int32 [B], or null for fixed_offset.
template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* q_offset,
                       int fixed_offset, void* o, void* lse, int batch, int n_heads,
                       int n_kv_heads, int n_q, int n_kv, float sm_scale, int causal,
                       cudaStream_t stream) {
  const dim3 grid((n_q + kTile - 1) / kTile, n_heads, batch);
  return launch<D>(q, k, v, o, lse, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                   DenseWalk{q_offset, fixed_offset, causal}, grid, stream);
}

// The dense walk under a window (f.window, f.sinks) and, when f.q_seg is
// set, segment ids (q_seg [B, N_q], kv_seg [B, N_kv]); under the score
// transforms (f.xf(): the softcap, the slopes) the walks that take them,
// and under dropout (f.drop) the transformed walks with it.
template <int D>
cudaError_t launch_fwd_feat(const void* q, const void* k, const void* v, const int* q_offset,
                            void* o, void* lse, int batch, int n_heads, int n_kv_heads, int n_q,
                            int n_kv, float sm_scale, int causal, const Feat& f,
                            cudaStream_t stream) {
  const dim3 grid((n_q + kTile - 1) / kTile, n_heads, batch);
  if (f.drop.on()) {
    if (f.q_seg != nullptr) {
      return launch<D>(q, k, v, o, lse, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                       FeatWalk<true, true, true>{q_offset, 0, causal, f.window, f.sinks,
                                                  f.q_seg, f.kv_seg, f.softcap, sm_scale,
                                                  f.slopes, f.drop},
                       grid, stream);
    }
    return launch<D>(q, k, v, o, lse, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                     FeatWalk<false, true, true>{q_offset, 0, causal, f.window, f.sinks, nullptr,
                                                 nullptr, f.softcap, sm_scale, f.slopes, f.drop},
                     grid, stream);
  }
  if (f.xf()) {
    if (f.q_seg != nullptr) {
      return launch<D>(q, k, v, o, lse, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                       FeatWalk<true, true>{q_offset, 0, causal, f.window, f.sinks, f.q_seg,
                                            f.kv_seg, f.softcap, sm_scale, f.slopes},
                       grid, stream);
    }
    return launch<D>(q, k, v, o, lse, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                     FeatWalk<false, true>{q_offset, 0, causal, f.window, f.sinks, nullptr,
                                           nullptr, f.softcap, sm_scale, f.slopes},
                     grid, stream);
  }
  if (f.q_seg != nullptr) {
    return launch<D>(q, k, v, o, lse, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                     FeatWalk<true>{q_offset, 0, causal, f.window, f.sinks, f.q_seg, f.kv_seg},
                     grid, stream);
  }
  return launch<D>(q, k, v, o, lse, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                   FeatWalk<false>{q_offset, 0, causal, f.window, f.sinks}, grid, stream);
}

// The position walk over a rolling cache: q_offset int32 [B], f.kv_pos
// [B, N_kv], f's window, sinks and transforms; with f.q_seg set, its
// segmented instance (q_seg [B, N_q], kv_seg [B, N_kv]).
template <int D>
cudaError_t launch_fwd_pos(const void* q, const void* k, const void* v, const int* q_offset,
                           void* o, void* lse, int batch, int n_heads, int n_kv_heads, int n_q,
                           int n_kv, float sm_scale, const Feat& f, cudaStream_t stream) {
  const dim3 grid((n_q + kTile - 1) / kTile, n_heads, batch);
  const PosWalkT<false> base{q_offset, f.kv_pos, f.window, f.sinks, f.softcap, sm_scale, f.slopes};
  if (f.q_seg != nullptr) {
    return launch<D>(q, k, v, o, lse, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                     PosSegWalk{{base.q_offset, base.kv_pos, base.window, base.sinks,
                                 base.softcap, base.sm_scale, base.slopes},
                                f.q_seg, f.kv_seg},
                     grid, stream);
  }
  return launch<D>(q, k, v, o, lse, n_heads, n_kv_heads, n_q, n_kv, sm_scale, PosWalk{base},
                   grid, stream);
}

// The sparse walk: grid (q-head x batch, Q tiles).
template <int D>
cudaError_t launch_fwd_sparse(const void* q, const void* k, const void* v, void* o, void* lse,
                              const SparseFwdWalk& walk, int batch, int n_heads, int n_kv_heads,
                              int n_q, int n_kv, float sm_scale, cudaStream_t stream) {
  const dim3 grid(batch * n_heads, (n_q + kTile - 1) / kTile);
  return launch<D>(q, k, v, o, lse, n_heads, n_kv_heads, n_q, n_kv, sm_scale, walk, grid,
                   stream);
}

}  // namespace sm90
}  // namespace
