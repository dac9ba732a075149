// The bf16 forward redesigned for Hopper (sm_90a), head dim 64 or 128: one
// mainloop for two walks.  Included by flash_fwd.cu (fam_flash_fwd, bf16
// with pos_div == 1: the training forward, serving's prefill chunks, the
// ladder's and bench's general calls), by flash_lean.cu (fam_flash_lean,
// bf16) and by flash_tri.cu (fam_flash_tri_fwd, bf16: the bench's causal
// calls), which launch it on the dense walk; and by flash_mask.cu
// (fam_flash_sparse_fwd, bf16), which launches it on the sparse walk.
//
// Replaces flash_attention_metal_tpu/kernels/flash_fwd.py::_fwd_kernel (the
// general kernel, a per-batch device offset), ::_fwd_kernel_lean (the
// whole KV row of n_kv <= 1024 in one block, an int offset given at
// launch), flash_tri.py::_tri_kernel (causal, an int offset given at
// launch, any n_kv) and flash_mask.py::_fwd_sparse_kernel (each Q block
// over its KV skip list, the mask elementwise on visited blocks): one
// function, so one kernel serves all four, each entry with its own launch.
// Lean's exact two-pass softmax becomes the online one here, which changes
// only rounding.
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
// Block shape: one warpgroup, not two.  At lean's N = 1024, B 8, H 1 there
// are only 128 tiles of 64 rows: 128-row blocks would leave half of the
// 132 SMs idle.  At the training shape (2048 tiles) two consumer
// warpgroups sharing each K/V tile halve the tile reads, but measured on
// an H100 (PERF.md, Findings) 256-thread blocks were slower than this
// kernel at every shape: the exposed chain of each step, not L2 traffic,
// held the first design, and the pipelining addresses the chain.
// Shared memory: 40 KB at D = 64, 80 KB at D = 128; the sparse walk's two
// bit stages add 1 KB.
// Not done yet: TMA with mbarriers and warp specialisation (a producer
// warp, two consumer warpgroups in ping-pong).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tiles.cuh"
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
template <class Mask>
__device__ __forceinline__ void online_softmax(float (&st)[kTile / 2], float (&m_i)[2],
                                               float (&alpha)[2], float (&sum)[2],
                                               const Mask& mask, float scale_log2) {
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
template <int D, class Walk>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int n_heads, int n_kv_heads, int n_q,
                          int n_kv, float scale_log2, const Walk walk) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<D, Walk::kBits>& sm =
      *reinterpret_cast<FwdSmem<D, Walk::kBits>*>(aligned_smem(smem_raw));
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
  // Step j's K tile (and bit tile) into K ring stage j % 2, its V tile into
  // V ring stage j % 2; entry: the step's (KV tile, bits).
  auto fetch_k = [&](int j, int2 entry) {
    const int kv_start = entry.x * kTile;
    load_tile<D, kTile>(sm.k[j % kStages], k + (kv_rows + kv_start) * D, n_kv - kv_start);
    blk.fetch_bits(sm.bits[j % kStages], entry);
  };
  auto fetch_v = [&](int j, int2 entry) {
    const int kv_start = entry.x * kTile;
    load_tile<D, kTile>(sm.v[j % kStages], v + (kv_rows + kv_start) * D, n_kv - kv_start);
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

  // Steps 0, i + 1 and i + 2's entries, each read a step before its fetch.
  const int2 e0 = blk.entry(0);
  int2 e1 = blk.entry(1), e2 = blk.entry(2);
  load_tile<D, kTile>(sm.q, q + (q_rows + q_start) * D, rows_valid);
  if (n_steps > 0) fetch_k(0, e0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (n_steps > 0) fetch_v(0, e0);
  if (n_steps > 1) fetch_k(1, e1);
  cp_async_commit();

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
    online_softmax(st, m_i, alpha, sum, blk.mask(e0, sm.bits[0], row, t), scale_log2);
    take_p();
  }
  for (int i = 0; i < n_steps; ++i) {
    // V_i and K_{i+1} (with its bits) have landed, and every warp is done
    // with S_i and PV_{i-1}, whose stages V_{i+1} and K_{i+2} overwrite.
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_steps) fetch_v(i + 1, e1);
    if (i + 2 < n_steps) fetch_k(i + 2, e2);
    cp_async_commit();
    const int2 e3 = blk.entry(i + 3);

    // S_{i+1} = Q K_{i+1}, then O += P_i V_i with P_i from registers.
    fence_acc(o_acc);
    issue_scores(st, i + 1);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma(o_acc, ap[kk], desc_mn<kTile>(sm.v[i % kStages], kk));
    }
    wgmma_commit();
    // S_{i+1} is done (groups finish in order) while PV_i still runs.
    wgmma_wait_groups<1>();
    fence_acc(st);
    const bool next = i + 1 < n_steps;
    if (next) {
      online_softmax(st, m_i, alpha, sum, blk.mask(e1, sm.bits[(i + 1) % kStages], row, t),
                     scale_log2);
    }
    wgmma_wait_groups<0>();
    fence_acc(o_acc);
    if (next) take_p();
    e1 = e2;
    e2 = e3;
  }
  cp_async_wait_all();

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

// The kernel on a walk over `grid`: q, o [B, H, N_q, D]; k, v [B, H_kv,
// N_kv, D]; lse fp32 [B, H, N_q] or null.
template <int D, class Walk>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int n_heads, int n_kv_heads, int n_q, int n_kv, float sm_scale,
                   const Walk& walk, dim3 grid, cudaStream_t stream) {
  // The dynamic shared-memory limit is raised once per device.
  static bool smem_set[kMaxDevices] = {};
  const int smem = (int)sizeof(FwdSmem<D, Walk::kBits>) + kAlign;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D, Walk>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  flash_fwd_sm90_kernel<D, Walk><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), n_heads, n_kv_heads, n_q, n_kv,
      sm_scale * kLog2e, walk);
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
