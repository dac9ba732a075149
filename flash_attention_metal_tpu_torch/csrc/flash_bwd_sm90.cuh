// The split backward pair redesigned for Hopper (sm_90a), bf16, head dim 64
// or 128: dK/dV and dQ, one mainloop for two walks.  Included by
// flash_bwd.cu, whose C entries (fam_flash_bwd_dkv, fam_flash_bwd_dq) launch
// these kernels on the causal walk for bf16 (the FMA template there
// for fp32), and by flash_mask.cu, whose bf16 backward entries
// (fam_flash_sparse_dkv, fam_flash_sparse_dq) launch them on the sparse
// walk (the first-generation template there for fp32).
//
// Replaces flash_attention_metal_tpu/kernels/flash_bwd.py::_dkv_kernel
// (dK, dV over KV tiles) and ::_dq_kernel (dQ over Q tiles), the backward
// of every untuned training step; and flash_mask.py::_dkv_sparse_kernel and
// ::_dq_sparse_kernel, the block-sparse backward.  The contract is flash_bwd.cu's: native
// GQA with dK/dV summed over the group in fp32 inside the block, per-batch
// device offsets, lse = -inf (and padding) rows held at a sentinel so their
// P is exactly 0, P and dS rounded to bf16 before their products, one owner
// per output tile and no atomics (deterministic).
//
// What bounds it on the H100.  At the training shape (q [4,16,2048,64],
// kv [4,8,2048,64], causal) the pair does 8 D + 6 D flops per visible
// (row, column) pair: 68.7 + 51.5 GFLOP against ~50 MB of I/O.  That is
// the tensor cores' side of the roofline: 0.0695 + 0.0521 ms at 989 TF/s.
//
// What the design does about the three faults of the first design (every
// product round-tripped through shared memory; no load overlapped compute;
// two 128-thread blocks of ~90 KB per SM):
//   * Products run on wgmma and stay in registers.  A block is one
//     warpgroup (4 warps of 16 rows); each product is wgmma.m64nNk16 (bf16
//     in, fp32 accumulate).  The dK/dV block computes the scores
//     transposed, S^T = K Q^T and dP^T = V dO^T, so the accumulator rows
//     are the block's 64 KV rows.  P^T and dS^T are formed there, rounded
//     to bf16 and packed straight into the register A operand of dV += P^T
//     dO and dK += dS^T Q (a 64-row accumulator's layout is the A-register
//     layout of the next product, two n8 tiles per k16 step).  The dQ block
//     does the same with S = Q K^T, dP = dO V^T and dQ += dS K.  Nothing of
//     S, P, dP or dS touches shared memory; dK, dV and dQ live in fp32
//     registers for the whole walk.  B operands (and the A of S and dP) are
//     read by the tensor cores from shared memory through descriptors:
//     K-major where the product's K runs along a tile row, MN-major
//     (transposed) where it runs down the rows, one copy of each tile
//     serving both.
//   * Loads overlap compute.  The walked tiles (Q, dO, lse and delta rows
//     for dK/dV; K and V for dQ) come through a 2-stage ring filled with
//     cp.async: tile i + 1 is in flight while tile i computes, and one
//     barrier per step orders the ring.  Tiles are stored in wgmma's
//     128-byte-swizzle layout (16-byte chunk c of row r at c ^ (r & 7), in
//     64-column blocks), so neither the copies nor the tensor cores' reads
//     conflict on banks and no padding is spent.
//   * More warps per SM.  Shared memory is 49.5 KB (dK/dV) and 48 KB (dQ)
//     at D = 64, so registers, not shared memory, bound the blocks per SM.
//     Blocks are launched heaviest first (KV tile 0, the last Q tile).
//
// Tiles, from the 227 KB and 255-register budgets: one warpgroup, a 64-row
// KV tile per dK/dV block and a 64-row Q tile per dQ block.  The dK/dV
// block walks Q tiles of 64 rows at D = 64 and 32 rows at D = 128 (S^T and
// dP^T take rows / 2 fp32 registers a thread each beside the D / 2 of dK
// and of dV: 128 at D = 64, 160 at D = 128); the dQ block walks KV tiles of
// 64 rows.  Shared memory at D = 128: 65 KB (dK/dV), 96 KB (dQ).
//
// The walks.  A kernel takes a walk policy: which block owns which output
// tile, how many steps it takes, each step's (q-head, tile), whether a step
// is full (every element visible: the compare is skipped) and the element
// test.  Both are block-uniform but the test, which selects on the
// accumulator after the products, so no wgmma sits under a branch.
//   * CausalWalk (rows 5-6): one block per (KV head x batch, KV tile) or
//     (q-head x batch, Q tile), heaviest first; the Q tiles that see the KV
//     tile / the KV tiles up to the diagonal; c <= r + q_offset[b].  Under
//     a sliding window (window.cuh) the dK/dV walk ends at the last Q tile
//     whose window reaches the KV tile (every later Q tile after a tile of
//     sinks), and the dQ walk is the sink tiles then the window's: the
//     tiles outside are neither loaded nor computed.  With segment ids
//     (CausalWalkT<true>) every step compares: the walked tile's ids come
//     through the ring's bit stage, the block's own tile's ids are read
//     once per thread.  The window is a template flag (CausalWalkT<kSeg,
//     kWin>): an unwindowed call runs the causal walk with no window
//     state.  Attention dropout (CausalWalkT<kSeg, true, true, true>)
//     rebuilds the forward's keep mask from the seed and each score's
//     (q row, KV column, q-head): dV takes the dropped P, dS the undropped
//     one (dS = P (dP keep - delta)), and under ALiBi d_slopes sums that
//     dS.
//   * SparseWalk (rows 15-16): a MaskTables' CSR lists of 64 x 64 tile
//     pairs (kernels/flash_mask.py::compile_tables), a full pair (bits -1)
//     or one of 64 x 2-word bit tiles.  A partial step's bit rows come
//     through the ring beside lse and delta (a thread reads one word per
//     Q row from shared memory); a full one loads and tests nothing.  The
//     dQ block walks its Q tile's KV list, Q tiles issued by a host-made
//     order, longest list first.  The dK/dV grid follows a host-made plan
//     of chunks: a KV tile's walk over the group's q-heads and its
//     transposed list (group x list length pairs) longer than the cap is
//     cut into chunks, each a block, issued longest first.  A chunk of a
//     split tile writes its fp32 dK/dV to a workspace slot; the last of
//     the tile's chunks to arrive (an acq_rel ticket it resets) sums the
//     slots in chunk order and stores once, so the result has the same
//     bits on every run and whichever chunk ends last.  An unsplit tile
//     stores straight from registers.
//
// Not done yet: TMA with mbarriers in place of cp.async, a producer warp
// and two consumer warpgroups per block (warp specialisation), and
// overlapping one step's softmax with the next step's products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tiles.cuh"
#include "window.cuh"
#include "wmma_tiles.cuh"  // kLseSentinel, allow_smem

namespace {
namespace sm90 {

// Q rows per step of the dK/dV walk, and the blocks an SM must hold: at
// D = 64 the kernel wants 174 registers a thread, two blocks an SM; capped
// at 168 (a few bytes of spill) it holds three, and the causal walk ran
// 12% faster at the training shape on the H100 (`onchip kernels`, PERF.md
// §6).
template <int D>
struct DkvStep {
  static constexpr int kRows = D == 64 ? 64 : 32;
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;
};

// lse in log2 units, sentinel-guarded.
__device__ __forceinline__ float lse_log2(float x) {
  return (x == -INFINITY ? kLseSentinel : x) * kLog2e;
}

// What both kernels take besides their walk.  q, dout, dq [B, H, N_q, D];
// k, v, dk, dv [B, H_kv, N_kv, D]; lse, delta fp32 [B, H, N_q].
struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dk, *dv, *dq;
  int n_heads, n_kv_heads, n_q, n_kv;
  float sm_scale, scale_log2;
};

// One step of a walk: the group's q-head g (dK/dV), the walked tile's first
// row, its bit tile (-1: none) and the first of its rows the step covers,
// and whether every element of the step is visible.
struct Step {
  int g, start, bits, bit_row;
  bool full;
};

// Element (row, col) of a bit-tile stage: row within the staged rows, col
// within the 64 KV columns.
__device__ __forceinline__ bool bit_seen(const uint32_t* bits, int row, int col) {
  return (bits[row * 2 + (col >> 5)] >> (col & 31)) & 1u;
}

// The split pair's causal walk (rows 5-6).  q_offset: int32 [B], column c
// visible from row r (position p = r + q_offset[b]) when c <= p; null:
// every column.  kWin: only inside the row's window (window, sinks); kSeg:
// also only equal segment ids (q_seg [B, N_q], kv_seg [B, N_kv]).  Without
// kWin the walk holds no window state.  kXf (with kWin, whose window may be
// kNoWindow): the score transforms (xf.cuh: softcap, slopes, the bias
// measured from r + pos[b], pos the offsets also when not causal), and
// dK/dV's d_slopes partials into dslope (fp32 [B, H, n_kv_tiles,
// kXfWarps], or null: none).  kDrop (with kXf, whose cap may be 0 and
// slopes null): attention dropout (dropout.cuh): dV takes the dropped P,
// dS = P (dP keep - delta) the undropped one.
template <bool kSeg, bool kWin, bool kXf_ = false, bool kDrop_ = false>
struct CausalWalkT {
  static_assert(kXf_ || !kDrop_, "dropout rides the transformed walk");
  static constexpr bool kBits = kSeg;  // the bit stage holds the walked tile's ids
  static constexpr bool kXf = kXf_;
  static constexpr bool kDrop = kDrop_;
  const int* q_offset;
  int window = kNoWindow, sinks = 0;
  const int* q_seg = nullptr;
  const int* kv_seg = nullptr;
  float softcap = 0.0f;
  const float* slopes = nullptr;
  const int* pos = nullptr;
  float* dslope = nullptr;
  Drop drop = {};

  // Without a window an offset past n_kv - 1 sees what n_kv - 1 sees; a
  // window moves with it, so it is read as it is.
  __device__ int offset(int b, int n_kv) const {
    if (q_offset == nullptr) return n_kv - 1;
    if constexpr (kWin) return q_offset[b];
    return min(q_offset[b], n_kv - 1);
  }

  // A block per (KV head x batch, KV tile), KV tile 0 first, over the
  // group's q-heads and the Q tiles of kRows rows that see the tile.
  template <int kRows>
  struct Dkv {
    int bh, kv_tile, n_steps;
    int kv_start, n_q, off, q_first, per_head, window, sinks;
    const int* q_ids;
    int kid[2];
    int xoff;  // the offset the bias measures rows from
    DropBlock drop;
    __device__ Dkv(const CausalWalkT& w, const BwdArgs& a) {
      bh = blockIdx.x;
      kv_tile = blockIdx.y;
      kv_start = kv_tile * kTile;
      n_q = a.n_q;
      const int b = bh / a.n_kv_heads;
      off = w.offset(b, a.n_kv);
      xoff = kXf_ ? w.pos[b] : 0;
      if constexpr (kDrop_) drop = DropBlock(w.drop, b);
      window = w.window;
      sinks = w.sinks;
      // Rows r >= kv_start - off see the tile's first column; earlier Q
      // tiles see none of it and are skipped; under a window, so are the
      // Q tiles past the last whose window reaches the tile.
      q_first = max(0, kv_start - off) / kRows;
      if constexpr (kWin) {
        per_head = max(0, q_end<kRows>(kv_start, min(kv_start + kTile, a.n_kv) - 1, off, n_q,
                                       window, sinks) - q_first);
      } else {
        per_head = max(0, (n_q + kRows - 1) / kRows - q_first);
      }
      const int group = a.n_heads / a.n_kv_heads;
      n_steps = group * per_head;
      q_ids = nullptr;
      kid[0] = kid[1] = 0;
      if constexpr (kSeg) {
        q_ids = w.q_seg + (size_t)b * n_q;
        // This thread's two KV rows (accumulator rows g and g + 8 of its warp).
        const int c = kv_start + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          kid[half] = w.kv_seg[(size_t)b * a.n_kv + min(c + half * 8, a.n_kv - 1)];
        }
      }
    }
    __device__ Step step(int i) const {
      const int q_start = (q_first + i % per_head) * kRows;
      bool full = kv_start + kTile - 1 <= q_start + off && q_start + kRows <= n_q;
      if constexpr (kWin) {
        full = full && tile_in_window(kv_start, kTile, q_start + kRows - 1 + off, window, sinks);
      }
      return {i / per_head, q_start, -1, 0, full && !kSeg};
    }
    // With segment ids the step's Q ids ride the ring's bit stage.
    __device__ void fetch_bits(uint32_t* dst, const Step& st) const {
      if constexpr (kSeg) load_ids<kRows>(dst, q_ids + st.start, n_q - st.start);
    }
    // row: the Q row within the step; c's id is this thread's (bit 3 of its
    // row in the tile picks which of its two).
    __device__ bool seen(const uint32_t* ids, int r, int c, int row, int col) const {
      bool ok = r < n_q && c <= r + off;
      if constexpr (kWin) ok = ok && in_window(c, r + off, window, sinks);
      if constexpr (kSeg) ok = ok && (int)ids[row] == kid[(col >> 3) & 1];
      return ok;
    }
    template <int D>
    __device__ bool merge(float (&)[D / 2], float (&)[D / 2]) const { return true; }
  };

  // A block per (q-head x batch, Q tile), the last Q tile first, over the
  // KV tiles up to its last row's diagonal; under a window, the sink tiles
  // and then the window's tiles up to it.
  struct Dq {
    int bh, q_tile, n_steps;
    int q_start, n_kv, off, window, sinks;
    TileRuns runs;
    const int* kv_ids;
    int qid[2];
    int xoff;  // the offset the bias measures rows from
    DropBlock drop;
    __device__ Dq(const CausalWalkT& w, const BwdArgs& a) {
      bh = blockIdx.x;
      q_tile = gridDim.y - 1 - blockIdx.y;
      q_start = q_tile * kTile;
      n_kv = a.n_kv;
      const int b = bh / a.n_heads;
      off = w.offset(b, n_kv);
      xoff = kXf_ ? w.pos[b] : 0;
      if constexpr (kDrop_) drop = DropBlock(w.drop, b);
      window = w.window;
      sinks = w.sinks;
      const int rows_valid = min(kTile, a.n_q - q_start);
      if constexpr (kWin) {
        runs = kv_runs<kTile>(q_start + off, q_start + rows_valid - 1 + off, n_kv, window, sinks);
        n_steps = runs.steps();
      } else {
        // The KV walk stops at the last tile the tile's last row sees.
        const int limit = min(q_start + rows_valid - 1 + off, n_kv - 1);
        n_steps = limit < 0 ? 0 : limit / kTile + 1;
      }
      kv_ids = nullptr;
      qid[0] = qid[1] = 0;
      if constexpr (kSeg) {
        kv_ids = w.kv_seg + (size_t)b * n_kv;
        // This thread's two Q rows (accumulator rows g and g + 8 of its warp).
        const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          qid[half] = w.q_seg[(size_t)b * a.n_q + min(q_start + row + half * 8, a.n_q - 1)];
        }
      }
    }
    __device__ Step step(int i) const {
      int kv_start = i * kTile;
      if constexpr (kWin) kv_start = runs.tile(i) * kTile;
      bool full = kv_start + kTile - 1 <= q_start + off && kv_start + kTile <= n_kv;
      if constexpr (kWin) {
        full = full && tile_in_window(kv_start, kTile, q_start + kTile - 1 + off, window, sinks);
      }
      return {0, kv_start, -1, 0, full && !kSeg};
    }
    // With segment ids the step's KV ids ride the K ring's bit stage.
    __device__ void fetch_bits(uint32_t* dst, const Step& st) const {
      if constexpr (kSeg) load_ids<kTile>(dst, kv_ids + st.start, n_kv - st.start);
    }
    // row: r's row within the Q tile (bit 3 picks which of this thread's
    // two ids), col: c's column within the step's tile.
    __device__ bool seen(const uint32_t* ids, int r, int c, int row, int col) const {
      bool ok = c < n_kv && c <= r + off;
      if constexpr (kWin) ok = ok && in_window(c, r + off, window, sinks);
      if constexpr (kSeg) ok = ok && (int)ids[col] == qid[(row >> 3) & 1];
      return ok;
    }
  };
};
using CausalWalk = CausalWalkT<false, false>;

// Ints per entry of the dK/dV plan (kernels/flash_mask.py::dkv_plan): KV
// tile, first and end pair of the chunk in the tile's walk, the chunk's
// index and the tile's chunk count, the tile's first workspace slot, the
// tile's ticket group (split tiles only), padding.
constexpr int kPlanInts = 8;

// The block-sparse walk (rows 15-16) over a MaskTables.  ptr / list: the
// per-KV-tile lists (dK/dV) or per-Q-tile lists (dQ); plan: the dK/dV
// plan, or the dQ kernel's Q tiles in issue order; part: fp32 slots of
// 64 x D dK and dV, kThreads-strided by accumulator register, per (slot,
// KV head x batch); tickets: one int per (split tile, KV head x batch),
// zero between calls.
struct SparseWalk {
  static constexpr bool kBits = true;
  static constexpr bool kXf = false;
  static constexpr bool kDrop = false;
  const int* plan;
  const int* ptr;
  const int2* list;
  const uint32_t* bit_tiles;
  float* part;
  int* tickets;

  // A block per (KV head x batch, plan entry): pairs p0 .. p1 - 1 of the
  // walk p -> (q-head p / len, list entry p % len), kRows / 64 steps each.
  template <int kRows>
  struct Dkv {
    static constexpr int kSub = kTile / kRows;
    const int2* list;
    const uint32_t* bit_tiles;
    float* part;
    int* tickets;
    int bh, kv_tile, n_steps;
    int first, len, p0, chunk, n_chunks, slot0, ticket;
    __device__ Dkv(const SparseWalk& walk, const BwdArgs&) {
      list = walk.list;
      bit_tiles = walk.bit_tiles;
      part = walk.part;
      tickets = walk.tickets;
      const int* e = walk.plan + (size_t)blockIdx.y * kPlanInts;
      bh = blockIdx.x;
      kv_tile = e[0];
      p0 = e[1];
      n_steps = (e[2] - e[1]) * kSub;
      chunk = e[3];
      n_chunks = e[4];
      slot0 = e[5];
      ticket = e[6] * gridDim.x + bh;
      first = walk.ptr[kv_tile];
      len = walk.ptr[kv_tile + 1] - first;
    }
    __device__ Step step(int i) const {
      const int p = p0 + i / kSub;
      const int2 entry = list[first + p % len];
      const int row = (i % kSub) * kRows;
      return {p / len, entry.x * kTile + row, entry.y, row, entry.y < 0};
    }
    __device__ void fetch_bits(uint32_t* dst, const Step& st) const {
      if (!st.full) load_bits<kRows>(dst, bit_tiles, st.bits, st.bit_row);
    }
    __device__ bool seen(const uint32_t* bits, int, int, int row, int col) const {
      return bit_seen(bits, row, col);
    }
    // A chunk of a split tile: publish this block's sums, and let the last
    // chunk to arrive replace its own with every chunk's, in chunk order.
    // False: another block stores the tile.
    template <int D>
    __device__ bool merge(float (&dk)[D / 2], float (&dv)[D / 2]) const {
      if (n_chunks == 1) return true;
      __shared__ int is_last;
      const int tid = threadIdx.x;
      const size_t n_bh = gridDim.x;
      float* mine = part + ((size_t)(slot0 + chunk) * n_bh + bh) * D * kThreads;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        __stcg(mine + i * kThreads + tid, dk[i]);
        __stcg(mine + (D / 2 + i) * kThreads + tid, dv[i]);
      }
      // The barrier, then one thread's acq_rel add, publish this block's
      // sums and see the earlier chunks' (csrc/flash_decode.cuh's merge).
      __syncthreads();
      if (tid == 0) {
        int arrived;
        asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                     : "=r"(arrived) : "l"(tickets + ticket) : "memory");
        is_last = arrived == n_chunks - 1;
      }
      __syncthreads();
      if (!is_last) return false;
      const float* slots = part + ((size_t)slot0 * n_bh + bh) * D * kThreads;
      const size_t stride = n_bh * D * kThreads;  // one slot to the next
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        float sk = 0.0f, sv = 0.0f;
        for (int c = 0; c < n_chunks; ++c) {  // in chunk order: the same bits on every run
          const float* at = slots + c * stride + i * kThreads + tid;
          sk += c == chunk ? dk[i] : __ldcg(at);
          sv += c == chunk ? dv[i] : __ldcg(at + (D / 2) * kThreads);
        }
        dk[i] = sk;
        dv[i] = sv;
      }
      if (tid == 0) tickets[ticket] = 0;  // ready for the next call on this stream
      return true;
    }
  };

  // A block per (q-head x batch, plan[blockIdx.y]): the Q tile's KV list.
  struct Dq {
    const int2* list;
    const uint32_t* bit_tiles;
    int bh, q_tile, n_steps, first;
    __device__ Dq(const SparseWalk& walk, const BwdArgs&) {
      list = walk.list;
      bit_tiles = walk.bit_tiles;
      bh = blockIdx.x;
      q_tile = walk.plan[blockIdx.y];
      first = walk.ptr[q_tile];
      n_steps = walk.ptr[q_tile + 1] - first;
    }
    __device__ Step step(int i) const {
      const int2 entry = list[first + i];
      return {0, entry.x * kTile, entry.y, 0, entry.y < 0};
    }
    __device__ void fetch_bits(uint32_t* dst, const Step& st) const {
      if (!st.full) load_bits<kTile>(dst, bit_tiles, st.bits, 0);
    }
    __device__ bool seen(const uint32_t* bits, int, int, int row, int col) const {
      return bit_seen(bits, row, col);
    }
  };
};

template <int D, bool kBits>
struct DkvSmem {
  static constexpr int kRows = DkvStep<D>::kRows;
  bf16 k[kTile * D];
  bf16 v[kTile * D];
  bf16 q[kStages][kRows * D];
  bf16 dout[kStages][kRows * D];
  float lse[kStages][kRows];
  float delta[kStages][kRows];
  alignas(16) uint32_t bits[kStages][kBits ? kRows * 2 : 4];  // the step's bit rows
};

// dK and dV of one KV tile over the steps of its walk (a chunk of it on
// the sparse walk).  Warp w owns KV rows 16w..16w+15 of every product.
template <int D, class Walk>
__global__ void __launch_bounds__(kThreads, DkvStep<D>::kMinBlocks)
    flash_bwd_dkv_sm90_kernel(const BwdArgs a, const Walk walk) {
  constexpr int kRows = DkvStep<D>::kRows;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D, Walk::kBits>& sm =
      *reinterpret_cast<DkvSmem<D, Walk::kBits>*>(aligned_smem(smem_raw));
  const typename Walk::template Dkv<kRows> blk(walk, a);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int kv_start = blk.kv_tile * kTile;
  const int b = blk.bh / a.n_kv_heads;
  const int h_kv = blk.bh % a.n_kv_heads;
  const int group = a.n_heads / a.n_kv_heads;
  const size_t kv_rows = (size_t)blk.bh * a.n_kv;
  const int n_steps = blk.n_steps;
  // This thread's two KV rows (accumulator rows g and g + 8 of its warp).
  const int c_lo = kv_start + warp * 16 + (lane >> 2);

  load_tile<D, kTile>(sm.k, a.k + (kv_rows + kv_start) * D, a.n_kv - kv_start);
  load_tile<D, kTile>(sm.v, a.v + (kv_rows + kv_start) * D, a.n_kv - kv_start);
  // Step i's Q tile, dO tile, lse and delta rows (and bit rows) into ring
  // stage i % 2.
  auto fetch = [&](int i) {
    const Step st = blk.step(i);
    const size_t q_rows = ((size_t)b * a.n_heads + h_kv * group + st.g) * a.n_q;
    const int rows_valid = a.n_q - st.start;
    const int s = i % kStages;
    load_tile<D, kRows>(sm.q[s], a.q + (q_rows + st.start) * D, rows_valid);
    load_tile<D, kRows>(sm.dout[s], a.dout + (q_rows + st.start) * D, rows_valid);
    load_rows<kRows>(sm.lse[s], a.lse + q_rows + st.start, rows_valid);
    load_rows<kRows>(sm.delta[s], a.delta + q_rows + st.start, rows_valid);
    blk.fetch_bits(sm.bits[s], st);
  };
  if (n_steps > 0) fetch(0);
  cp_async_commit();

  // The score transforms: each step's q-head's, and this thread's share of
  // its d_slopes partial over the steps of that head.
  XfHead xf;
  float dslope = 0.0f;
  // Dropout: this thread's KV row's column term of the hash (the second
  // row's is 8 columns on).
  uint32_t dcol = 0;
  if constexpr (Walk::kDrop) dcol = blk.drop.col_term(c_lo);

  float dk_acc[D / 2] = {};
  float dv_acc[D / 2] = {};
  for (int i = 0; i < n_steps; ++i) {
    // Step i's tiles have landed, and every warp is done with step i - 1's
    // stage, which step i + 1's copies overwrite.
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_steps) fetch(i + 1);
    cp_async_commit();
    const int s = i % kStages;
    const Step st = blk.step(i);
    const uint32_t* step_bits = sm.bits[s];

    // S^T = K Q^T and dP^T = V dO^T: 64 KV rows by kRows q rows.
    float st_acc[kRows / 2] = {};
    float dpt[kRows / 2] = {};
    fence_acc(st_acc);
    fence_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma(st_acc, desc_k<kTile>(sm.k, kk), desc_k<kRows>(sm.q[s], kk));
      wgmma(dpt, desc_k<kTile>(sm.v, kk), desc_k<kRows>(sm.dout[s], kk));
    }
    wgmma_wait(st_acc);
    fence_acc(dpt);
    if constexpr (Walk::kXf) {
      xf = XfHead(walk.softcap, walk.slopes, h_kv * group + st.g, a.sm_scale);
      xf_cap<false>(xf, st_acc);  // capped scores t, log2 units
    }

    // P^T and dS^T in place.  Element e of n8 tile j: KV row c_lo (+ 8 for
    // e >= 2), q row st.start + 8 j + 2 t + (e & 1).  Steps whose every
    // pair is visible skip the test.  Under the transforms dS^T takes the
    // bias's distance into d_slopes, then the softcap's chain; an
    // element's distance c - r - offset is the step's base plus a constant.
    // Under dropout the hash takes (q row, KV column), not the tile's axes:
    // each of this thread's q rows is hashed once a step (two a j).
    float base = 0.0f;
    if constexpr (Walk::kXf) base = (float)(c_lo - st.start - 2 * t - blk.xoff);
    uint32_t dhead = 0;
    if constexpr (Walk::kDrop) dhead = blk.drop.head_hash(h_kv * group + st.g);
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[s][col]);
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[s][col]);
      const float lse2[2] = {lse_log2(l2.x), lse_log2(l2.y)};
      const float dlt[2] = {dl.x, dl.y};
      uint32_t drow[2] = {0u, 0u};
      if constexpr (Walk::kDrop) {
        drow[0] = blk.drop.row_hash(dhead, st.start + col) + dcol;
        drow[1] = blk.drop.row_hash(dhead, st.start + col + 1) + dcol;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = st.start + col + (e & 1);
        const int c = c_lo + (e >> 1) * 8;
        float p, dist = 0.0f, chain = 1.0f;
        if constexpr (Walk::kXf) {
          const float t2 = st_acc[4 * j + e];
          dist = base + (float)((e >> 1) * 8 - j * 8 - (e & 1));
          chain = xf.chain(t2);
          p = exp2f(xf.shifted(t2, dist, lse2[e & 1]));
        } else {
          p = exp2f(st_acc[4 * j + e] * a.scale_log2 - lse2[e & 1]);
        }
        if (!st.full && !blk.seen(step_bits, r, c, col + (e & 1), c - kv_start)) p = 0.0f;
        if constexpr (Walk::kDrop) {
          const float keep = blk.drop.keep(drow[e & 1] + (uint32_t)((e >> 1) * 8) * kMixA);
          st_acc[4 * j + e] = p * keep;
          dpt[4 * j + e] = p * (dpt[4 * j + e] * keep - dlt[e & 1]);
        } else {
          st_acc[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt[e & 1]);
        }
        if constexpr (Walk::kXf) {
          dslope = fmaf(dpt[4 * j + e], dist, dslope);
          dpt[4 * j + e] *= chain;
        }
      }
    }
    if constexpr (Walk::kXf) {
      // The head's last step: its partial, per warp (every lane of the warp
      // takes the same branch).
      if (walk.dslope != nullptr && (i + 1) % blk.per_head == 0) {
        const size_t at = (((size_t)b * a.n_heads + h_kv * group + st.g) * gridDim.y +
                           blk.kv_tile) * kXfWarps + warp;
        xf_warp_store(dslope, walk.dslope + at);
        dslope = 0.0f;
      }
    }

    // dV += P^T dO and dK += dS^T Q, the A operands from registers.
    uint32_t ap[kRows / 16][4], ads[kRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      acc_to_a(ap[kk], st_acc + 8 * kk);
      acc_to_a(ads[kk], dpt + 8 * kk);
    }
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma(dv_acc, ap[kk], desc_mn<kRows>(sm.dout[s], kk));
      wgmma(dk_acc, ads[kk], desc_mn<kRows>(sm.q[s], kk));
    }
    wgmma_wait(dv_acc);
    fence_acc(dk_acc);
  }
  cp_async_wait_all();
  if (!blk.template merge<D>(dk_acc, dv_acc)) return;

  for (int half = 0; half < 2; ++half) {
    const int c = c_lo + half * 8;
    if (c < a.n_kv) {
      store_row<D>(a.dk + (kv_rows + c) * D, dk_acc, half, a.sm_scale, t);
      store_row<D>(a.dv + (kv_rows + c) * D, dv_acc, half, 1.0f, t);
    }
  }
}

template <int D, bool kBits>
struct DqSmem {
  bf16 q[kTile * D];
  bf16 dout[kTile * D];
  bf16 k[kStages][kTile * D];
  bf16 v[kStages][kTile * D];
  alignas(16) uint32_t bits[kStages][kBits ? kTile * 2 : 4];  // the pair's bit tile
};

// dQ of one Q tile over the KV tiles of its walk.  Warp w owns Q rows
// 16w..16w+15.
template <int D, class Walk>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_sm90_kernel(const BwdArgs a, const Walk walk) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D, Walk::kBits>& sm = *reinterpret_cast<DqSmem<D, Walk::kBits>*>(aligned_smem(smem_raw));
  const typename Walk::Dq blk(walk, a);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int q_start = blk.q_tile * kTile;
  const int b = blk.bh / a.n_heads;
  const int h_kv = blk.bh % a.n_heads / (a.n_heads / a.n_kv_heads);
  const size_t q_rows = (size_t)blk.bh * a.n_q;
  const size_t kv_rows = ((size_t)b * a.n_kv_heads + h_kv) * a.n_kv;
  const int rows_valid = min(kTile, a.n_q - q_start);
  const int n_steps = blk.n_steps;

  load_tile<D, kTile>(sm.q, a.q + (q_rows + q_start) * D, rows_valid);
  load_tile<D, kTile>(sm.dout, a.dout + (q_rows + q_start) * D, rows_valid);
  // Step i's K and V tiles (and bit tile) into ring stage i % 2.
  auto fetch = [&](int i) {
    const Step st = blk.step(i);
    const int s = i % kStages;
    load_tile<D, kTile>(sm.k[s], a.k + (kv_rows + st.start) * D, a.n_kv - st.start);
    load_tile<D, kTile>(sm.v[s], a.v + (kv_rows + st.start) * D, a.n_kv - st.start);
    blk.fetch_bits(sm.bits[s], st);
  };
  if (n_steps > 0) fetch(0);
  cp_async_commit();

  // This thread's two Q rows (accumulator rows g and g + 8 of its warp):
  // lse in log2 units and delta; padding rows take the sentinel.
  const int r_lo = q_start + warp * 16 + (lane >> 2);
  float lse2[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + half * 8;
    lse2[half] = r < a.n_q ? lse_log2(a.lse[q_rows + r]) : kLseSentinel * kLog2e;
    dlt[half] = r < a.n_q ? a.delta[q_rows + r] : 0.0f;
  }
  // The score transforms of the block's q-head.
  XfHead xf;
  if constexpr (Walk::kXf) xf = XfHead(walk.softcap, walk.slopes, blk.bh % a.n_heads, a.sm_scale);
  // Dropout: this thread's two rows' hashes, the block's for the whole walk.
  uint32_t drow[2] = {0u, 0u};
  if constexpr (Walk::kDrop) {
    const uint32_t head = blk.drop.head_hash(blk.bh % a.n_heads);
#pragma unroll
    for (int half = 0; half < 2; ++half) drow[half] = blk.drop.row_hash(head, r_lo + half * 8);
  }

  float dq_acc[D / 2] = {};
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_steps) fetch(i + 1);
    cp_async_commit();
    const int s = i % kStages;
    const Step st = blk.step(i);
    const int kv_start = st.start;
    const uint32_t* pair_bits = sm.bits[s];

    // S = Q K^T and dP = dO V^T: 64 Q rows by 64 KV columns.
    float st_acc[kTile / 2] = {};
    float dpt[kTile / 2] = {};
    fence_acc(st_acc);
    fence_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma(st_acc, desc_k<kTile>(sm.q, kk), desc_k<kTile>(sm.k[s], kk));
      wgmma(dpt, desc_k<kTile>(sm.dout, kk), desc_k<kTile>(sm.v[s], kk));
    }
    wgmma_wait(st_acc);
    fence_acc(dpt);
    if constexpr (Walk::kXf) xf_cap<false>(xf, st_acc);  // capped scores t, log2 units

    // dS in place of dP.  Element e of n8 tile j: Q row r_lo (+ 8 for
    // e >= 2), KV column kv_start + 8 j + 2 t + (e & 1).  Under the
    // transforms: the bias (the distance the step's base plus a constant),
    // and dS through the softcap's chain.
    float base = 0.0f;
    if constexpr (Walk::kXf) base = (float)(kv_start + 2 * t - r_lo - blk.xoff);
    uint32_t dat[2] = {0u, 0u};
    if constexpr (Walk::kDrop) {
      const uint32_t col = blk.drop.col_term(kv_start + 2 * t);
      dat[0] = drow[0] + col;
      dat[1] = drow[1] + col;
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kv_start + j * 8 + 2 * t + (e & 1);
        const int r = r_lo + (e >> 1) * 8;
        float p, chain = 1.0f;
        if constexpr (Walk::kXf) {
          const float t2 = st_acc[4 * j + e];
          chain = xf.chain(t2);
          p = exp2f(xf.shifted(t2, base + (float)(j * 8 + (e & 1) - (e >> 1) * 8), lse2[e >> 1]));
        } else {
          p = exp2f(st_acc[4 * j + e] * a.scale_log2 - lse2[e >> 1]);
        }
        if (!st.full && !blk.seen(pair_bits, r, c, r - q_start, c - kv_start)) p = 0.0f;
        if constexpr (Walk::kDrop) {
          const float keep = blk.drop.keep(dat[e >> 1] + (uint32_t)(j * 8 + (e & 1)) * kMixA);
          dpt[4 * j + e] = p * (dpt[4 * j + e] * keep - dlt[e >> 1]);
        } else {
          dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt[e >> 1]);
        }
        if constexpr (Walk::kXf) dpt[4 * j + e] *= chain;
      }
    }

    // dQ += dS K, the A operand from registers.
    uint32_t ads[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) acc_to_a(ads[kk], dpt + 8 * kk);
    fence_acc(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) wgmma(dq_acc, ads[kk], desc_mn<kTile>(sm.k[s], kk));
    wgmma_wait(dq_acc);
  }
  cp_async_wait_all();

  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + half * 8;
    if (r < a.n_q) store_row<D>(a.dq + (q_rows + r) * D, dq_acc, half, a.sm_scale, t);
  }
}

// Launchers.  grid: (KV head x batch, walk's tiles or chunks) for dK/dV,
// (q-head x batch, Q tiles) for dQ.
template <int D, class Walk>
cudaError_t launch_dkv(const BwdArgs& a, const Walk& walk, dim3 grid, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(DkvSmem<D, Walk::kBits>) + kAlign;
  cudaError_t err = allow_smem(flash_bwd_dkv_sm90_kernel<D, Walk>, smem, done);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_sm90_kernel<D, Walk><<<grid, kThreads, smem, stream>>>(a, walk);
  return cudaGetLastError();
}

template <int D, class Walk>
cudaError_t launch_dq(const BwdArgs& a, const Walk& walk, dim3 grid, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(DqSmem<D, Walk::kBits>) + kAlign;
  cudaError_t err = allow_smem(flash_bwd_dq_sm90_kernel<D, Walk>, smem, done);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_sm90_kernel<D, Walk><<<grid, kThreads, smem, stream>>>(a, walk);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace
