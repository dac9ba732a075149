// Forward flash attention for Hopper (sm_90a) over a dense, 8-bit or paged
// KV cache: the C entries, their route to the split-KV decode grid
// (flash_decode.cuh) or the wgmma forward (flash_fwd_sm90.cuh, and from
// the 8-bit and paged caches flash_kv_sm90.cu; GQA-folded calls of every
// cache on its split-KV folded grid, flash_fold_sm90.cu), and one device
// template over the KV element type (bf16 / fp32, int8, e4m3, e5m2) and
// the addressing (dense or paged) for the calls none takes: fp32 q.
//
// Replaces four Pallas kernels of flash_attention_metal_tpu/kernels/, each
// with its own entry point:
//   * flash_fwd.py::_fwd_kernel (fam_flash_fwd): a dense bf16 / fp32 cache
//     [B, H_kv, N, D], the kernel of dense serving (chunked prefill, and
//     GQA-folded decode with pos_div = group) and of the training forward.
//     bf16 calls with pos_div == 1 (the training forward, prefill chunks)
//     run the wgmma kernel of flash_fwd_sm90.cuh, folded bf16 calls of
//     more than 16 rows its folded grid; this template takes fp32 (IEEE
//     FMA, held at 1e-5: no tensor-core route meets that), and the fp32
//     lean forward of flash_lean.cu with one int offset;
//   * quant.py::_quant_fwd_kernel (fam_flash_quant): a dense
//     [B, H_kv, N, D] int8 / e4m3 / e5m2 cache with per-token fp32 scales
//     [B, H_kv, N];
//   * paged.py::flash_attention_paged (fam_flash_paged): a bf16 / fp32 page
//     pool [P, H_kv, page, D] read through an int32 page table
//     [B, max_pages];
//   * paged.py::flash_attention_paged_quant (fam_flash_paged_quant): an
//     8-bit page pool with per-token scales [P, H_kv, page].
// Every entry takes head dim D = 64 or 128 (a template parameter).
//
// Contract, for batch b, q-head h, query row r (KV head h / group):
//   s[c] = sm_scale * s_k[c] * (q[b,h,r] . k[c])      (s_k = 1 unscaled)
//   o[b,h,r] = sum_c softmax_c(s) * s_v[c] * v[c]      (s_v = 1 unscaled)
// over the logical columns c < n_kv that are visible: with causal,
// c <= r / pos_div + q_offset[b] (the paged kernels are always causal and
// q_offset is each slot's length).  Dense: k[c] is row c of (b, h_kv).
// Paged: row c % page of physical page table[b, c / page], the page id
// clamped to [0, P - 1] as the Pallas index map clamps it (paged.py:64-65);
// masks are in logical positions, so physical placement never enters the
// scores.  Every entry takes the score transforms of xf.cuh (the tanh
// softcap on s, then the ALiBi bias measured from r / pos_div + q_offset[b]
// or the slot's length; ALiBi with pos_div 1 only) and a sliding window
// with attention sinks (with causal, row position p sees only c > p -
// window, besides c < sinks; the tiles outside both are skipped,
// window.cuh), the dense entries a rolling cache's position map (kv_pos
// int32 [B, N_kv], the position each slot holds, -1 for none; with causal,
// pos_div 1: the mask, the window and ALiBi's distance act on the slots'
// positions, and every KV tile is visited, since slot order is not
// position order), and fam_flash_fwd segment
// ids (only columns of the row's id; such a call takes no split) and
// attention dropout (dropout.cuh: P times its keep factor in the PV
// product, the statistics and the lse of the undropped P; one split, the
// wgmma kernel for bf16, the template for fp32).  A row
// with no visible column gives o = 0 and lse = -inf (the optional lse,
// natural log, fp32 [B, H, N_q], of the dense entry points).
//
// Arithmetic, as the Pallas kernels': 8-bit K/V elements are widened
// exactly (int8 and fp8 values fit bf16's 8-bit significand; the decode
// grid widens them to fp32 registers, where bf16 products are exact too);
// the K scale multiplies each fp32 score column together
// with sm_scale * log2(e); the V scale is folded into P, which is rounded
// to q's type before the PV product (quant.py:265-270), so bf16 results
// keep parity with the Pallas kernel.  Unscaled caches skip both scales at
// compile time.  Softmax statistics and both products accumulate in fp32;
// fp32 inputs use IEEE FMA, never TF32.
//
// What bounds it on the H100.  Decode reads each visible K and V row once:
// 64 bytes of an 8-bit row plus 4 bytes of scale, or 128 bytes of a bf16
// row, for 4 * group flops per row and head: bound by HBM bytes
// (3.35 TB/s).  Prefill at n_q >= 512 does ~n_q / 2 flops per KV byte:
// bound by the tensor cores.
//
// What this design does about it.  Three grids over one contract.
//   * Decode (n_q <= kDecodeRows = 16: a token, or a KV head's group of
//     q-heads folded into rows): split-KV (flash_decode.cuh, its instances
//     in flash_decode*.cu).  The grid is (split, q-head, batch), each split
//     a chunk of KV columns that the caller picks from static shapes, so a
//     decode step fills the 132 SMs whatever the slots' lengths; the last
//     block of a (q-head, batch) merges the splits' partials in split order.
//   * bf16 prefill (bf16 q, pos_div 1, n_q > kDecodeRows: serving's prefill
//     chunks of every 8-bit and paged mode, a rolling int8 cache's too):
//     the wgmma forward of flash_fwd_sm90.cuh from the cache's KV source
//     (flash_kv_sm90.cu: PagedBf16, Dense8, Paged8; the dense entry's bf16
//     calls take its DenseBf16 source there).  An 8-bit source's raw tiles
//     come by cp.async into a raw ring a step ahead and are widened to the
//     swizzled bf16 stages while the products run; a paged source's table
//     is read a step before its tiles' copies.
//   * bf16 calls folded by GQA (pos_div > 1) of more than kDecodeRows rows
//     (a speculative verify window, (gamma + 1) * group rows) of all four
//     entries: the wgmma forward's folded walk on a split-KV grid
//     (flash_fold_sm90.cu), grid (Q tile x split, KV head, batch), the
//     partials merged as the decode grid merges its own (split_merge.cuh).
//   * Everything else (fp32 q, where IEEE FMA is held at 1e-5 and no
//     tensor-core route meets that; the fp32 lean forward): the 64-row template
//     below, one block per (64-row q tile, q-head, batch); the KV loop
//     stops at the last column visible to the tile's last row, so causal
//     prefill skips the upper triangle, and table entries past a slot's
//     diagonal (the unallocated zeros) are never dereferenced.  Each step's
//     K/V tiles are fetched into registers while the step before computes,
//     then stored to shared memory, an 8-bit tile widened on that store.
//     bf16 QK^T and PV run on the tensor cores through WMMA 16x16x16
//     fragments with fp32 accumulators.
//   * Paged addressing is per 64-row KV tile: a page holds whole tiles, so
//     one table lookup serves a tile and its rows are contiguous.
//   * Native GQA (KV head h / group): nothing is repeated in memory.  Folded
//     decode packs a KV head's group q-heads into the rows of one tile, so
//     the cache streams once per KV head.
// Not done yet here: fp8 tensor-core products on the 8-bit tiles themselves.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flash_fwd_sm90.cuh"
#include "kv_tiles.cuh"

namespace {

constexpr int kBlockM = 64;   // query rows per block (16 per warp)
constexpr int kThreads = 2 * kBlockM;  // two threads per query row
constexpr int kSCols = kBlockN / 2;    // score columns per thread
constexpr int kLdP = kBlockN + 8;
static_assert(kThreads == 2 * kBlockN, "half the threads load each scale row");
// What depends on the head dim D (64 or 128).  Shared-memory row pitches:
// padded to spread banks, and kept multiples of 16 bytes (vector copies)
// and of 32 bytes per 16 rows (WMMA pointers).
template <int D>
struct Dims {
  static constexpr int kOCols = D / 2;  // output columns per thread
  static constexpr int kLdT = D + 8;
  // The score buffer also holds the step's PV tile, [64][D].
  static constexpr int kLdS = (D > kBlockN ? D : kBlockN) + 4;
};
// Finite mask value (config.DEFAULT_MASK_VALUE): exp2(mask - mask) is never
// NaN, and visibility is tested explicitly, so masked entries add nothing.
constexpr float kMaskValue = -0.7f * FLT_MAX;

template <typename T, int D>
struct Smem {
  T q[kBlockM * Dims<D>::kLdT];
  T k[kBlockN * Dims<D>::kLdT];
  T v[kBlockN * Dims<D>::kLdT];
  T p[kBlockM * kLdP];               // probabilities times s_v, in q's type for PV
  float s[kBlockM * Dims<D>::kLdS];  // scores, then the PV product of the step
  float sk[kBlockN];                 // the step's K and V scales (8-bit caches)
  float sv[kBlockN];
  int kseg[kBlockN];                 // the step's KV segment ids
};

// Copy `kRows` rows of D elements (row pitch D in global memory) into
// shared memory with pitch kLdT; rows >= rows_valid are zero.
template <typename T, int kRows, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows_valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Dims<D>::kLdT + c) = val;
  }
}

// Two floats as the bits of two packed bf16 (a in the low half).
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

// Widen one 16-byte chunk of 8-bit elements to T and store it to shared
// memory 16 bytes at a time (the values never leave registers on the way).
template <typename T, typename KV>
__device__ __forceinline__ void widen_store(T* dst, uint4 raw) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  float f[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = widen<KV>((words[j / 4] >> (8 * (j % 4))) & 0xffu);
  uint4* out = reinterpret_cast<uint4*>(dst);
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      out[w] = make_uint4(pack_bf16x2(f[8 * w], f[8 * w + 1]), pack_bf16x2(f[8 * w + 2], f[8 * w + 3]),
                          pack_bf16x2(f[8 * w + 4], f[8 * w + 5]),
                          pack_bf16x2(f[8 * w + 6], f[8 * w + 7]));
    }
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      out[w] = make_uint4(__float_as_uint(f[4 * w]), __float_as_uint(f[4 * w + 1]),
                          __float_as_uint(f[4 * w + 2]), __float_as_uint(f[4 * w + 3]));
    }
  }
}

// One KV step's K and V tiles (and an 8-bit cache's scales) held in
// registers.  The kernel fetches a step's tiles while the step before it
// computes, so each step's global loads overlap the products instead of
// stalling them.  Each thread holds kChunks 16-byte chunks of each tile;
// rows >= rows_valid are zero.
template <typename T, typename KV, int D>
struct KvRegs {
  static constexpr bool kScaled = !std::is_same<KV, T>::value;
  using Stored = typename std::conditional<kScaled, uint8_t, T>::type;
  static constexpr int kVecElems = 16 / (int)sizeof(Stored);
  static constexpr int kVecPerRow = D / kVecElems;
  static constexpr int kLdT = Dims<D>::kLdT;
  static constexpr int kChunks = kBlockN * kVecPerRow / kThreads;
  static_assert(kChunks * kThreads == kBlockN * kVecPerRow, "whole chunks per thread");
  uint4 k[kChunks];
  uint4 v[kChunks];
  // Thread t < kBlockN: the K scale of row t; else the V scale of row t - kBlockN.
  float scale;

  __device__ __forceinline__ void fetch(const KvArgs& kv, size_t row0, int rows_valid) {
    const Stored* kb = static_cast<const Stored*>(kv.k) + row0 * D;
    const Stored* vb = static_cast<const Stored*>(kv.v) + row0 * D;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kVecPerRow;
      const int c = (idx % kVecPerRow) * kVecElems;
      k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid) {
        k[i] = *reinterpret_cast<const uint4*>(kb + (size_t)r * D + c);
        v[i] = *reinterpret_cast<const uint4*>(vb + (size_t)r * D + c);
      }
    }
    if constexpr (kScaled) {
      const int c = threadIdx.x % kBlockN;
      const float* scales = threadIdx.x < kBlockN ? kv.k_scale : kv.v_scale;
      scale = c < rows_valid ? scales[row0 + c] : 0.0f;
    }
  }

  // Write the tiles to shared memory, widening 8-bit ones to T.
  __device__ __forceinline__ void stash(Smem<T, D>& sm) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kVecPerRow;
      const int c = (idx % kVecPerRow) * kVecElems;
      if constexpr (kScaled) {
        widen_store<T, KV>(sm.k + r * kLdT + c, k[i]);
        widen_store<T, KV>(sm.v + r * kLdT + c, v[i]);
      } else {
        *reinterpret_cast<uint4*>(sm.k + r * kLdT + c) = k[i];
        *reinterpret_cast<uint4*>(sm.v + r * kLdT + c) = v[i];
      }
    }
    if constexpr (kScaled) (threadIdx.x < kBlockN ? sm.sk : sm.sv)[threadIdx.x % kBlockN] = scale;
  }
};

// s[16 warp rows][kBlockN] = Q K^T on the tensor cores.
template <int D>
__device__ __forceinline__ void qk_bf16(Smem<bf16, D>& sm, int warp) {
  using namespace nvcuda;
  constexpr int kLdT = Dims<D>::kLdT, kLdS = Dims<D>::kLdS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBlockN / 16];
#pragma unroll
  for (int n = 0; n < kBlockN / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sm.q + warp * 16 * kLdT + kk, kLdT);
#pragma unroll
    for (int n = 0; n < kBlockN / 16; ++n) {
      // K^T as a column-major B operand: element (d, c) sits at k[c][d].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, sm.k + n * 16 * kLdT + kk, kLdT);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBlockN / 16; ++n) {
    wmma::store_matrix_sync(sm.s + warp * 16 * kLdS + n * 16, acc[n], kLdS,
                            wmma::mem_row_major);
  }
}

// s[16 warp rows][D] = P V on the tensor cores.
template <int D>
__device__ __forceinline__ void pv_bf16(Smem<bf16, D>& sm, int warp) {
  using namespace nvcuda;
  constexpr int kLdT = Dims<D>::kLdT, kLdS = Dims<D>::kLdS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kBlockN; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sm.p + warp * 16 * kLdP + kk, kLdP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, sm.v + kk * kLdT + n * 16, kLdT);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(sm.s + warp * 16 * kLdS + n * 16, acc[n], kLdS,
                            wmma::mem_row_major);
  }
}

// fp32 products in IEEE FMA: each thread computes its own row's half.
template <int D>
__device__ __forceinline__ void qk_f32(Smem<float, D>& sm, int r, int half) {
  constexpr int kLdT = Dims<D>::kLdT, kLdS = Dims<D>::kLdS;
  float acc[kSCols];
#pragma unroll
  for (int j = 0; j < kSCols; ++j) acc[j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float qv = sm.q[r * kLdT + d];
#pragma unroll
    for (int j = 0; j < kSCols; ++j) {
      acc[j] = fmaf(qv, sm.k[(half * kSCols + j) * kLdT + d], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kSCols; ++j) sm.s[r * kLdS + half * kSCols + j] = acc[j];
}

template <int D>
__device__ __forceinline__ void pv_f32(Smem<float, D>& sm, int r, int half) {
  constexpr int kLdT = Dims<D>::kLdT, kLdS = Dims<D>::kLdS, kOCols = Dims<D>::kOCols;
  float acc[kOCols];
#pragma unroll
  for (int j = 0; j < kOCols; ++j) acc[j] = 0.0f;
  for (int c = 0; c < kBlockN; ++c) {
    const float pv = sm.p[r * kLdP + c];
#pragma unroll
    for (int j = 0; j < kOCols; ++j) {
      acc[j] = fmaf(pv, sm.v[c * kLdT + half * kOCols + j], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kOCols; ++j) sm.s[r * kLdS + half * kOCols + j] = acc[j];
}

// T: q's type (bf16 or fp32).  KV: the cache's element type, T itself for a
// bf16 / fp32 cache, int8_t / E4M3 / E5M2 for an 8-bit one (with scales).
// D: the head dim.  kFeat: the window and segment ids of f are read;
// without it the kernel holds no feature state.  kXf (with kFeat): the
// score transforms of f too (xf.cuh; tanhf for fp32 q), the bias measured
// from r / pos_div + the batch's offset, also when not causal.  kDrop (with
// kXf, a dense cache, pos_div 1): f's attention dropout (dropout.cuh), P
// times its keep factor in the PV product, the row sum of the undropped P.
// kPos (with kXf, a dense cache, causal, pos_div 1): f.kv_pos, the rolling
// cache's positions: every tile walked, each step's positions in kseg.
// kPosSeg (with kPos, an unscaled cache): f's segment ids too, each step's
// KV ids in kBlockN ints past Smem (kids), so kPos alone keeps its layout.
template <typename T, typename KV, bool kPaged, int D, bool kFeat, bool kXf, bool kDrop = false,
          bool kPos = false, bool kPosSeg = false>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, KvArgs kv,
                    const int* __restrict__ q_offset, T* __restrict__ o,
                    float* __restrict__ lse, int n_heads, int n_kv_heads,
                    int n_q, float scale_log2, int causal, int pos_div,
                    int fixed_offset, Feat f) {
  static_assert(!kPos || (kXf && !kPaged && !kDrop), "positions ride the transformed dense walk");
  constexpr bool kScaled = !std::is_same<KV, T>::value;
  static_assert(!kPosSeg || (kPos && !kScaled), "segment ids ride the dense position walk");
  constexpr int kLdS = Dims<D>::kLdS, kOCols = Dims<D>::kOCols;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T, D>& sm = *reinterpret_cast<Smem<T, D>*>(smem_raw);
  int* kids = reinterpret_cast<int*>(smem_raw + sizeof(Smem<T, D>));  // kPosSeg only

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r = tid >> 1;    // this thread's row of the tile
  const int half = tid & 1;  // which half of the row's columns it owns
  const int q_start = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int h_kv = h / (n_heads / n_kv_heads);
  const size_t q_rows = ((size_t)b * n_heads + h) * n_q;  // row index base
  const int n_kv = kv.n_kv;

  const int rows_valid = min(kBlockM, n_q - q_start);
  const bool warp_active = warp * 16 < rows_valid;
  // q_offset null: one int offset for every batch (the fp32 lean forward).
  const int off = !causal ? 0 : q_offset != nullptr ? q_offset[b] : fixed_offset;
  const int row = q_start + r;
  // Last column this thread's row may see (-1: none), and its window's first.
  int col_limit = -1;
  if (r < rows_valid) {
    // Under kPos a bound on the slots' positions, which run past n_kv.
    col_limit = kPos ? row + off : causal ? min(n_kv - 1, row / pos_div + off) : n_kv - 1;
  }
  const int col_lo = kFeat ? row / pos_div + off - f.window + 1 : 0;
  XfHead xf;
  int xpos = 0;  // the row's position for the bias
  if constexpr (kXf) {
    xf = XfHead(f.softcap, f.slopes, h, scale_log2 / kLog2e);
    xpos = row / pos_div + (q_offset != nullptr ? q_offset[b] : fixed_offset);
  }
  const int my_seg =
      kFeat && f.q_seg != nullptr && r < rows_valid ? f.q_seg[(size_t)b * n_q + row] : 0;
  // The row's part of the dropout hash, for the whole walk.
  DropBlock drop;
  uint32_t drow = 0;
  if constexpr (kDrop) {
    drop = DropBlock(f.drop, b);
    drow = drop.row_hash(drop.head_hash(h), row);
  }
  // The tiles any row of the tile may see, up to the last row's diagonal
  // (under a window: the sink tiles, then the window's), so no page past
  // the tile's diagonal or before its window is ever read.
  TileRuns runs;
  if constexpr (kPos) {
    runs = {0, 0, 0, (n_kv + kBlockN - 1) / kBlockN};
  } else if constexpr (kFeat) {
    runs = causal ? kv_runs<kBlockN>(q_start / pos_div + off,
                                     (q_start + rows_valid - 1) / pos_div + off, n_kv, f.window,
                                     f.sinks)
                  : kv_runs<kBlockN>(0, n_kv - 1, n_kv, kNoWindow, 0);
  } else {
    int tile_limit = n_kv - 1;
    if (causal) tile_limit = min(tile_limit, (q_start + rows_valid - 1) / pos_div + off);
    const int n_tiles = tile_limit < 0 ? 0 : tile_limit / kBlockN + 1;
    runs = {0, 0, 0, n_tiles};
  }
  const int n_steps = runs.steps();

  // The first KV step's tiles are in flight while q is loaded.
  KvRegs<T, KV, D> regs;
  if (n_steps > 0) {
    const int first = runs.tile(0) * kBlockN;
    regs.fetch(kv, tile_row0<kPaged>(kv, b, h_kv, n_kv_heads, first), min(kBlockN, n_kv - first));
  }
  load_tile<T, kBlockM, D>(sm.q, q + (q_rows + q_start) * D, rows_valid);

  float o_acc[kOCols];
#pragma unroll
  for (int j = 0; j < kOCols; ++j) o_acc[j] = 0.0f;
  float m_i = -INFINITY;  // running max, log2 units
  float l_i = 0.0f;       // running sum of exp2(s - m_i)

  for (int step = 0; step < n_steps; ++step) {
    const int kv_start = runs.tile(step) * kBlockN;
    regs.stash(sm);
    // The step's KV ids (the softmax of the step before read them before
    // its last barrier).
    if (kFeat && !kPosSeg && f.kv_seg != nullptr && tid < kBlockN) {
      sm.kseg[tid] = kv_start + tid < n_kv ? f.kv_seg[(size_t)b * n_kv + kv_start + tid] : 0;
    }
    // Under kPos kseg holds the step's positions instead (-1 past n_kv).
    if (kPos && tid < kBlockN) {
      sm.kseg[tid] = kv_start + tid < n_kv ? f.kv_pos[(size_t)b * n_kv + kv_start + tid] : -1;
    }
    // Under kPosSeg the step's KV ids go to kids (0 past n_kv, hidden there
    // by the position -1).
    if (kPosSeg && tid < kBlockN) {
      kids[tid] = kv_start + tid < n_kv ? f.kv_seg[(size_t)b * n_kv + kv_start + tid] : 0;
    }
    __syncthreads();
    // The next step's tiles are in flight while this step computes.
    if (step + 1 < n_steps) {
      const int next = runs.tile(step + 1) * kBlockN;
      regs.fetch(kv, tile_row0<kPaged>(kv, b, h_kv, n_kv_heads, next), min(kBlockN, n_kv - next));
    }

    if constexpr (std::is_same<T, bf16>::value) {
      if (warp_active) qk_bf16(sm, warp);
    } else {
      qk_f32(sm, r, half);
    }
    __syncthreads();

    // Online softmax over this thread's half row; the pair of threads that
    // share a row are lanes 2i and 2i+1 of one warp.
    float s_reg[kSCols];
    bool seen[kSCols];
    float step_max = kMaskValue;
    const int c0 = half * kSCols;
#pragma unroll
    for (int j = 0; j < kSCols; ++j) {
      const int c = c0 + j;
      const int cc = kPos ? sm.kseg[c] : kv_start + c;  // the column's position
      seen[j] = cc <= col_limit;
      if constexpr (kPos) {
        seen[j] = seen[j] && cc >= 0 && (cc >= col_lo || cc < f.sinks);
        if constexpr (kPosSeg) seen[j] = seen[j] && kids[c] == my_seg;
      } else if constexpr (kFeat) {
        seen[j] = seen[j] && (cc >= col_lo || cc < f.sinks) &&
                  (f.kv_seg == nullptr || sm.kseg[c] == my_seg);
      }
      float x = kMaskValue;
      if (seen[j]) {
        const float k_scale = kScaled ? sm.sk[c] : 1.0f;
        if constexpr (kXf) {
          // s_reg keeps the capped score t; the max takes t + bias (xf.cuh).
          s_reg[j] = xf.capped<std::is_same<T, float>::value>(sm.s[r * kLdS + c] * k_scale);
          x = s_reg[j] + xf.bias((float)(cc - xpos));
        } else {
          x = sm.s[r * kLdS + c] * (k_scale * scale_log2);
        }
      }
      if constexpr (!kXf) s_reg[j] = x;
      step_max = fmaxf(step_max, x);
    }
    step_max = fmaxf(step_max, __shfl_xor_sync(0xffffffffu, step_max, 1));
    const float m_new = fmaxf(m_i, step_max);
    const float alpha = exp2f(m_i - m_new);  // 0 on the first step
    float row_sum = 0.0f;
    const uint32_t dat = kDrop ? drow + drop.col_term(kv_start + c0) : 0u;
#pragma unroll
    for (int j = 0; j < kSCols; ++j) {
      const int c = c0 + j;
      float p;
      if constexpr (kXf) {
        const int cc = kPos ? sm.kseg[c] : kv_start + c;
        p = seen[j] ? exp2f(xf.shifted(s_reg[j], (float)(cc - xpos), m_new)) : 0.0f;
      } else {
        p = seen[j] ? exp2f(s_reg[j] - m_new) : 0.0f;
      }
      row_sum += p;
      if constexpr (kDrop) p *= drop.keep(dat + (uint32_t)j * kMixA);
      // The V scale folds into P (quant.py:265-270).
      const float v_scale = kScaled ? sm.sv[c] : 1.0f;
      sm.p[r * kLdP + c] = from_float<T>(p * v_scale);
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    l_i = l_i * alpha + row_sum;
    m_i = m_new;
    __syncthreads();

    if constexpr (std::is_same<T, bf16>::value) {
      if (warp_active) pv_bf16(sm, warp);
    } else {
      pv_f32(sm, r, half);
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kOCols; ++j) {
      o_acc[j] = o_acc[j] * alpha + sm.s[r * kLdS + half * kOCols + j];
    }
    // The next step's stash writes k, v, sk and sv only; its first write
    // to s comes after the barrier that follows it.
  }

  if (r < rows_valid) {
    const float inv_l = l_i > 0.0f ? 1.0f / l_i : 0.0f;
    T* dst = o + (q_rows + row) * D + half * kOCols;
#pragma unroll
    for (int j = 0; j < kOCols; ++j) dst[j] = from_float<T>(o_acc[j] * inv_l);
    if (lse != nullptr && half == 0) {
      lse[q_rows + row] = l_i > 0.0f ? (m_i + log2f(l_i)) * kLn2 : -INFINITY;
    }
  }
}

// The split of a call: kv_chunk columns per split (a multiple of 64),
// part the partials' workspace and tickets one zeroed int32 per (q-head,
// batch), both needed only when the chunk leaves more than one split.
struct Split {
  int kv_chunk;
  void* part;
  void* tickets;
};

// No split: one chunk over the whole row.
Split whole_row(int n_kv) {
  return Split{(n_kv + kBlockN - 1) / kBlockN * kBlockN, nullptr, nullptr};
}

// Calls of n_q <= kDecodeRows rows run the decode grid and folded bf16
// calls the folded grid (split as `split` says); the others run one block
// per 64-row q tile and take no split.
// One block per 64-row q tile (the kernel that reads f with kFeat, its
// transforms with kXf, its dropout with kDrop, its positions with kPos,
// and with kPosSeg their segment ids).
template <typename T, typename KV, bool kPaged, int D, bool kFeat, bool kXf, bool kDrop = false,
          bool kPos = false, bool kPosSeg = false>
cudaError_t launch_tiles(const void* q, const KvArgs& kv, const void* q_offset, void* o,
                         void* lse, int batch, int n_heads, int n_kv_heads, int n_q,
                         float sm_scale, int causal, int pos_div, cudaStream_t stream,
                         int fixed_offset, const Feat& f) {
  const int smem = (int)(sizeof(Smem<T, D>) + (kPosSeg ? kBlockN * sizeof(int) : 0));
  // The dynamic shared-memory limit is raised once per kernel and device.
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, KV, kPaged, D, kFeat, kXf, kDrop, kPos, kPosSeg>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((n_q + kBlockM - 1) / kBlockM, n_heads, batch);
  flash_fwd_kernel<T, KV, kPaged, D, kFeat, kXf, kDrop, kPos, kPosSeg><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), kv, static_cast<const int*>(q_offset),
      static_cast<T*>(o), static_cast<float*>(lse), n_heads, n_kv_heads, n_q,
      sm_scale * kLog2e, causal, pos_div, fixed_offset, f);
  return cudaGetLastError();
}

// A cache's element type as the C entries code it: 0 in q's own type, 1
// int8, 2 e4m3, 3 e5m2.
template <typename KV>
constexpr int kv_code() {
  return std::is_same<KV, int8_t>::value ? 1
         : std::is_same<KV, E4M3>::value ? 2
         : std::is_same<KV, E5M2>::value ? 3
                                          : 0;
}

// Segment ids (f.q_seg) keep every call on the 64-row grid.
template <typename T, typename KV, bool kPaged, int D>
cudaError_t launch(const void* q, const KvArgs& kv, const void* q_offset,
                   void* o, void* lse, int batch, int n_heads, int n_kv_heads,
                   int n_q, float sm_scale, int causal, int pos_div, const Split& split,
                   cudaStream_t stream, int fixed_offset = 0, const Feat& f = Feat{}) {
  if (n_q <= kDecodeRows && f.q_seg == nullptr) {
    const fam::DecodeCall call{q, kv, static_cast<const int*>(q_offset), o,
                               static_cast<float*>(lse), batch, n_heads, n_kv_heads, n_q,
                               sm_scale, causal, pos_div, fixed_offset, split.kv_chunk,
                               static_cast<float*>(split.part), static_cast<int*>(split.tickets),
                               stream, f.window, f.sinks, f.softcap, f.slopes, f.kv_pos};
    constexpr int dtype = std::is_same<T, bf16>::value ? 0 : 1;
    if constexpr (std::is_same<KV, T>::value) {
      return fam::flash_decode_native(call, dtype, D, kPaged);
    } else if constexpr (std::is_same<KV, int8_t>::value) {
      return fam::flash_decode_int8(call, dtype, D, kPaged);
    } else if constexpr (std::is_same<KV, E4M3>::value) {
      return fam::flash_decode_e4m3(call, dtype, D, kPaged);
    } else {
      return fam::flash_decode_e5m2(call, dtype, D, kPaged);
    }
  }
  // bf16 prefill over an 8-bit or paged cache: the wgmma forward from its
  // KV source (flash_kv_sm90.cu), whatever the walk.
  if constexpr (std::is_same<T, bf16>::value && (kPaged || !std::is_same<KV, T>::value)) {
    if (pos_div == 1 && n_q > kDecodeRows && f.q_seg == nullptr && !f.drop.on()) {
      const fam::DecodeCall call{q, kv, static_cast<const int*>(q_offset), o,
                                 static_cast<float*>(lse), batch, n_heads, n_kv_heads, n_q,
                                 sm_scale, causal, pos_div, fixed_offset, split.kv_chunk,
                                 nullptr, nullptr, stream, f.window, f.sinks, f.softcap,
                                 f.slopes, f.kv_pos};
      return fam::flash_kv_sm90(call, kv_code<KV>(), D, kPaged);
    }
  }
  // bf16 calls folded by GQA of more than kDecodeRows rows (a verify
  // window), from every cache: the wgmma forward's split-KV folded grid
  // (flash_fold_sm90.cu).
  if constexpr (std::is_same<T, bf16>::value) {
    if (pos_div > 1 && n_q > kDecodeRows) {
      const fam::DecodeCall call{q, kv, static_cast<const int*>(q_offset), o,
                                 static_cast<float*>(lse), batch, n_heads, n_kv_heads, n_q,
                                 sm_scale, causal, pos_div, fixed_offset, split.kv_chunk,
                                 static_cast<float*>(split.part),
                                 static_cast<int*>(split.tickets), stream, f.window, f.sinks,
                                 f.softcap, f.slopes, f.kv_pos};
      return fam::flash_fold_sm90(call, kv_code<KV>(), D, kPaged);
    }
  }
  if (f.kv_pos != nullptr) {
    // bf16 prefill over a bf16 cache takes the wgmma position walk
    // (fam_flash_fwd), never this template.
    if constexpr (kPaged || (std::is_same<T, bf16>::value && std::is_same<KV, T>::value)) {
      return cudaErrorInvalidValue;
    } else {
      // fp32 with segment ids (fam_flash_fwd; the 8-bit entry takes none):
      // the segmented instance, at any n_q.
      if constexpr (std::is_same<KV, T>::value) {
        if (f.q_seg != nullptr) {
          return launch_tiles<T, KV, false, D, true, true, false, true, true>(
              q, kv, q_offset, o, lse, batch, n_heads, n_kv_heads, n_q, sm_scale, causal,
              pos_div, stream, fixed_offset, f);
        }
      }
      return launch_tiles<T, KV, false, D, true, true, false, true>(
          q, kv, q_offset, o, lse, batch, n_heads, n_kv_heads, n_q, sm_scale, causal, pos_div,
          stream, fixed_offset, f);
    }
  }
  if (f.xf()) {
    return launch_tiles<T, KV, kPaged, D, true, true>(q, kv, q_offset, o, lse, batch, n_heads,
                                                      n_kv_heads, n_q, sm_scale, causal, pos_div,
                                                      stream, fixed_offset, f);
  }
  if (f.window != kNoWindow || f.q_seg != nullptr) {
    return launch_tiles<T, KV, kPaged, D, true, false>(q, kv, q_offset, o, lse, batch, n_heads,
                                                       n_kv_heads, n_q, sm_scale, causal, pos_div,
                                                       stream, fixed_offset, f);
  }
  return launch_tiles<T, KV, kPaged, D, false, false>(q, kv, q_offset, o, lse, batch, n_heads,
                                                      n_kv_heads, n_q, sm_scale, causal, pos_div,
                                                      stream, fixed_offset, f);
}

// The 8-bit caches: dtype 0 = bf16 q, 1 = fp32 q; kv_dtype 1 = int8,
// 2 = float8_e4m3fn, 3 = float8_e5m2.
template <bool kPaged, int D>
cudaError_t launch_8bit(int dtype, int kv_dtype, const void* q, const KvArgs& kv,
                        const void* q_offset, void* o, void* lse, int batch,
                        int n_heads, int n_kv_heads, int n_q, float sm_scale,
                        int causal, int pos_div, const Split& split, cudaStream_t s,
                        const Feat& f) {
#define FAM_LAUNCH(T, KV)                                                             \
  return launch<T, KV, kPaged, D>(q, kv, q_offset, o, lse, batch, n_heads, n_kv_heads, \
                                  n_q, sm_scale, causal, pos_div, split, s, 0, f)
  if (dtype == 0 && kv_dtype == 1) FAM_LAUNCH(bf16, int8_t);
  if (dtype == 0 && kv_dtype == 2) FAM_LAUNCH(bf16, E4M3);
  if (dtype == 0 && kv_dtype == 3) FAM_LAUNCH(bf16, E5M2);
  if (dtype == 1 && kv_dtype == 1) FAM_LAUNCH(float, int8_t);
  if (dtype == 1 && kv_dtype == 2) FAM_LAUNCH(float, E4M3);
  if (dtype == 1 && kv_dtype == 3) FAM_LAUNCH(float, E5M2);
#undef FAM_LAUNCH
  return cudaErrorInvalidValue;
}

bool bad_shape(int batch, int n_heads, int n_kv_heads, int n_q, int pos_div) {
  return pos_div < 1 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 || batch < 1 || n_q < 1;
}

bool bad_head_dim(int head_dim) { return head_dim != 64 && head_dim != 128; }

bool bad_pages(int n_pages, int page_size, int max_pages) {
  return n_pages < 1 || max_pages < 1 || page_size < kBlockN || page_size % kBlockN != 0;
}

// A window needs causal (0: none); sinks are at least 0.
bool bad_window(int window, int sinks, int causal) {
  return window < 0 || sinks < 0 || (window > 0 && !causal);
}

// The score transforms: a cap of 0 (none) or more; slopes are one per
// q-head, so they take no row fold (pos_div 1), and the bias needs the
// offsets.
bool bad_xf(float softcap, const void* slopes, int pos_div, const void* q_offset) {
  return !(softcap >= 0.0f) || (slopes != nullptr && (pos_div != 1 || q_offset == nullptr));
}

Feat make_feat(int window, int sinks, const void* q_seg, const void* kv_seg, float softcap,
               const void* slopes, const Drop& drop = Drop{}) {
  return Feat{window_or_none(window), window > 0 ? sinks : 0, static_cast<const int*>(q_seg),
              static_cast<const int*>(kv_seg), softcap, static_cast<const float*>(slopes), drop};
}

// A rolling cache's positions (null: none) need causal and one row per
// position, and take no dropout (as JAX, flash_fwd.py:899-916); segment
// ids they take (flash_fwd.py:984-985; fam_flash_fwd only).
bool bad_pos(const void* kv_pos, int causal, int pos_div, const void* drop_seed) {
  return kv_pos != nullptr && (!causal || pos_div != 1 || drop_seed != nullptr);
}

// Dropout (seed null: none): a threshold in [0, 2^31), a keep factor of 1
// or more, the (b, h) stream's head count; one row per position (pos_div 1)
// and one KV split, as JAX (flash_fwd.py:905-929).
bool bad_drop(const void* seed, int threshold, float inv_keep, int heads, int pos_div,
              int kv_chunk, int n_kv) {
  return seed != nullptr &&
         (threshold < 0 || !(inv_keep >= 1.0f) || heads < 1 || pos_div != 1 || kv_chunk < n_kv);
}

Drop make_drop(const void* seed, int threshold, float inv_keep, int heads) {
  return Drop{static_cast<const int*>(seed), (uint32_t)threshold, inv_keep, heads};
}

// A chunk is a positive multiple of 64 columns; more than one split needs
// a decode tile or a folded bf16 call (dtype 0, pos_div > 1), the
// workspace and the tickets.
bool bad_split(int n_q, int n_kv, int dtype, int pos_div, const Split& split) {
  if (split.kv_chunk < kBlockN || split.kv_chunk % kBlockN != 0) return true;
  if (split.kv_chunk >= n_kv) return false;
  return (n_q > kDecodeRows && (dtype != 0 || pos_div < 2)) || split.part == nullptr ||
         split.tickets == nullptr;
}

}  // namespace

// C entry points, bound with ctypes (kernels/flash_fwd.py, kernels/quant.py,
// kernels/paged.py).  Pointers are device pointers of contiguous tensors;
// q and o are [B, H, N_q, D]; dtype is q's: 0 = bf16, 1 = fp32.  Each
// returns the launch's cudaError_t (0 on success).
//
// The split of every entry: kv_chunk, the KV columns of a split (a
// multiple of 64; n_splits = ceil(n_kv / kv_chunk), n_kv the dense
// length or max_pages * page_size); more than one split only for n_q <= 16
// or a folded bf16 call (pos_div > 1), with part, fp32 [B * H * n_splits *
// n_q * (D + 2)], and tickets, int32 [B * H * ceil(n_q / 64)] (n_q <= 16:
// [B * H]) all zero (each call leaves them zero again).
//
// The window of every entry: window, the columns a row sees back from its
// position (0: no window; more needs causal), and sinks, the first columns
// every row sees besides (read only with a window).  The score transforms
// of every entry (xf.cuh): softcap, 0 for none; slopes, fp32 [H] ALiBi
// slopes of the q-heads or null (pos_div 1 only, and q_offset or lengths
// given: the bias measures each row's position from them; the quant entry
// also needs causal, as the JAX kernel does).

// Dense cache in q's type: k, v [B, H_kv, N, D], D = head_dim 64 or 128;
// q_offset int32 [B] (read only when causal); lse fp32 [B, H, N_q] or null;
// q_seg, kv_seg int32 [B, N_q] and [B, N_kv], or both null (segment ids:
// pos_div 1 and one split).  drop_seed: int32 [5] on the device, the packed
// seed and offsets of attention dropout (dropout.cuh), or null for none;
// drop_threshold, drop_inv_keep: min(round(rate 2^31), 2^31 - 1) and the
// fp32 of 1 / (1 - rate); drop_heads: the (b, h) stream's head count
// (dropout: pos_div 1 and one split).  kv_pos: a rolling cache's int32
// [B, N_kv] positions, or null (bad_pos).  bf16 with pos_div == 1 and
// n_q > 16, or with segment ids or dropout, runs the wgmma kernel
// (flash_fwd_sm90.cuh; with kv_pos its position walk, segmented with
// segment ids); fp32 with kv_pos and segment ids the template's segmented
// kPos instance, at any n_q.
extern "C" int fam_flash_fwd(const void* q, const void* k, const void* v,
                             const void* q_offset, void* o, void* lse,
                             int batch, int n_heads, int n_kv_heads, int n_q,
                             int n_kv, int head_dim, float sm_scale,
                             int causal, int pos_div, int dtype, int window, int sinks,
                             const void* q_seg, const void* kv_seg, float softcap,
                             const void* slopes, const void* drop_seed, int drop_threshold,
                             float drop_inv_keep, int drop_heads, const void* kv_pos,
                             int kv_chunk, void* part, void* tickets, void* stream) {
  const Split split{kv_chunk, part, tickets};
  const bool seg = q_seg != nullptr;
  const bool drop = drop_seed != nullptr;
  if (bad_shape(batch, n_heads, n_kv_heads, n_q, pos_div) || bad_head_dim(head_dim) ||
      n_kv < 1 || bad_split(n_q, n_kv, dtype, pos_div, split) ||
      bad_window(window, sinks, causal) ||
      seg != (kv_seg != nullptr) || (seg && (pos_div != 1 || kv_chunk < n_kv)) ||
      bad_xf(softcap, slopes, pos_div, q_offset) ||
      bad_drop(drop_seed, drop_threshold, drop_inv_keep, drop_heads, pos_div, kv_chunk, n_kv) ||
      bad_pos(kv_pos, causal, pos_div, drop_seed)) {
    return (int)cudaErrorInvalidValue;
  }
  Feat f = make_feat(window, sinks, q_seg, kv_seg, softcap, slopes,
                     make_drop(drop_seed, drop_threshold, drop_inv_keep, drop_heads));
  f.kv_pos = static_cast<const int*>(kv_pos);
  const KvArgs kv{k, v, nullptr, nullptr, nullptr, n_kv, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(q_offset);
  // A rolling cache's bf16 prefill chunks: the wgmma kernel's position walk;
  // with segment ids its segmented walk, at any n_q (the decode grid takes
  // no segment ids).
  if (kv_pos != nullptr && dtype == 0 && (n_q > kDecodeRows || seg)) {
    return (int)(head_dim == 64
                     ? sm90::launch_fwd_pos<64>(q, k, v, off, o, lse, batch, n_heads, n_kv_heads,
                                                n_q, n_kv, sm_scale, f, s)
                     : sm90::launch_fwd_pos<128>(q, k, v, off, o, lse, batch, n_heads,
                                                 n_kv_heads, n_q, n_kv, sm_scale, f, s));
  }
  // Segment ids and dropout take the wgmma kernel at any n_q; a window,
  // segment ids, the score transforms or dropout take its featured walks,
  // the rest the causal walk as before.
  const bool wgmma =
      dtype == 0 && pos_div == 1 && (n_q > kDecodeRows || seg || drop) && kv_pos == nullptr;
  const bool featured = seg || f.window != kNoWindow || f.xf() || drop;
  if (wgmma && featured) {
    return (int)(head_dim == 64
                     ? sm90::launch_fwd_feat<64>(q, k, v, off, o, lse, batch, n_heads, n_kv_heads,
                                                 n_q, n_kv, sm_scale, causal, f, s)
                     : sm90::launch_fwd_feat<128>(q, k, v, off, o, lse, batch, n_heads,
                                                  n_kv_heads, n_q, n_kv, sm_scale, causal, f, s));
  }
  // fp32 dropout: the template's dropout walk, one block per 64-row q
  // tile at any n_q (never the decode grid).
  if (drop && dtype == 1) {
    return (int)(head_dim == 64
                     ? launch_tiles<float, float, false, 64, true, true, true>(
                           q, kv, q_offset, o, lse, batch, n_heads, n_kv_heads, n_q, sm_scale,
                           causal, 1, s, 0, f)
                     : launch_tiles<float, float, false, 128, true, true, true>(
                           q, kv, q_offset, o, lse, batch, n_heads, n_kv_heads, n_q, sm_scale,
                           causal, 1, s, 0, f));
  }
  if (dtype == 0 && pos_div == 1 && n_q > kDecodeRows && head_dim == 64 && kv_pos == nullptr) {
    return (int)sm90::launch_fwd<64>(q, k, v, off, 0, o, lse, batch, n_heads, n_kv_heads, n_q,
                                     n_kv, sm_scale, causal, s);
  }
  if (dtype == 0 && pos_div == 1 && n_q > kDecodeRows && head_dim == 128 && kv_pos == nullptr) {
    return (int)sm90::launch_fwd<128>(q, k, v, off, 0, o, lse, batch, n_heads, n_kv_heads, n_q,
                                      n_kv, sm_scale, causal, s);
  }
#define FAM_LAUNCH(T, D)                                                                 \
  return (int)launch<T, T, false, D>(q, kv, q_offset, o, lse, batch, n_heads, n_kv_heads, \
                                     n_q, sm_scale, causal, pos_div, split, s, 0, f)
  if (dtype == 0 && head_dim == 64) FAM_LAUNCH(bf16, 64);
  if (dtype == 0 && head_dim == 128) FAM_LAUNCH(bf16, 128);
  if (dtype == 1 && head_dim == 64) FAM_LAUNCH(float, 64);
  if (dtype == 1 && head_dim == 128) FAM_LAUNCH(float, 128);
#undef FAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The fp32 lean and triangular forward (the entries of flash_lean.cu and
// flash_tri.cu): the dense fp32 template with one int causal offset,
// q_offset, for every batch, unsplit.
namespace fam {
cudaError_t flash_lean_fp32(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch, int n_heads, int n_kv_heads, int n_q, int n_kv,
                            int head_dim, float sm_scale, int causal, int q_offset,
                            cudaStream_t stream) {
  const KvArgs kv{k, v, nullptr, nullptr, nullptr, n_kv, 0, 0, 0};
  if (head_dim == 64) {
    return launch<float, float, false, 64>(q, kv, nullptr, o, lse, batch, n_heads, n_kv_heads,
                                           n_q, sm_scale, causal, 1, whole_row(n_kv), stream,
                                           q_offset);
  }
  return launch<float, float, false, 128>(q, kv, nullptr, o, lse, batch, n_heads, n_kv_heads,
                                          n_q, sm_scale, causal, 1, whole_row(n_kv), stream,
                                          q_offset);
}
}  // namespace fam

// Dense 8-bit cache: k_q, v_q [B, H_kv, N, D] int8 / fp8; k_scale, v_scale
// fp32 [B, H_kv, N]; q_offset int32 [B] (read only when causal); lse fp32
// [B, H, N_q] or null; kv_pos a rolling cache's int32 [B, N] positions or
// null (causal, pos_div 1).  This entry and the two paged ones run n_q <= 16
// on the decode grid, bf16 with pos_div 1 on the wgmma forward
// (flash_kv_sm90.cu), folded bf16 on its folded grid (flash_fold_sm90.cu),
// fp32 on the template (launch).
extern "C" int fam_flash_quant(const void* q, const void* k_q, const void* v_q,
                               const void* k_scale, const void* v_scale,
                               const void* q_offset, void* o, void* lse,
                               int batch, int n_heads, int n_kv_heads, int n_q,
                               int n_kv, int head_dim, float sm_scale,
                               int causal, int pos_div, int dtype,
                               int kv_dtype, int window, int sinks, float softcap,
                               const void* slopes, const void* kv_pos, int kv_chunk, void* part,
                               void* tickets, void* stream) {
  const Split split{kv_chunk, part, tickets};
  if (bad_shape(batch, n_heads, n_kv_heads, n_q, pos_div) || bad_head_dim(head_dim) ||
      n_kv < 1 || bad_split(n_q, n_kv, dtype, pos_div, split) ||
      bad_window(window, sinks, causal) ||
      bad_xf(softcap, slopes, pos_div, q_offset) || (slopes != nullptr && !causal) ||
      bad_pos(kv_pos, causal, pos_div, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Feat f = make_feat(window, sinks, nullptr, nullptr, softcap, slopes);
  f.kv_pos = static_cast<const int*>(kv_pos);
  const KvArgs kv{k_q, v_q, static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale), nullptr, n_kv, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(head_dim == 64
                   ? launch_8bit<false, 64>(dtype, kv_dtype, q, kv, q_offset, o, lse, batch,
                                            n_heads, n_kv_heads, n_q, sm_scale, causal,
                                            pos_div, split, s, f)
                   : launch_8bit<false, 128>(dtype, kv_dtype, q, kv, q_offset, o, lse, batch,
                                             n_heads, n_kv_heads, n_q, sm_scale, causal,
                                             pos_div, split, s, f));
}

// bf16 / fp32 page pool: pool_k, pool_v [n_pages, H_kv, page_size, D] in
// q's type; table int32 [B, max_pages]; lengths int32 [B] (the causal
// offset).  page_size is a multiple of 64.
extern "C" int fam_flash_paged(const void* q, const void* pool_k,
                               const void* pool_v, const void* table,
                               const void* lengths, void* o, int batch,
                               int n_heads, int n_kv_heads, int n_q,
                               int n_pages, int page_size, int max_pages,
                               int head_dim, float sm_scale, int pos_div,
                               int dtype, int window, int sinks, float softcap,
                               const void* slopes, int kv_chunk, void* part, void* tickets,
                               void* stream) {
  const Split split{kv_chunk, part, tickets};
  if (bad_shape(batch, n_heads, n_kv_heads, n_q, pos_div) || bad_head_dim(head_dim) ||
      bad_pages(n_pages, page_size, max_pages) ||
      bad_split(n_q, max_pages * page_size, dtype, pos_div, split) ||
      bad_window(window, sinks, 1) ||
      bad_xf(softcap, slopes, pos_div, lengths)) {
    return (int)cudaErrorInvalidValue;
  }
  const Feat f = make_feat(window, sinks, nullptr, nullptr, softcap, slopes);
  const KvArgs kv{pool_k, pool_v, nullptr, nullptr, static_cast<const int*>(table),
                  max_pages * page_size, page_size, max_pages, n_pages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FAM_LAUNCH(T, D)                                                                  \
  return (int)launch<T, T, true, D>(q, kv, lengths, o, nullptr, batch, n_heads, n_kv_heads, \
                                    n_q, sm_scale, 1, pos_div, split, s, 0, f)
  if (dtype == 0 && head_dim == 64) FAM_LAUNCH(bf16, 64);
  if (dtype == 0 && head_dim == 128) FAM_LAUNCH(bf16, 128);
  if (dtype == 1 && head_dim == 64) FAM_LAUNCH(float, 64);
  if (dtype == 1 && head_dim == 128) FAM_LAUNCH(float, 128);
#undef FAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// 8-bit page pool: pool_k_q, pool_v_q [n_pages, H_kv, page_size, D] int8 /
// fp8; pool_k_scale, pool_v_scale fp32 [n_pages, H_kv, page_size]; table
// and lengths as fam_flash_paged.
extern "C" int fam_flash_paged_quant(const void* q, const void* pool_k_q,
                                     const void* pool_v_q,
                                     const void* pool_k_scale,
                                     const void* pool_v_scale,
                                     const void* table, const void* lengths,
                                     void* o, int batch, int n_heads,
                                     int n_kv_heads, int n_q, int n_pages,
                                     int page_size, int max_pages, int head_dim,
                                     float sm_scale, int pos_div, int dtype,
                                     int kv_dtype, int window, int sinks, float softcap,
                                     const void* slopes, int kv_chunk, void* part,
                                     void* tickets, void* stream) {
  const Split split{kv_chunk, part, tickets};
  if (bad_shape(batch, n_heads, n_kv_heads, n_q, pos_div) || bad_head_dim(head_dim) ||
      bad_pages(n_pages, page_size, max_pages) ||
      bad_split(n_q, max_pages * page_size, dtype, pos_div, split) ||
      bad_window(window, sinks, 1) ||
      bad_xf(softcap, slopes, pos_div, lengths)) {
    return (int)cudaErrorInvalidValue;
  }
  const Feat f = make_feat(window, sinks, nullptr, nullptr, softcap, slopes);
  const KvArgs kv{pool_k_q, pool_v_q, static_cast<const float*>(pool_k_scale),
                  static_cast<const float*>(pool_v_scale),
                  static_cast<const int*>(table), max_pages * page_size,
                  page_size, max_pages, n_pages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(head_dim == 64
                   ? launch_8bit<true, 64>(dtype, kv_dtype, q, kv, lengths, o, nullptr, batch,
                                           n_heads, n_kv_heads, n_q, sm_scale, 1, pos_div,
                                           split, s, f)
                   : launch_8bit<true, 128>(dtype, kv_dtype, q, kv, lengths, o, nullptr, batch,
                                            n_heads, n_kv_heads, n_q, sm_scale, 1, pos_div,
                                            split, s, f));
}
