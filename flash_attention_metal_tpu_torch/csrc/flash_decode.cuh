// The split-KV decode grid of the forward kernels over a KV cache: calls
// of n_q <= kDecodeRows = 16 query rows (a token, or a KV head's group of
// q-heads folded into rows) of the C entries of flash_fwd.cu, which
// replace flash_attention_metal_tpu/kernels/flash_fwd.py::_fwd_kernel
// (folded decode), quant.py::_quant_fwd_kernel, paged.py::
// flash_attention_paged and flash_attention_paged_quant.  Contract and
// arithmetic: flash_fwd.cu's header.
//
// What bounds it on the H100: each visible K/V row is read once, 68 bytes
// (int8 / fp8 with its scales) or 128 bytes (bf16) a row at D = 64 for 4 *
// group flops: HBM bytes (3.35 TB/s), and at the serving shape (8 slots,
// 8 KV heads) a few microseconds in all, so what counts is how many SMs
// the grid keeps reading and how long its slowest block runs.
//
// What the design does about it.
//   * Grid (split, q-head, batch).  Split s walks KV columns [s * kv_chunk,
//     (s + 1) * kv_chunk), kv_chunk a multiple of 64 that the caller picks
//     from static shapes alone (kernels/flash_fwd.py::decode_kv_chunk, never
//     from the slots' lengths: a device tensor), so one long slot no longer
//     sets the step's time and the grid fills the SMs.  A split whose chunk
//     starts past the diagonal reads no K/V row and no table entry: it
//     writes an empty partial (m = -inf, l = 0, o = 0).
//   * Under a sliding window a split walks only its tiles among the sink
//     tiles and the window's (window.cuh, kv_runs over the rows'
//     positions): a split wholly outside both is empty in the same way, and
//     the merge weighs it 0.  The score transforms (xf.cuh) act on each
//     score before the split's softmax; they take the windowed kernel.
//   * A rolling cache (kPos: kv_pos int32 [B, n_kv], the position each slot
//     holds, -1 for none; replaces the kv_positions input of flash_fwd.py::
//     _fwd_kernel and quant.py::_quant_fwd_kernel) masks in position space:
//     slot j is visible to row r when 0 <= pos <= r + off and, under the
//     window, pos > r + off - window or pos < sinks; ALiBi's distance is
//     pos - (r + off).  After a wrap slot order is not position order, so a
//     kPos split walks every tile of its chunk, skips nothing by index, and
//     a chunk of slots never written is an empty partial (m = -inf, l = 0).
//     Each lane reads its column's position once a step (one int-to-float
//     conversion a step for the bias); one kPos instance per (q type, KV
//     type, head dim, rows) reads the window, sinks, cap and slopes at run
//     time.
//   * In a block the 4 warps each take 16 columns of every 64-row KV tile
//     for all query rows at once, two lanes a column (one half of D each),
//     on the CUDA cores in fp32 FMA: the 64-row wgmma tile would carry 62
//     rows of padding at group 2, and 4 * group flops per 68-128 bytes is
//     far below the tensor cores' line.  Each warp keeps its own online
//     softmax; the four merge in shared memory at the end.
//   * K/V tiles land by cp.async in a 3-stage ring as they are stored (an
//     8-bit tile at half a bf16 tile's bytes), one barrier a tile; an 8-bit
//     element is widened from shared memory into the product's registers.
//   * The splits' partials (fp32 o, m, l) go to a workspace from torch's
//     caching allocator; the last block of a (q-head, batch) to arrive,
//     told by a ticket it resets itself (atom.acq_rel after a barrier, as
//     dq_ordered.cuh's turns), merges them in split order: one launch, the
//     same bits on every run (split_merge.cuh, which the wgmma forward's
//     folded grid shares).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "kv_tiles.cuh"
#include "sm90_tiles.cuh"
#include "split_merge.cuh"

namespace {

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kWarpCols = kBlockN / kDecWarps;  // columns of each KV tile a warp owns
constexpr int kDecStages = 3;              // the K/V ring
static_assert(kDecThreads == 2 * kBlockN, "half the threads copy each scale row");

// Shared-memory layout of a decode block, in bytes: the ring's stages (K
// tile, V tile, and an 8-bit cache's K and V scales), q in fp32 as two
// halves of D, and each warp's P for its columns.  Row pitches are the
// stored row plus 16 bytes, so the 16-byte reads of 8 consecutive rows
// (one per lane of a phase) fall on 8 different bank groups.
template <typename T, typename KV, int D, int kRows>
struct Decode {
  static constexpr bool kScaled = !std::is_same<KV, T>::value;
  using Stored = typename std::conditional<kScaled, uint8_t, T>::type;
  static constexpr int kRowBytes = D * (int)sizeof(Stored);
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte copies per row
  static constexpr int kTileBytes = kBlockN * kPitch;
  static constexpr int kStageBytes = 2 * kTileBytes + (kScaled ? 2 * kBlockN * 4 : 0);
  static constexpr int kRingBytes = kDecStages * kStageBytes;
  static constexpr int kHalf = D / 2;          // elements of a lane's half row
  static constexpr int kQPitch = kHalf + 4;    // floats between q's half rows
  static constexpr int kQBytes = kRows * 2 * kQPitch * 4;
  static constexpr int kPBytes = kDecWarps * kRows * kWarpCols * 4;
  static constexpr int kSmem = kRingBytes + kQBytes + kPBytes;
  static constexpr int kE = D / 32;            // output columns per lane
  // After the KV walk the ring holds the warps' states: o [warps][rows][D],
  // m and l [warps][rows].
  static_assert(kDecWarps * kRows * (D + 2) * 4 <= kRingBytes, "the warps' merge fits the ring");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 64-row K/V tile (and its scales) into a ring stage, by cp.async;
// rows >= rows_valid are zero.
template <typename T, typename KV, int D, int kRows>
__device__ __forceinline__ void decode_load(unsigned char* stage, const KvArgs& kv, size_t row0,
                                            int rows_valid) {
  using P = Decode<T, KV, D, kRows>;
  const unsigned char* kb = static_cast<const unsigned char*>(kv.k) + row0 * P::kRowBytes;
  const unsigned char* vb = static_cast<const unsigned char*>(kv.v) + row0 * P::kRowBytes;
  for (int i = threadIdx.x; i < kBlockN * P::kChunks; i += kDecThreads) {
    const int r = i / P::kChunks;
    const int at = (i % P::kChunks) * 16;
    const bool ok = r < rows_valid;
    const size_t src = ok ? (size_t)r * P::kRowBytes + at : 0;
    sm90::cp_async16(stage + r * P::kPitch + at, kb + src, ok);
    sm90::cp_async16(stage + P::kTileBytes + r * P::kPitch + at, vb + src, ok);
  }
  if constexpr (P::kScaled) {
    // Threads 0-63 copy the K scales, 64-127 the V scales.
    const int c = threadIdx.x % kBlockN;
    const float* src = threadIdx.x < kBlockN ? kv.k_scale : kv.v_scale;
    float* dst = reinterpret_cast<float*>(stage + 2 * P::kTileBytes) + threadIdx.x;
    sm90::cp_async4(dst, src + row0 + (c < rows_valid ? c : 0), c < rows_valid);
  }
}

// N consecutive stored elements at p (N * sizeof(Stored) bytes, aligned to
// that), widened exactly to fp32: int8 and fp8 values fit bf16, and bf16
// fits fp32.
template <typename KV, typename Stored, int N>
__device__ __forceinline__ void load_widen(float (&out)[N], const unsigned char* p) {
  constexpr int kBytes = N * (int)sizeof(Stored);
  uint32_t w[(kBytes + 3) / 4];
  if constexpr (kBytes == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else if constexpr (kBytes == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (kBytes == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    static_assert(kBytes == 16, "2, 4, 8 or 16 bytes");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<Stored, float>::value) {
      out[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<Stored, bf16>::value) {
      out[i] = __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
    } else {
      out[i] = widen<KV>((w[i / 4] >> (8 * (i % 4))) & 0xffu);
    }
  }
}

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<bf16>(bf16 x) { return __bfloat162float(x); }

// T: q's type; KV: the cache's element type (T itself, or int8_t / E4M3 /
// E5M2 with scales); D: the head dim; kRows: the tile's rows (>= n_q).
// Grid (n_splits, n_heads, batch), kDecThreads threads.  With one split
// the block writes o (and lse); with more it writes its partial to `part`
// and the last block of its (q-head, batch) merges them.  kWin: the window
// (window, sinks) is read; without it the kernel holds no window state.
// kXf (with kWin, whose window may be kNoWindow): the score transforms
// (xf.cuh) too, the bias measured from r / pos_div + the batch's offset
// (callers fold no rows under ALiBi: a folded row is not one q-head).
// kPos (with kWin and kXf, a dense cache, causal, pos_div 1): the rolling
// cache's position map kv_pos [B, n_kv] (see the header).
template <typename T, typename KV, bool kPaged, int D, int kRows, bool kWin, bool kXf,
          bool kPos = false>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_kernel(const T* __restrict__ q, KvArgs kv, const int* __restrict__ q_offset,
                        T* __restrict__ o, float* __restrict__ lse, int n_heads, int n_kv_heads,
                        int n_q, float scale_log2, int causal, int pos_div, int fixed_offset,
                        int kv_chunk, float* __restrict__ part, int* __restrict__ tickets,
                        int window, int sinks, float softcap, const float* __restrict__ slopes,
                        const int* __restrict__ kv_pos) {
  static_assert(!kPos || (kWin && kXf && !kPaged), "positions ride the transformed dense walk");
  using P = Decode<T, KV, D, kRows>;
  using Stored = typename P::Stored;
  constexpr bool kScaled = P::kScaled;
  constexpr int kE = P::kE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw + P::kRingBytes);
  float* ps = reinterpret_cast<float*>(smem_raw + P::kRingBytes + P::kQBytes);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col = lane % kWarpCols;  // this lane's column of its warp's 16
  const int half = lane / kWarpCols;  // and which half of D it multiplies
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int h_kv = h / (n_heads / n_kv_heads);
  const int unit = b * n_heads + h;
  const size_t q_rows = (size_t)unit * n_q;
  const int n_kv = kv.n_kv;
  // q_offset null: one int offset for every batch (the fp32 lean forward).
  const int off = !causal ? 0 : q_offset != nullptr ? q_offset[b] : fixed_offset;
  XfHead xf;
  int xoff = 0;  // the offset the bias measures rows from
  float rpos[kXf ? kRows : 1];  // each row's r / pos_div, as a float (kXf)
  if constexpr (kXf) {
    xf = XfHead(softcap, slopes, h, scale_log2 / kLog2e);
    xoff = q_offset != nullptr ? q_offset[b] : fixed_offset;
#pragma unroll
    for (int r = 0; r < kRows; ++r) rpos[r] = (float)(r / pos_div);
  }

  // Last column each row sees (-1: none, and for rows past n_q), and under
  // a window the first column of its window; under kPos the same bounds on
  // the positions the slots hold (not clamped to n_kv: positions run past
  // the cache's capacity).
  int lim[kRows], lo[kWin ? kRows : 1];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if constexpr (kPos) {
      lim[r] = r >= n_q ? -1 : r + off;
    } else {
      lim[r] = r >= n_q ? -1 : causal ? min(n_kv - 1, r / pos_div + off) : n_kv - 1;
    }
    if constexpr (kWin) lo[r] = r / pos_div + off - window + 1;
  }
  // Under kPos every tile of the chunk: no skip by slot index.
  const int tile_limit =
      kPos ? n_kv - 1 : causal ? min(n_kv - 1, (n_q - 1) / pos_div + off) : n_kv - 1;
  // This split's columns: [kv_begin, kv_end).  A chunk that starts past the
  // diagonal is empty: no K/V row, no table entry is read.  Under a window
  // the split walks only its tiles among the sink tiles and the window's
  // (runs): a chunk wholly outside both is empty too.
  const int kv_begin = split * kv_chunk;
  const int kv_end = min(kv_begin + kv_chunk, tile_limit + 1);
  TileRuns runs{};
  if constexpr (kWin && !kPos) {
    // Not causal (the transforms' kernel, no window): every column.
    runs = kv_runs<kBlockN>(off, kXf && !causal ? n_kv - 1 : (n_q - 1) / pos_div + off, n_kv,
                            window, sinks)
               .within(kv_begin / kBlockN, (kv_begin + kv_chunk) / kBlockN);
  }
  const int n_steps = kv_begin >= kv_end ? 0 :
                      kWin && !kPos ? runs.steps() : (kv_end - kv_begin - 1) / kBlockN + 1;
  // Step s's first column.
  auto step_start = [&](int s) {
    return kWin && !kPos ? runs.tile(s) * kBlockN : kv_begin + s * kBlockN;
  };

  auto load = [&](int step) {
    const int kv_start = step_start(step);
    decode_load<T, KV, D, kRows>(smem_raw + (step % kDecStages) * P::kStageBytes, kv,
                                 tile_row0<kPaged>(kv, b, h_kv, n_kv_heads, kv_start),
                                 min(kBlockN, n_kv - kv_start));
  };
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < n_steps) load(s);
    sm90::cp_async_commit();
  }
  for (int i = tid; i < kRows * D; i += kDecThreads) {
    const int r = i / D, d = i % D;
    qs[(2 * r + d / P::kHalf) * P::kQPitch + d % P::kHalf] =
        r < n_q ? to_float<T>(q[(q_rows + r) * D + d]) : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kE];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;  // running max, log2 units
    l[r] = 0.0f;       // this lane's share of the running sum (half 0 lanes)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[r][e] = 0.0f;
  }
  float* pw = ps + warp * kRows * kWarpCols;  // this warp's P [rows][16]
  const int c = warp * kWarpCols + col;       // this lane's column of each tile

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();
    // The stage refilled here was read in the step before the barrier.
    if (step + kDecStages - 1 < n_steps) load(step + kDecStages - 1);
    sm90::cp_async_commit();
    const unsigned char* stage = smem_raw + (step % kDecStages) * P::kStageBytes;
    const int kv_start = step_start(step);
    // The position slot c of this tile holds (kPos; -1 past n_kv), read
    // here so that its load overlaps the scores.
    int pc = -1;
    if constexpr (kPos) {
      if (kv_start + c < n_kv) pc = kv_pos[(size_t)b * n_kv + kv_start + c];
    }

    // Scores of column c: this lane's half of D, then the other lane's.
    constexpr int kVec = 16 / (int)sizeof(Stored);
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const unsigned char* krow = stage + c * P::kPitch + half * P::kHalf * (int)sizeof(Stored);
    const float* qh = qs + half * P::kQPitch;
#pragma unroll
    for (int j = 0; j < P::kHalf; j += kVec) {
      float kf[kVec];
      load_widen<KV, Stored, kVec>(kf, krow + j * (int)sizeof(Stored));
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qh + 2 * r * P::kQPitch + j + e);
          s[r] = fmaf(qv.x, kf[e], s[r]);
          s[r] = fmaf(qv.y, kf[e + 1], s[r]);
          s[r] = fmaf(qv.z, kf[e + 2], s[r]);
          s[r] = fmaf(qv.w, kf[e + 3], s[r]);
        }
      }
    }
    const float* scales = reinterpret_cast<const float*>(stage + 2 * P::kTileBytes);
    const float k_scale = kScaled ? scales[c] : 1.0f;
    // The V scale folds into P (quant.py:265-270).
    const float v_scale = kScaled ? scales[kBlockN + c] : 1.0f;

    // Online softmax over the warp's 16 columns, row by row.
    float alpha[kRows];
    // The column's position (its slot's under kPos), and c - xoff.
    const int cpos = kPos ? pc : kv_start + c;
    const float cbase = kXf ? (float)(cpos - xoff) : 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], kWarpCols);
      bool visible = cpos <= lim[r];
      if constexpr (kPos) visible = visible && cpos >= 0;
      if constexpr (kWin) visible = visible && (cpos >= lo[r] || cpos < sinks);
      float x = -INFINITY;
      float t = 0.0f, dist = 0.0f;  // the capped score and the distance (kXf)
      if constexpr (kXf) {
        if (visible) {
          t = xf.capped<std::is_same<T, float>::value>(s[r] * k_scale);
          dist = cbase - rpos[r];
          x = t + xf.bias(dist);  // the max's; P takes xf.shifted (xf.cuh)
        }
      } else {
        x = visible ? s[r] * (k_scale * scale_log2) : -INFINITY;
      }
      float step_max = x;
#pragma unroll
      for (int w = 1; w < kWarpCols; w *= 2) {
        step_max = fmaxf(step_max, __shfl_xor_sync(0xffffffffu, step_max, w));
      }
      const float m_new = fmaxf(m[r], step_max);
      alpha[r] = m[r] == -INFINITY ? 0.0f : exp2f(m[r] - m_new);
      float p;
      if constexpr (kXf) {
        p = visible ? exp2f(xf.shifted(t, dist, m_new)) : 0.0f;
      } else {
        p = visible ? exp2f(x - m_new) : 0.0f;
      }
      l[r] = l[r] * alpha[r] + (half == 0 ? p : 0.0f);
      m[r] = m_new;
      if (half == 0) pw[r * kWarpCols + col] = to_float<T>(from_float<T>(p * v_scale));
    }
    __syncwarp();

    // o[r][lane's kE columns] += P[r][16 columns] V[16 columns][...].
    const unsigned char* vt = stage + P::kTileBytes + warp * kWarpCols * P::kPitch +
                              lane * kE * (int)sizeof(Stored);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[r][e] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kWarpCols; j += 4) {
      float vf[4][kE];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_widen<KV, Stored, kE>(vf[i], vt + (j + i) * P::kPitch);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(pw + r * kWarpCols + j);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          acc[r][e] = fmaf(pr.x, vf[0][e], acc[r][e]);
          acc[r][e] = fmaf(pr.y, vf[1][e], acc[r][e]);
          acc[r][e] = fmaf(pr.z, vf[2][e], acc[r][e]);
          acc[r][e] = fmaf(pr.w, vf[3][e], acc[r][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now

  // The block's state: the warps' merged in warp order.  A state with
  // m = -inf (no column seen) weighs 0.
  float* wo = reinterpret_cast<float*>(smem_raw);  // [warps][kRows][D]
  float* wm = wo + kDecWarps * kRows * D;           // [warps][kRows]
  float* wl = wm + kDecWarps * kRows;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int w = 1; w < 32; w *= 2) l[r] += __shfl_xor_sync(0xffffffffu, l[r], w);
#pragma unroll
    for (int e = 0; e < kE; ++e) wo[(warp * kRows + r) * D + lane * kE + e] = acc[r][e];
    if (lane == 0) {
      wm[warp * kRows + r] = m[r];
      wl[warp * kRows + r] = l[r];
    }
  }
  __syncthreads();

  // Partial p of this unit (row r of split s): at (unit * n_splits + s) *
  // n_q + r; o at part[p * D], m and l after all the o rows.
  const size_t n_part = (size_t)gridDim.z * n_heads * n_splits * n_q;
  float* part_m = part + n_part * D;
  float* part_l = part_m + n_part;
  for (int i = tid; i < n_q * D; i += kDecThreads) {
    const int r = i / D, d = i % D;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mb = fmaxf(mb, wm[w * kRows + r]);
    float ob = 0.0f, lb = 0.0f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float mw = wm[w * kRows + r];
      const float weight = mw == -INFINITY ? 0.0f : exp2f(mw - mb);
      ob += weight * wo[(w * kRows + r) * D + d];
      lb += weight * wl[w * kRows + r];
    }
    if (n_splits == 1) {
      const float inv_l = lb > 0.0f ? 1.0f / lb : 0.0f;
      o[(q_rows + r) * D + d] = from_float<T>(ob * inv_l);
      if (lse != nullptr && d == 0) {
        lse[q_rows + r] = lb > 0.0f ? (mb + log2f(lb)) * kLn2 : -INFINITY;
      }
    } else {
      const size_t p = ((size_t)unit * n_splits + split) * n_q + r;
      part[p * D + d] = ob;
      if (d == 0) {
        part_m[p] = mb;
        part_l[p] = lb;
      }
    }
  }
  if (n_splits == 1) return;

  // The last block of this unit to arrive merges every split's partial
  // (split_merge.cuh).
  if (!split_merge::last_to_arrive(tickets + unit, n_splits)) return;
  split_merge::merge_rows<D, kDecThreads>(part, n_part, unit, n_splits, n_q, 0, n_q, o, lse,
                                          q_rows, tickets + unit);
}

template <typename T, typename KV, bool kPaged, int D, int kRows, bool kWin, bool kXf,
          bool kPos = false>
cudaError_t launch_decode_rows(const void* q, const KvArgs& kv, const void* q_offset, void* o,
                               void* lse, int batch, int n_heads, int n_kv_heads, int n_q,
                               float sm_scale, int causal, int pos_div, int fixed_offset,
                               int kv_chunk, void* part, void* tickets, cudaStream_t stream,
                               int window, int sinks, float softcap, const float* slopes,
                               const int* kv_pos = nullptr) {
  constexpr int smem = Decode<T, KV, D, kRows>::kSmem;
  using Kernel = decltype(&flash_decode_kernel<T, KV, kPaged, D, kRows, kWin, kXf, kPos>);
  const Kernel kernel = flash_decode_kernel<T, KV, kPaged, D, kRows, kWin, kXf, kPos>;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((kv.n_kv + kv_chunk - 1) / kv_chunk, n_heads, batch);
  kernel<<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), kv, static_cast<const int*>(q_offset), static_cast<T*>(o),
      static_cast<float*>(lse), n_heads, n_kv_heads, n_q, sm_scale * kLog2e, causal, pos_div,
      fixed_offset, kv_chunk, static_cast<float*>(part), static_cast<int*>(tickets), window,
      sinks, softcap, slopes, kv_pos);
  return cudaGetLastError();
}

// Tag of a cache in q's own type (no scales).
struct Native {};
template <typename T, typename Tag>
using KvType = typename std::conditional<std::is_same<Tag, Native>::value, T, Tag>::type;

template <typename T, typename KV, bool kPaged, int D, bool kWin, bool kXf, bool kPos = false>
cudaError_t launch_decode_win(const fam::DecodeCall& c) {
  if (c.n_q <= 4) {
    return launch_decode_rows<T, KV, kPaged, D, 4, kWin, kXf, kPos>(
        c.q, c.kv, c.q_offset, c.o, c.lse, c.batch, c.n_heads, c.n_kv_heads, c.n_q, c.sm_scale,
        c.causal, c.pos_div, c.fixed_offset, c.kv_chunk, c.part, c.tickets, c.stream, c.window,
        c.sinks, c.softcap, c.slopes, c.kv_pos);
  }
  return launch_decode_rows<T, KV, kPaged, D, kDecodeRows, kWin, kXf, kPos>(
      c.q, c.kv, c.q_offset, c.o, c.lse, c.batch, c.n_heads, c.n_kv_heads, c.n_q, c.sm_scale,
      c.causal, c.pos_div, c.fixed_offset, c.kv_chunk, c.part, c.tickets, c.stream, c.window,
      c.sinks, c.softcap, c.slopes, c.kv_pos);
}

// A call under a window takes the kernel that reads it; under the score
// transforms, the windowed kernel that also takes them (any window); a
// rolling cache's position map (dense caches only), the kPos kernel that
// reads all of them.
template <typename T, typename KV, bool kPaged, int D>
cudaError_t launch_decode(const fam::DecodeCall& c) {
  if (c.kv_pos != nullptr) {
    if constexpr (kPaged) {
      return cudaErrorInvalidValue;
    } else {
      return launch_decode_win<T, KV, false, D, true, true, true>(c);
    }
  }
  if (c.softcap > 0.0f || c.slopes != nullptr) {
    return launch_decode_win<T, KV, kPaged, D, true, true>(c);
  }
  if (c.window != kNoWindow) return launch_decode_win<T, KV, kPaged, D, true, false>(c);
  return launch_decode_win<T, KV, kPaged, D, false, false>(c);
}

// Every instance for one KV element type (Native: q's own type).
template <typename Tag>
cudaError_t decode_for(const fam::DecodeCall& c, int dtype, int head_dim, bool paged) {
  if (c.n_q > kDecodeRows) return cudaErrorInvalidValue;
#define FAM_DECODE(T, P, D)                                                 \
  if (dtype == (std::is_same<T, bf16>::value ? 0 : 1) && paged == P && head_dim == D) \
  return launch_decode<T, KvType<T, Tag>, P, D>(c)
  FAM_DECODE(bf16, false, 64);
  FAM_DECODE(bf16, false, 128);
  FAM_DECODE(bf16, true, 64);
  FAM_DECODE(bf16, true, 128);
  FAM_DECODE(float, false, 64);
  FAM_DECODE(float, false, 128);
  FAM_DECODE(float, true, 64);
  FAM_DECODE(float, true, 128);
#undef FAM_DECODE
  return cudaErrorInvalidValue;
}

}  // namespace
