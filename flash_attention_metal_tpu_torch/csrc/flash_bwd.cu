// Backward flash attention for Hopper (sm_90a), bf16 and fp32, head dim 64
// or 128: dK/dV and dQ (the split pair), and the fused 5-matmul backward.
//
// Replaces the FA-2 split pair of flash_attention_metal_tpu/kernels/
// flash_bwd.py: _dkv_kernel (dK, dV over KV tiles) and _dq_kernel (dQ over
// Q tiles), which the training step reaches through flash_attention_bwd; and
// _fused_bwd_kernel (flash_attention_bwd_fused), which the backward router
// takes where the autotuner's saved decision names it (the triangular
// backward's entry, flash_tri.cu, launches the fused kernels too: bf16
// through the header, fp32 through fam_flash_bwd_fused).  bf16 runs the
// Hopper kernels: the split pair of flash_bwd_sm90.cuh and the fused kernel
// of flash_bwd_fused_sm90.cuh (wgmma with register A operands, a cp.async
// ring).  fp32 (and fp16, which the wrapper runs in fp32) runs the FMA
// template below.
//
// Contract, for every batch b, q-head h (KV head h / group), query row r and
// key column c, with row r seeing c when c < n_kv and, when causal,
// c <= r + q_offset[b] (q_offset int32 [B] on the device):
//   P[r,c]  = exp(sm_scale * q[r] . k[c] - lse[r])   (lse: the forward's
//             natural-log row logsumexp; -inf rows take a large finite
//             sentinel, so their P, and every gradient they feed, is 0)
//   dV[c]   = sum_{h in group} sum_r P[r,c] dO[r]
//   dP[r,c] = dO[r] . v[c]
//   dS[r,c] = P[r,c] (dP[r,c] - delta[r])   (delta = rowsum(dO o O) - dlse,
//             computed by the wrapper)
//   dK[c]   = sm_scale * sum_{h in group} sum_r dS[r,c] q[r]
//   dQ[r]   = sm_scale * sum_c dS[r,c] k[c]
// Under a sliding window (with causal) row r at position p = r + q_offset[b]
// sees only c > p - window, besides c < sinks, and with segment ids only
// columns of its own id (window.cuh); the walks skip the tiles outside the
// window and the sinks.  Under the score transforms (xf.cuh) the score in P
// is capped and biased as the forward's, dS is the cotangent of the
// transformed score, d_slopes[h] sums dS * (c - p) over the pairs (the
// dK/dV kernel, a partial per batch, q-head, KV tile and warp), and dS then
// takes the softcap's chain 1 - tanh^2 before dK and dQ.  Under attention
// dropout (dropout.cuh; the split pair only, as JAX routes it) each pair's
// keep factor K[r,c] in {0, 1 / (1 - rate)} is rebuilt from the seed and
// (q-head, r, c): dV sums (P o K)^T dO and dS = P (dP K - delta).
// Products and sums accumulate in fp32; P and dS enter the bf16 products
// rounded to bf16 (the JAX kernels do the same).  fp32 inputs use plain
// IEEE FMA (never TF32).  dK and dV come out in k's dtype, dQ in q's.
//
// GQA is native: one dK/dV block per (KV tile, KV head, batch) loops over
// the group's q-heads and sums them in its fp32 accumulators before the one
// store, and the dQ kernel reads KV head h / group.  Nothing is repeated in
// memory.  The JAX package instead repeats K/V to every q-head and sums the
// per-head dK/dV after rounding them to bf16; the fp32 group sum here is the
// more exact of the two.
//
// Deterministic: each dK/dV and split-pair dQ tile has exactly one owner
// block and its sums run in a fixed order.  The fused backward's dQ is one
// fp32 accumulator that the KV tiles' blocks add to in KV-tile order,
// ordered by a counter per 32 query rows (dq_ordered.cuh): the same bits on
// every run, with no unordered atomics.  Its only workspace is that
// accumulator and the counters, O(B H N D), where the first design wrote an
// N^2 slot per visible tile pair and reduced them in a second kernel.
//
// The fp32 template: the split pair's dQ kernel and the dK/dV kernel (with
// the fused dQ when kFused) on the CUDA cores in IEEE FMA (wmma_tiles.cuh's
// tile helpers):
//   * Causal block skipping in both kernels: a dK/dV block walks only the Q
//     tiles whose last row sees its first column, and a dQ block stops at
//     the last KV tile its last row sees.  Skipped tiles are neither loaded
//     nor computed.
//   * K and V (dK/dV) or Q, dO, lse and delta (dQ) load once per block and
//     stay in shared memory; dK/dV and dQ live in registers for the whole
//     walk.  P and dS are written over the scores they come from (the fp32
//     tiles at D = 128 would not fit 227 KB otherwise).
//   * Every product goes through shared memory and a 64 x 64 tile pair
//     costs five barriers: the reason bf16 left this template.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dq_ordered.cuh"
#include "flash_bwd_fused_sm90.cuh"
#include "flash_bwd_sm90.cuh"
#include "window.cuh"
#include "wmma_tiles.cuh"

namespace {

static_assert(kTile % dq_ordered::kRows == 0, "a Q tile owns whole dQ counters");
using dq_ordered::batch_offset;
using dq_ordered::last_visible;

// fp32.  One block per (KV tile, KV head, batch): dK and dV of the tile,
// summed over the group's q-heads and their visible Q tiles.  kFused:
// the block takes its (KV tile, batch x KV head) item from the ticket in
// counters[0] instead, walks its Q tiles from the last one down, and adds
// each visible pair's dQ contribution to dq_acc in KV-tile order
// (dq_ordered.cuh), the last KV tile writing dq: each Q tile's adders are
// the KV tiles of its walk (window.cuh, kv_runs), in that order.
// q_offset: per-batch offsets read no higher than off_bound; null:
// off_bound for every batch.  f: the window and the segment ids.  kXf (not
// with kFused): f's score transforms too (xf.cuh), the bias measured from
// r + pos[b], and d_slopes partials into dslope (fp32 [B, H, n_kv_tiles,
// kXfWarps], or null).  kDrop (with kXf, not kFused): f's attention dropout.
template <typename T, int D, bool kFused, bool kXf = false, bool kDrop = false>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ q_offset, int off_bound, T* __restrict__ dk,
                         T* __restrict__ dv, T* __restrict__ dq, float* __restrict__ dq_acc,
                         int* __restrict__ counters, int batch, int n_heads, int n_kv_heads,
                         int n_q, int n_kv, float sm_scale, float scale_log2, Feat f,
                         const int* __restrict__ pos = nullptr, float* __restrict__ dslope = nullptr) {
  static_assert(!(kFused && kXf), "the fused backward takes no score transforms");
  static_assert(!(kFused && kDrop), "the fused backward takes no dropout (JAX: the split pair)");
  using C = Cfg<T, D>;
  static_assert(std::is_same<T, float>::value,
                "bf16 runs flash_bwd_sm90.cuh and flash_bwd_fused_sm90.cuh");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem<T, D>& sm = *reinterpret_cast<BwdSmem<T, D>*>(smem_raw);
  T* p = sm.p_tile();
  T* ds = sm.ds_tile();

  const int tid = threadIdx.x;
  const int r = tid >> 1;    // tile row: a Q row in the walk, a KV row at the store
  const int half = tid & 1;  // which half of the row's columns it owns
  int kv_tile = blockIdx.x, h_kv = blockIdx.y, b = blockIdx.z;
  if constexpr (kFused) {
    const int ticket = dq_ordered::claim(counters);
    kv_tile = ticket / (batch * n_kv_heads);
    h_kv = ticket % (batch * n_kv_heads) % n_kv_heads;
    b = ticket % (batch * n_kv_heads) / n_kv_heads;
  }
  const int kv_start = kv_tile * kTile;
  const int group = n_heads / n_kv_heads;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;
  const int cols_valid = min(kTile, n_kv - kv_start);
  const int off = batch_offset(q_offset, b, off_bound);
  // Rows r >= kv_start - off see the tile's first column; earlier Q tiles
  // see none of it and are skipped, and so are the Q tiles past the last
  // whose window reaches the tile.
  const int q_first = max(0, kv_start - off) / kTile;
  const int q_stop = q_end<kTile>(kv_start, kv_start + cols_valid - 1, off, n_q, f.window, f.sinks);

  if (kFused && kv_tile == 0) {
    // The Q tiles that see no column: no block adds to them.
    for (int qt = 0; qt * kTile < n_q; ++qt) {
      const int q_start = qt * kTile;
      const int rows = min(kTile, n_q - q_start);
      if (kv_runs<kTile>(q_start + off, q_start + rows - 1 + off, n_kv, f.window, f.sinks)
              .steps() > 0) {
        continue;
      }
      for (int g = 0; g < group; ++g) {
        T* dst = dq + (((size_t)b * n_heads + h_kv * group + g) * n_q + q_start) * D;
        for (int i = tid; i < rows * D; i += kThreads) dst[i] = from_float<T>(0.0f);
      }
    }
  }

  // The tile's KV segment ids, and the walked rows' (null: none).
  __shared__ int kv_ids[kTile];
  const int* kids = f.kv_seg == nullptr ? nullptr : kv_ids;
  if (kids != nullptr && tid < kTile) {
    kv_ids[tid] = tid < cols_valid ? f.kv_seg[(size_t)b * n_kv + kv_start + tid] : 0;
  }
  load_tile<T, D>(sm.k, k + (kv_rows + kv_start) * D, cols_valid);
  load_tile<T, D>(sm.v, v + (kv_rows + kv_start) * D, cols_valid);

  float dk_reg[C::kOut], dv_reg[C::kOut];
#pragma unroll
  for (int j = 0; j < C::kOut; ++j) dk_reg[j] = dv_reg[j] = 0.0f;
  DropBlock drop;
  if constexpr (kDrop) drop = DropBlock(f.drop, b);

  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)b * n_heads + h_kv * group + g;
    const size_t q_rows = bh * n_q;
    XfHead xf;
    double dsl = 0.0;  // this thread's share of the head's d_slopes partial
    if constexpr (kXf) xf = XfHead(f.softcap, f.slopes, h_kv * group + g, sm_scale);
    uint32_t dhead = 0;
    if constexpr (kDrop) dhead = drop.head_hash(h_kv * group + g);
    for (int step = 0; step < q_stop - q_first; ++step) {
      const int qt = kFused ? q_stop - 1 - step : q_first + step;
      const int q_start = qt * kTile;
      const int rows_valid = min(kTile, n_q - q_start);
      load_tile<T, D>(sm.q, q + (q_rows + q_start) * D, rows_valid);
      load_tile<T, D>(sm.dout, dout + (q_rows + q_start) * D, rows_valid);
      load_rows(sm, lse + q_rows + q_start, delta + q_rows + q_start, rows_valid);
      __syncthreads();

      bwd_scores(sm, r, half);
      __syncthreads();

      const int qid =
          kids != nullptr && r < rows_valid ? f.q_seg[(size_t)b * n_q + q_start + r] : 0;
      uint32_t dat = 0;  // the row's dropout hash plus column kv_start's term
      if constexpr (kDrop) dat = drop.row_hash(dhead, q_start + r) + drop.col_term(kv_start);
      softmax_grad<T, D, kXf, kDrop>(sm, r, half, kv_start,
                                     last_visible(q_start + r, n_q, n_kv, off), scale_log2,
                                     q_start + r + off - f.window + 1, f.sinks, qid, kids, xf,
                                     kXf ? q_start + r + pos[b] : 0, &dsl, drop, dat);
      __syncthreads();

      mma_atb_f32<D>(dv_reg, p, sm.dout, r, half);
      mma_atb_f32<D>(dk_reg, ds, sm.q, r, half);
      if constexpr (kFused) {
        // The Q tile's adders, in order: its walk's KV tiles.  Row kv_start
        // - off can fall past a ragged last Q tile's valid rows: that tile
        // sees nothing of this KV tile, which is then no adder.
        const TileRuns adders = kv_runs<kTile>(q_start + off, q_start + rows_valid - 1 + off,
                                               n_kv, f.window, f.sinks);
        const int rank = adders.rank(kv_tile);
        const int last = adders.steps() - 1;
        if (rank >= 0) {
          float dq_reg[C::kOut];
#pragma unroll
          for (int j = 0; j < C::kOut; ++j) dq_reg[j] = 0.0f;
          mma_ab_f32<D>(dq_reg, ds, sm.k, r, half);
          int* cnt = dq_ordered::counter(counters, bh, n_q, q_start);
          dq_ordered::wait_turn(cnt, rank);
          if (r < rows_valid) {
            const size_t at = (q_rows + q_start + r) * D + half * C::kOut;
#pragma unroll
            for (int j = 0; j < C::kOut; ++j) {
              dq_ordered::add(dq_acc, dq, at + j, dq_reg[j], rank, last, sm_scale);
            }
          }
          __syncthreads();
          dq_ordered::pass_turn(cnt, rank);
        }
      }
      // The next tile's loads overwrite q, dout, lse2 and delta.
      __syncthreads();
    }
    if constexpr (kXf) {
      if (dslope != nullptr) {
        xf_warp_store(dsl, dslope + ((bh * gridDim.x + kv_tile) * kXfWarps + (tid >> 5)));
      }
    }
  }

  if (r < cols_valid) {
    const size_t at = (kv_rows + kv_start + r) * D + half * C::kOut;
#pragma unroll
    for (int j = 0; j < C::kOut; ++j) {
      dk[at + j] = from_float<T>(dk_reg[j] * sm_scale);
      dv[at + j] = from_float<T>(dv_reg[j]);
    }
  }
}

// The fp32 split pair's dQ: one block per (Q tile, q-head, batch), dQ of the
// tile over its visible KV tiles.  kXf: f's score transforms, the bias
// measured from r + pos[b]; kDrop (with kXf): f's attention dropout.
template <int D, bool kXf = false, bool kDrop = false>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ q_offset, int off_bound,
                            float* __restrict__ dq, int n_heads, int n_kv_heads, int n_q,
                            int n_kv, float sm_scale, float scale_log2, Feat f,
                            const int* __restrict__ pos = nullptr) {
  using C = Cfg<float, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem<float, D>& sm = *reinterpret_cast<BwdSmem<float, D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int q_start = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int h_kv = h / (n_heads / n_kv_heads);
  const size_t q_rows = ((size_t)b * n_heads + h) * n_q;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;
  const int rows_valid = min(kTile, n_q - q_start);
  const int off = batch_offset(q_offset, b, off_bound);
  const int col_limit = last_visible(q_start + r, n_q, n_kv, off);
  // The KV walk: the sink tiles, then the window's up to the last tile any
  // row of the tile sees (every tile up to it without a window).
  const TileRuns runs = kv_runs<kTile>(q_start + off, q_start + rows_valid - 1 + off, n_kv,
                                       f.window, f.sinks);
  const int n_steps = runs.steps();
  // The step's KV segment ids, and this row's (null: none).
  __shared__ int kv_ids[kTile];
  const int* kids = f.kv_seg == nullptr ? nullptr : kv_ids;
  const int qid = kids != nullptr && r < rows_valid ? f.q_seg[(size_t)b * n_q + q_start + r] : 0;

  load_tile<float, D>(sm.q, q + (q_rows + q_start) * D, rows_valid);
  load_tile<float, D>(sm.dout, dout + (q_rows + q_start) * D, rows_valid);
  load_rows(sm, lse + q_rows + q_start, delta + q_rows + q_start, rows_valid);

  float dq_reg[C::kOut];
#pragma unroll
  for (int j = 0; j < C::kOut; ++j) dq_reg[j] = 0.0f;
  XfHead xf;
  double dsl = 0.0;  // d_slopes is dK/dV's: unused here
  if constexpr (kXf) xf = XfHead(f.softcap, f.slopes, h, sm_scale);
  // The row's part of the dropout hash, for the whole walk.
  DropBlock drop;
  uint32_t drow = 0;
  if constexpr (kDrop) {
    drop = DropBlock(f.drop, b);
    drow = drop.row_hash(drop.head_hash(h), q_start + r);
  }

  for (int step = 0; step < n_steps; ++step) {
    const int kv_start = runs.tile(step) * kTile;
    const int cols_valid = min(kTile, n_kv - kv_start);
    load_tile<float, D>(sm.k, k + (kv_rows + kv_start) * D, cols_valid);
    load_tile<float, D>(sm.v, v + (kv_rows + kv_start) * D, cols_valid);
    if (kids != nullptr && tid < kTile) {
      kv_ids[tid] = tid < cols_valid ? f.kv_seg[(size_t)b * n_kv + kv_start + tid] : 0;
    }
    __syncthreads();

    bwd_scores(sm, r, half);
    __syncthreads();

    // P and dS over the scores and dP.
    softmax_grad<float, D, kXf, kDrop>(sm, r, half, kv_start, col_limit, scale_log2,
                                       q_start + r + off - f.window + 1, f.sinks, qid, kids, xf,
                                       kXf ? q_start + r + pos[b] : 0, &dsl, drop,
                                       kDrop ? drow + drop.col_term(kv_start) : 0u);
    __syncthreads();

    mma_ab_f32<D>(dq_reg, sm.ds_tile(), sm.k, r, half);
    // The next step's loads overwrite k and v.
    __syncthreads();
  }

  if (r < rows_valid) {
    const size_t at = (q_rows + q_start + r) * D + half * C::kOut;
#pragma unroll
    for (int j = 0; j < C::kOut; ++j) dq[at + j] = dq_reg[j] * sm_scale;
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *q_offset;
  int batch, n_heads, n_kv_heads, n_q, n_kv, causal;
  float sm_scale;
  cudaStream_t stream;
  Feat f;
  float* dslope = nullptr;  // d_slopes partials (dK/dV under ALiBi), or null
  // The offsets the ALiBi bias measures rows from (also when not causal).
  const int* pos() const { return static_cast<const int*>(q_offset); }
  // The kernels' offsets: q_offset read no higher than off_bound when
  // causal, else n_kv - 1 (every column) with no read.  The split pair's
  // bound is n_kv - 1, which sees what any higher offset sees, unless a
  // window moves with the offset: then none.
  const int* offsets() const {
    return causal ? static_cast<const int*>(q_offset) : nullptr;
  }
  int bound(int off_bound) const { return causal ? off_bound : n_kv - 1; }
  int split_bound() const { return f.window == kNoWindow ? n_kv - 1 : INT_MAX; }
};

// The dK/dV kernel; kFused (fp32) also adds dQ to dq_acc in KV-tile order
// and writes dq (one block per work item of the ticket in counters[0]);
// kXf: the score transforms and d_slopes; kDrop: dropout.
template <typename T, int D, bool kFused, bool kXf = false, bool kDrop = false>
cudaError_t launch_dkv(const Args& a, int off_bound, void* dk, void* dv, void* dq = nullptr,
                       float* dq_acc = nullptr, int* counters = nullptr) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(BwdSmem<T, D>);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D, kFused, kXf, kDrop>, smem, done);
  if (err != cudaSuccess) return err;
  const int kv_tiles = (a.n_kv + kTile - 1) / kTile;
  const dim3 grid = kFused ? dim3(kv_tiles * a.n_kv_heads * a.batch)
                           : dim3(kv_tiles, a.n_kv_heads, a.batch);
  flash_bwd_dkv_kernel<T, D, kFused, kXf, kDrop><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      a.offsets(), a.bound(off_bound), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dq), dq_acc, counters, a.batch, a.n_heads, a.n_kv_heads, a.n_q,
      a.n_kv, a.sm_scale, a.sm_scale * kLog2e, a.f, a.pos(), a.dslope);
  return cudaGetLastError();
}

// The fused backward: bf16 on the Hopper kernel (flash_bwd_fused_sm90.cuh),
// fp32 on the template above.  One launch either way.
template <int D>
cudaError_t launch_fused(const Args& a, int dtype, int off_bound, void* dk, void* dv, void* dq,
                         float* dq_acc, int* counters) {
  if (dtype == 1) return launch_dkv<float, D, true>(a, off_bound, dk, dv, dq, dq_acc, counters);
  if (a.f.q_seg != nullptr || a.f.window != kNoWindow) {
    return sm90::launch_fused<D, bf16, true>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.offsets(),
                                             a.bound(off_bound), dk, dv, dq, dq_acc, counters,
                                             a.batch, a.n_heads, a.n_kv_heads, a.n_q, a.n_kv,
                                             a.sm_scale, a.stream, a.f);
  }
  return sm90::launch_fused<D, bf16>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.offsets(),
                               a.bound(off_bound), dk, dv, dq, dq_acc, counters, a.batch,
                               a.n_heads, a.n_kv_heads, a.n_q, a.n_kv, a.sm_scale, a.stream);
}

template <int D, bool kXf, bool kDrop = false>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(BwdSmem<float, D>);
  cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<D, kXf, kDrop>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + kTile - 1) / kTile, a.n_heads, a.batch);
  flash_bwd_dq_f32_kernel<D, kXf, kDrop><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), a.offsets(),
      a.bound(a.split_bound()), static_cast<float*>(dq), a.n_heads, a.n_kv_heads, a.n_q, a.n_kv,
      a.sm_scale, a.sm_scale * kLog2e, a.f, a.pos());
  return cudaGetLastError();
}

// The split pair: bf16 on the Hopper kernels (flash_bwd_sm90.cuh), fp32 on
// the template above.
// The bf16 kernels' arguments, outputs dk, dv or dq.
sm90::BwdArgs sm90_args(const Args& a, void* dk, void* dv, void* dq) {
  return {static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<bf16*>(dq),
          a.n_heads, a.n_kv_heads, a.n_q, a.n_kv, a.sm_scale, a.sm_scale * kLog2e};
}

// bf16: the causal walk, or under a window or segment ids the walk that
// takes them (CausalWalkT<kSeg, true>), under the score transforms the one
// that also takes them (CausalWalkT<kSeg, true, true>, any window), under
// dropout the one that takes it too (CausalWalkT<kSeg, true, true, true>,
// any window and transforms).
template <class Launch>
cudaError_t launch_walk(const Args& a, Launch launch) {
  const Feat& f = a.f;
  if (f.drop.on()) {
    if (f.q_seg != nullptr) {
      return launch(sm90::CausalWalkT<true, true, true, true>{
          a.offsets(), f.window, f.sinks, f.q_seg, f.kv_seg, f.softcap, f.slopes, a.pos(),
          a.dslope, f.drop});
    }
    return launch(sm90::CausalWalkT<false, true, true, true>{
        a.offsets(), f.window, f.sinks, nullptr, nullptr, f.softcap, f.slopes, a.pos(), a.dslope,
        f.drop});
  }
  if (f.xf()) {
    if (f.q_seg != nullptr) {
      return launch(sm90::CausalWalkT<true, true, true>{a.offsets(), f.window, f.sinks, f.q_seg,
                                                        f.kv_seg, f.softcap, f.slopes, a.pos(),
                                                        a.dslope});
    }
    return launch(sm90::CausalWalkT<false, true, true>{a.offsets(), f.window, f.sinks, nullptr,
                                                       nullptr, f.softcap, f.slopes, a.pos(),
                                                       a.dslope});
  }
  if (f.q_seg != nullptr) {
    return launch(sm90::CausalWalkT<true, true>{a.offsets(), f.window, f.sinks, f.q_seg,
                                                f.kv_seg});
  }
  if (f.window != kNoWindow) {
    return launch(sm90::CausalWalkT<false, true>{a.offsets(), f.window, f.sinks});
  }
  return launch(sm90::CausalWalk{a.offsets()});
}

template <int D>
cudaError_t launch_split_dkv(const Args& a, int dtype, void* dk, void* dv) {
  if (dtype == 1 && a.f.drop.on()) {
    return launch_dkv<float, D, false, true, true>(a, a.split_bound(), dk, dv);
  }
  if (dtype == 1 && a.f.xf()) return launch_dkv<float, D, false, true>(a, a.split_bound(), dk, dv);
  if (dtype == 1) return launch_dkv<float, D, false>(a, a.split_bound(), dk, dv);
  const dim3 grid(a.batch * a.n_kv_heads, (a.n_kv + kTile - 1) / kTile);
  const sm90::BwdArgs args = sm90_args(a, dk, dv, nullptr);
  return launch_walk(a, [&](const auto& walk) {
    return sm90::launch_dkv<D>(args, walk, grid, a.stream);
  });
}

template <int D>
cudaError_t launch_split_dq(const Args& a, int dtype, void* dq) {
  if (dtype == 1 && a.f.drop.on()) return launch_dq_f32<D, true, true>(a, dq);
  if (dtype == 1 && a.f.xf()) return launch_dq_f32<D, true>(a, dq);
  if (dtype == 1) return launch_dq_f32<D, false>(a, dq);
  const dim3 grid(a.batch * a.n_heads, (a.n_q + kTile - 1) / kTile);
  const sm90::BwdArgs args = sm90_args(a, nullptr, nullptr, dq);
  return launch_walk(a, [&](const auto& walk) {
    return sm90::launch_dq<D>(args, walk, grid, a.stream);
  });
}

// The window and the segment ids of an entry's call: window 0 for none
// (more needs causal), sinks >= 0; both segment ids or neither.
bool valid_feat(int window, int sinks, const void* q_seg, const void* kv_seg, int causal) {
  return window >= 0 && sinks >= 0 && (window == 0 || causal) &&
         (q_seg == nullptr) == (kv_seg == nullptr);
}

Feat make_feat(int window, int sinks, const void* q_seg, const void* kv_seg,
               float softcap = 0.0f, const void* slopes = nullptr, const Drop& drop = Drop{}) {
  return {window_or_none(window), window > 0 ? sinks : 0, static_cast<const int*>(q_seg),
          static_cast<const int*>(kv_seg), softcap, static_cast<const float*>(slopes), drop};
}

// Dropout (seed null: none): a threshold in [0, 2^31), a keep factor of 1
// or more, the (b, h) stream's head count, and the offsets (the walks it
// rides measure the bias from them).
bool valid_drop(const void* seed, int threshold, float inv_keep, int heads,
                const void* q_offset) {
  return seed == nullptr ||
         (threshold >= 0 && inv_keep >= 1.0f && heads >= 1 && q_offset != nullptr);
}

Drop make_drop(const void* seed, int threshold, float inv_keep, int heads) {
  return Drop{static_cast<const int*>(seed), (uint32_t)threshold, inv_keep, heads};
}

// The score transforms: a cap of 0 (none) or more; slopes need the offsets
// (the bias measures each row's position from them, also when not causal).
bool valid_xf(float softcap, const void* slopes, const void* q_offset) {
  return softcap >= 0.0f && (slopes == nullptr || q_offset != nullptr);
}

bool valid(int batch, int n_heads, int n_kv_heads, int n_q, int n_kv, int head_dim,
           int dtype) {
  return (head_dim == 64 || head_dim == 128) && (dtype == 0 || dtype == 1) &&
         n_kv_heads >= 1 && n_heads % n_kv_heads == 0 && batch >= 1 && batch <= 65535 &&
         n_heads <= 65535 && n_q >= 1 && n_kv >= 1 && n_q <= 65535 * kTile &&
         n_kv <= 65535 * kTile;
}

}  // namespace

// C entry points, bound with ctypes (kernels/flash_bwd.py).  Pointers are
// device pointers of contiguous tensors: q, dout [B, H, N_q, D]; k, v, dk,
// dv [B, H_kv, N_kv, D], D = head_dim, 64 or 128; lse, delta fp32
// [B, H, N_q]; q_offset int32 [B] (read only when causal, or with slopes).
// dtype: 0 = bf16, 1 = fp32.  window: the columns a row sees back from its
// position (0: none; more needs causal), sinks the first columns it sees
// besides; q_seg, kv_seg: int32 segment ids [B, N_q] and [B, N_kv], or
// both null.  softcap (0: none) and slopes (fp32 [H] or null): the score
// transforms (xf.cuh); dslope: fp32 [B, H, ceil(N_kv / 64), 4] zeros, into
// which the dK/dV entry writes the d_slopes partials under slopes (null:
// none are written).  drop_seed, drop_threshold, drop_inv_keep,
// drop_heads: the forward's attention dropout (fam_flash_fwd), seed null
// for none (q_offset then needed).  Each returns its launches' cudaError_t
// (0 on success).
extern "C" int fam_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_offset,
                                 void* dk, void* dv, int window, int sinks, const void* q_seg,
                                 const void* kv_seg, float softcap, const void* slopes,
                                 void* dslope, const void* drop_seed, int drop_threshold,
                                 float drop_inv_keep, int drop_heads, int batch, int n_heads,
                                 int n_kv_heads, int n_q, int n_kv,
                                 int head_dim, float sm_scale, int causal,
                                 int dtype, void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim, dtype) ||
      !valid_feat(window, sinks, q_seg, kv_seg, causal) || !valid_xf(softcap, slopes, q_offset) ||
      !valid_drop(drop_seed, drop_threshold, drop_inv_keep, drop_heads, q_offset)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k, v, dout, lse, delta, q_offset, batch, n_heads, n_kv_heads,
         n_q, n_kv, causal, sm_scale, static_cast<cudaStream_t>(stream),
         make_feat(window, sinks, q_seg, kv_seg, softcap, slopes,
                   make_drop(drop_seed, drop_threshold, drop_inv_keep, drop_heads))};
  a.dslope = slopes != nullptr ? static_cast<float*>(dslope) : nullptr;
  return (int)(head_dim == 64 ? launch_split_dkv<64>(a, dtype, dk, dv)
                              : launch_split_dkv<128>(a, dtype, dk, dv));
}

extern "C" int fam_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* q_offset,
                                void* dq, int window, int sinks, const void* q_seg,
                                const void* kv_seg, float softcap, const void* slopes,
                                const void* drop_seed, int drop_threshold, float drop_inv_keep,
                                int drop_heads, int batch, int n_heads,
                                int n_kv_heads, int n_q, int n_kv, int head_dim,
                                float sm_scale, int causal, int dtype,
                                void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim, dtype) ||
      !valid_feat(window, sinks, q_seg, kv_seg, causal) || !valid_xf(softcap, slopes, q_offset) ||
      !valid_drop(drop_seed, drop_threshold, drop_inv_keep, drop_heads, q_offset)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, dout, lse, delta, q_offset, batch, n_heads, n_kv_heads,
               n_q, n_kv, causal, sm_scale, static_cast<cudaStream_t>(stream),
               make_feat(window, sinks, q_seg, kv_seg, softcap, slopes,
                         make_drop(drop_seed, drop_threshold, drop_inv_keep, drop_heads))};
  return (int)(head_dim == 64 ? launch_split_dq<64>(a, dtype, dq)
                              : launch_split_dq<128>(a, dtype, dq));
}

// The fused backward: dk, dv as above, dq [B, H, N_q, D]; dq_acc fp32
// [B, H, N_q, D], any contents; counters int32 [n_counters] =
// dq_ordered::counter_count(batch, n_heads, n_q) (the ticket, then one per
// 32 query rows of each q-head), all zero (kernels/flash_bwd.py::
// dq_workspace_shape counts both).  When causal, each q_offset entry is
// read no higher than off_bound.  window, sinks, q_seg, kv_seg as above.
extern "C" int fam_flash_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* q_offset,
                                   void* dk, void* dv, void* dq, void* dq_acc,
                                   void* counters, int n_counters, int off_bound, int window,
                                   int sinks, const void* q_seg, const void* kv_seg, int batch,
                                   int n_heads, int n_kv_heads, int n_q, int n_kv,
                                   int head_dim, float sm_scale, int causal, int dtype,
                                   void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim, dtype) ||
      n_counters != dq_ordered::counter_count(batch, n_heads, n_q) ||
      !valid_feat(window, sinks, q_seg, kv_seg, causal)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, dout, lse, delta, q_offset, batch, n_heads, n_kv_heads,
               n_q, n_kv, causal, sm_scale, static_cast<cudaStream_t>(stream),
               make_feat(window, sinks, q_seg, kv_seg)};
  float* acc = static_cast<float*>(dq_acc);
  int* cnt = static_cast<int*>(counters);
  return (int)(head_dim == 64 ? launch_fused<64>(a, dtype, off_bound, dk, dv, dq, acc, cnt)
                              : launch_fused<128>(a, dtype, off_bound, dk, dv, dq, acc, cnt));
}
