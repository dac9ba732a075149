// Triangular causal attention for Hopper (sm_90a), bf16 and fp32, head dim
// 64 or 128: the forward and the fused backward, both with a static causal
// offset.
//
// Replaces flash_attention_metal_tpu/kernels/flash_tri.py::_tri_kernel
// (forward) and ::_tri_bwd_kernel (backward), the JAX routers' default for
// plain causal calls whose offset is a Python int: the benchmark's causal
// sweep and its high-occupancy phase, and the ladder's rungs 5c, 6, 7b, 7c.
//
// Contract, for every batch b, q-head h (KV head h / group) and query row r,
// with row r seeing column c when c < n_kv and c <= r + q_offset (q_offset
// an int given at launch):
//   forward   o[r] = softmax_c(sm_scale * q[r] . k[c]) . V, and optionally
//             lse[r], the natural-log row logsumexp, fp32 [B, H, N_q]; a row
//             with no visible column gives o = 0 and lse = -inf.
//   backward  (equal head counts) with P[r,c] = exp(sm_scale q[r].k[c] -
//             lse[r]) (lse = -inf takes a 1e30 sentinel: P = 0),
//             dS = P (dO V^T - delta), delta = rowsum(dO o O) - dlse (the
//             wrapper's torch op):  dV = P^T dO, dK = sm_scale dS^T Q,
//             dQ = sm_scale dS K, with S and P computed ONCE per visible
//             (Q tile, KV tile) pair for all three.  dK and dV come back
//             fp32 (as the Pallas kernel's do), dQ in q's type.
// Softmax statistics and products accumulate in fp32; P and dS enter the
// bf16 products rounded to bf16; fp32 inputs use IEEE FMA (never TF32).
//
// What bounds it on the H100.  At the benchmark's high-occupancy shape (B16
// H8 N2048 causal, bf16) the forward does 68.7 GFLOP and the backward
// 171.8 GFLOP against ~34 MB and ~75 MB of I/O: both are bound by the
// tensor cores (0.069 ms and 0.174 ms at 989 TF/s), not by HBM.
//
// What the design does about it.
//   * The offset is static, so each 64-row q tile's visible extent is known
//     at launch.  The forward issues blocks heaviest first: block rank 0
//     takes the q tile with the longest row (the grid's slow axis is the
//     rank, the fast one batch x head), so the grid's tail is short tiles,
//     not the diagonal's longest ones.  flash_fwd.cu, whose offsets are a
//     device array, issues tiles in index order.
//   * Only KV tiles that straddle the diagonal (or the ragged end of the KV
//     row) test visibility; interior tiles skip the compare, the counterpart
//     of flash_tri.py's static mask skip.
//   * The backward is one block per (batch x head, 64-column KV tile), KV
//     tile 0 (the most Q tiles) first.  It keeps dK and dV of its tile in
//     fp32 fragments (bf16) or registers (fp32) over every visible Q tile,
//     and writes each pair's dQ contribution to its own fp32 workspace slot
//     (dq_slots.cuh, shared with the fused backward of flash_bwd.cu).  A
//     second small kernel sums each Q tile's slots in a fixed order and
//     scales.  Every output has one owner and a fixed summation order: the
//     backward is deterministic with no atomics.  The workspace is 64 x D
//     fp32 per visible pair (16 KB at D = 64, 1.1 GB at B16 H8 N2048):
//     ~0.66 ms of HBM traffic written and read back, more than the compute
//     bound.
//   * bf16 products run on the tensor cores through WMMA 16x16x16
//     (wmma_tiles.cuh); fp32 P and dS are written over the scores they come
//     from, so the fp32 backward fits 227 KB at D = 128.
// Not yet done (later PRs): wgmma, TMA and a copy pipeline; dQ kept on chip
// instead of the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dq_slots.cuh"
#include "wmma_tiles.cuh"

namespace {

static_assert(kTile == dq_slots::kTile, "a dQ slot is one tile pair");
using dq_slots::last_visible;
using dq_slots::visible_kv_tiles;

// ---------------------------------------------------------------------------
// Forward.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct FwdSmem {
  using C = Cfg<T, D>;
  T q[kTile * C::kLdT];
  T k[kTile * C::kLdT];
  T v[kTile * C::kLdT];
  float s[kTile * C::kLdS];             // scores (P over them in fp32), then P V (bf16)
  T p[C::kBf16 ? kTile * C::kLdX : 1];  // P for the tensor cores (bf16)
};

// One block per (batch x q-head, q tile), heaviest tile first; head dim D.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_tri_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int n_heads, int n_kv_heads,
                         int n_q, int n_kv, float scale_log2, int off) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<T, D>& sm = *reinterpret_cast<FwdSmem<T, D>*>(smem_raw);
  T* p = C::kBf16 ? sm.p : reinterpret_cast<T*>(sm.s);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r = tid >> 1;    // this thread's row of the tile
  const int half = tid & 1;  // which half of the row's columns it owns
  // Rank 0 is the last q tile, whose rows see the most columns.
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int h_kv = h / (n_heads / n_kv_heads);
  const size_t q_rows = (size_t)bh * n_q;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;

  const int rows_valid = min(kTile, n_q - q_start);
  const bool warp_active = warp * 16 < rows_valid;
  const int row = q_start + r;
  const int col_limit = last_visible(row, n_q, n_kv, off);
  // Every row of the tile sees the columns up to first_limit (the tile's
  // first row's limit): KV tiles ending there need no compare.
  const int first_limit = last_visible(q_start, n_q, n_kv, off);
  const int tile_limit = last_visible(q_start + rows_valid - 1, n_q, n_kv, off);
  const int n_steps = tile_limit < 0 ? 0 : tile_limit / kTile + 1;

  load_tile<T, D>(sm.q, q + (q_rows + q_start) * D, rows_valid);

  float o_acc[C::kOut];
#pragma unroll
  for (int j = 0; j < C::kOut; ++j) o_acc[j] = 0.0f;
  float m_i = -INFINITY;  // running max, log2 units
  float l_i = 0.0f;       // running sum of exp2(s - m_i)

  for (int step = 0; step < n_steps; ++step) {
    const int kv_start = step * kTile;
    const int cols_valid = min(kTile, n_kv - kv_start);
    load_tile<T, D>(sm.k, k + (kv_rows + kv_start) * D, cols_valid);
    load_tile<T, D>(sm.v, v + (kv_rows + kv_start) * D, cols_valid);
    __syncthreads();

    if constexpr (C::kBf16) {
      if (warp_active) mm_abt_bf16<D>(sm.q, sm.k, sm.s, warp);
    } else {
      mm_abt_f32<D>(sm.q, sm.k, sm.s, r, half);
    }
    __syncthreads();

    // Online softmax over this thread's half row; the pair of threads that
    // share a row are lanes 2i and 2i+1 of one warp.
    const bool interior = kv_start + kTile - 1 <= first_limit;
    float s_reg[kHalf];
    float step_max = kMaskValue;
    const int col0 = kv_start + half * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float x = interior || col0 + j <= col_limit
                          ? sm.s[r * C::kLdS + half * kHalf + j] * scale_log2
                          : kMaskValue;
      s_reg[j] = x;
      step_max = fmaxf(step_max, x);
    }
    step_max = fmaxf(step_max, __shfl_xor_sync(0xffffffffu, step_max, 1));
    const float m_new = fmaxf(m_i, step_max);
    const float alpha = exp2f(m_i - m_new);  // 0 on the first step
    float row_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float pj =
          interior || col0 + j <= col_limit ? exp2f(s_reg[j] - m_new) : 0.0f;
      row_sum += pj;
      p[r * C::kLdX + half * kHalf + j] = from_float<T>(pj);
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    l_i = l_i * alpha + row_sum;
    m_i = m_new;
    __syncthreads();

    if constexpr (C::kBf16) {
      if (warp_active) {
        Acc acc[D / 16];
#pragma unroll
        for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
        mma_ab_bf16<D>(acc, sm.p, sm.v, warp);
        store_acc<D>(sm.s, acc, warp);
      }
#pragma unroll
      for (int j = 0; j < C::kOut; ++j) o_acc[j] *= alpha;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < C::kOut; ++j) o_acc[j] += sm.s[r * C::kLdS + half * C::kOut + j];
    } else {
#pragma unroll
      for (int j = 0; j < C::kOut; ++j) o_acc[j] *= alpha;
      mma_ab_f32<D>(o_acc, p, sm.v, r, half);
    }
    // The next step's loads write k/v only; its first write to s and p
    // comes after the barrier that follows them.
    __syncthreads();
  }

  if (r < rows_valid) {
    const float inv_l = l_i > 0.0f ? 1.0f / l_i : 0.0f;
    T* dst = o + (q_rows + row) * D + half * C::kOut;
#pragma unroll
    for (int j = 0; j < C::kOut; ++j) dst[j] = from_float<T>(o_acc[j] * inv_l);
    if (lse != nullptr && half == 0) {
      lse[q_rows + row] = l_i > 0.0f ? (m_i + log2f(l_i)) * kLn2 : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

// One block per (batch x head, KV tile j), KV tile 0 first: dK and dV of the
// tile over its visible Q tiles, and each pair's dQ contribution (unscaled)
// into workspace slot (bh, first_slot(i) + j) (dq_slots.cuh), 64 x D fp32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_tri_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dq_ws, int n_q, int n_kv, int off,
                         int n_pairs, float sm_scale, float scale_log2) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem<T, D>& sm = *reinterpret_cast<BwdSmem<T, D>*>(smem_raw);
  T* p = sm.p_tile();
  T* ds = sm.ds_tile();

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r = tid >> 1;    // tile row: a Q row in the walk, a KV row at the store
  const int half = tid & 1;  // which half of the row's columns it owns
  const size_t bh = blockIdx.x;
  const int j = blockIdx.y;
  const int kv_start = j * kTile;
  const size_t q_rows = bh * n_q;
  const size_t kv_rows = bh * n_kv;
  const int cols_valid = min(kTile, n_kv - kv_start);
  const int n_q_tiles = (n_q + kTile - 1) / kTile;
  float* ws = dq_ws + bh * n_pairs * (size_t)(kTile * D);

  load_tile<T, D>(sm.k, k + (kv_rows + kv_start) * D, cols_valid);
  load_tile<T, D>(sm.v, v + (kv_rows + kv_start) * D, cols_valid);

  Acc dk_acc[D / 16], dv_acc[D / 16];
  float dk_reg[C::kOut], dv_reg[C::kOut];
  if constexpr (C::kBf16) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fill_fragment(dk_acc[n], 0.0f);
      wmma::fill_fragment(dv_acc[n], 0.0f);
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < C::kOut; ++jj) dk_reg[jj] = dv_reg[jj] = 0.0f;
  }

  int slot = 0;  // first workspace slot of Q tile i
  for (int i = 0; i < n_q_tiles; ++i) {
    const int n_cols = visible_kv_tiles(i, n_q, n_kv, off);
    if (j < n_cols) {
      const int q_start = i * kTile;
      const int rows_valid = min(kTile, n_q - q_start);
      load_tile<T, D>(sm.q, q + (q_rows + q_start) * D, rows_valid);
      load_tile<T, D>(sm.dout, dout + (q_rows + q_start) * D, rows_valid);
      load_rows(sm, lse + q_rows + q_start, delta + q_rows + q_start, rows_valid);
      __syncthreads();

      bwd_scores(sm, warp, r, half);
      __syncthreads();

      softmax_grad(sm, r, half, kv_start, last_visible(q_start + r, n_q, n_kv, off),
                   scale_log2);
      __syncthreads();

      float* ws_tile = ws + (size_t)(slot + j) * (kTile * D);
      if constexpr (C::kBf16) {
        mma_atb_bf16<D>(dv_acc, p, sm.dout, warp);
        mma_atb_bf16<D>(dk_acc, ds, sm.q, warp);
        Acc dq_acc[D / 16];
#pragma unroll
        for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.0f);
        mma_ab_bf16<D>(dq_acc, ds, sm.k, warp);
        store_acc<D>(ws_tile, dq_acc, warp, D);
      } else {
        mma_atb_f32<D>(dv_reg, p, sm.dout, r, half);
        mma_atb_f32<D>(dk_reg, ds, sm.q, r, half);
        float dq_reg[C::kOut];
#pragma unroll
        for (int jj = 0; jj < C::kOut; ++jj) dq_reg[jj] = 0.0f;
        mma_ab_f32<D>(dq_reg, ds, sm.k, r, half);
#pragma unroll
        for (int jj = 0; jj < C::kOut; ++jj) ws_tile[r * D + half * C::kOut + jj] = dq_reg[jj];
      }
      // The next tile's loads overwrite q, dout, lse2 and delta.
      __syncthreads();
    }
    slot += n_cols;
  }

  if constexpr (C::kBf16) {
    // Warp w holds KV rows 16w..16w+15; thread (r, half) stores row r.
    store_acc<D>(sm.s, dk_acc, warp);
    store_acc<D>(sm.dp, dv_acc, warp);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < C::kOut; ++jj) {
      dk_reg[jj] = sm.s[r * C::kLdS + half * C::kOut + jj];
      dv_reg[jj] = sm.dp[r * C::kLdS + half * C::kOut + jj];
    }
  }
  if (r < cols_valid) {
    const size_t at = (kv_rows + kv_start + r) * D + half * C::kOut;
#pragma unroll
    for (int jj = 0; jj < C::kOut; ++jj) {
      dk[at + jj] = dk_reg[jj] * sm_scale;
      dv[at + jj] = dv_reg[jj];
    }
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int batch, int n_heads, int n_kv_heads, int n_q,
                       int n_kv, float sm_scale, int off, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(FwdSmem<T, D>);
  cudaError_t err = allow_smem(flash_tri_fwd_kernel<T, D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (n_q + kTile - 1) / kTile);
  flash_tri_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      n_heads, n_kv_heads, n_q, n_kv, sm_scale * kLog2e, off);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, void* dq_ws, int batch,
                       int n_heads, int n_q, int n_kv, float sm_scale, int off,
                       int n_pairs, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(BwdSmem<T, D>);
  cudaError_t err = allow_smem(flash_tri_bwd_kernel<T, D>, smem, done);
  if (err != cudaSuccess) return err;
  const int bh = batch * n_heads;
  const dim3 grid(bh, (n_kv + kTile - 1) / kTile);
  flash_tri_bwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dq_ws), n_q, n_kv, off, n_pairs, sm_scale,
      sm_scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dq_slots::launch_reduce<T, D>(static_cast<const float*>(dq_ws), nullptr, off,
                                       static_cast<T*>(dq), batch, n_heads, n_q, n_kv,
                                       n_pairs, sm_scale, stream);
}

bool valid(int batch, int n_heads, int n_q, int n_kv) {
  return batch >= 1 && n_heads >= 1 && n_q >= 1 && n_kv >= 1 && n_q <= 65535 * kTile &&
         n_kv <= 65535 * kTile;
}

}  // namespace

// C entry points, bound with ctypes (kernels/flash_tri.py).  Pointers are
// device pointers of contiguous tensors; q_offset is the static causal
// offset (row r sees c <= r + q_offset); dtype: 0 = bf16, 1 = fp32.  Each
// launcher returns its launches' cudaError_t (0 on success).
//
// Forward: q, o [B, H, N_q, D]; k, v [B, H_kv, N_kv, D], D = head_dim, 64
// or 128; lse fp32 [B, H, N_q] or null.
extern "C" int fam_flash_tri_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int batch, int n_heads,
                                 int n_kv_heads, int n_q, int n_kv,
                                 int head_dim, float sm_scale, int q_offset,
                                 int dtype, void* stream) {
  if (!valid(batch, n_heads, n_q, n_kv) || n_kv_heads < 1 || n_heads % n_kv_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FAM_LAUNCH(T, D)                                                                  \
  return (int)launch_fwd<T, D>(q, k, v, o, lse, batch, n_heads, n_kv_heads, n_q, n_kv, \
                               sm_scale, q_offset, s)
  if (dtype == 0 && head_dim == 64) FAM_LAUNCH(bf16, 64);
  if (dtype == 0 && head_dim == 128) FAM_LAUNCH(bf16, 128);
  if (dtype == 1 && head_dim == 64) FAM_LAUNCH(float, 64);
  if (dtype == 1 && head_dim == 128) FAM_LAUNCH(float, 128);
#undef FAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Backward (equal head counts): q, dout, dq [B, H, N_q, D]; k, v [B, H,
// N_kv, D], D = head_dim, 64 or 128; lse, delta fp32 [B, H, N_q]; dk, dv
// fp32 [B, H, N_kv, D]; dq_ws fp32 [B * H * n_pairs, 64, D] with n_pairs
// the (Q tile, KV tile) pairs of 64 rows visible at q_offset (dq_slots.cuh,
// utils/roofline.py::dq_slot_count).
extern "C" int fam_flash_tri_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk, void* dv,
                                 void* dq_ws, int batch, int n_heads, int n_q,
                                 int n_kv, int head_dim, float sm_scale,
                                 int q_offset, int n_pairs, int dtype,
                                 void* stream) {
  if (!valid(batch, n_heads, n_q, n_kv) ||
      n_pairs != dq_slots::visible_pairs(n_q, n_kv, q_offset)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FAM_LAUNCH(T, D)                                                                    \
  return (int)launch_bwd<T, D>(q, k, v, dout, lse, delta, dq, dk, dv, dq_ws, batch, n_heads, \
                               n_q, n_kv, sm_scale, q_offset, n_pairs, s)
  if (dtype == 0 && head_dim == 64) FAM_LAUNCH(bf16, 64);
  if (dtype == 0 && head_dim == 128) FAM_LAUNCH(bf16, 128);
  if (dtype == 1 && head_dim == 64) FAM_LAUNCH(float, 64);
  if (dtype == 1 && head_dim == 128) FAM_LAUNCH(float, 128);
#undef FAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
