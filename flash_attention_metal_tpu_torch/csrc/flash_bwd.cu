// Backward flash attention for Hopper (sm_90a), bf16 and fp32, head dim 64
// or 128: dK/dV and dQ (the split pair), and the fused 5-matmul backward.
//
// Replaces the FA-2 split pair of flash_attention_metal_tpu/kernels/
// flash_bwd.py: _dkv_kernel (dK, dV over KV tiles) and _dq_kernel (dQ over
// Q tiles), which the training step reaches through flash_attention_bwd; and
// _fused_bwd_kernel (flash_attention_bwd_fused), which the backward router
// takes where the autotuner's saved decision names it.  The split pair's
// bf16 route runs the Hopper kernels of flash_bwd_sm90.cuh (wgmma with
// register A operands, a cp.async ring); the fp32 split pair and the fused
// backward run the WMMA/FMA template below.
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
// Deterministic: each output tile has exactly one owner block and its sums
// run in a fixed order.  No atomics.
//
// The fused backward is the dK/dV kernel with a fifth product per (Q tile,
// KV tile) pair: the pair's dQ contribution dS K, written to its own fp32
// workspace slot in the packed layout of dq_slots.cuh (the triangular
// backward's): one 64 x D slot per pair visible at off_bound, a host-known
// bound on the offsets (the op's int offset; n_kv - 1, every pair, when the
// host knows none).  Each batch's slots follow its own offset, read no
// higher than the bound.  The shared reduce kernel then sums each Q tile's
// slots in KV-tile order and scales: the dQ kernel's recompute of S, P and
// dP is gone, at the cost of the workspace's traffic.  The JAX kernel keeps
// the partial count at 1-2 with 1024-2048-row KV tiles held in VMEM (its
// dqp, [B, H, n_kv / block_kv, N, D]); a thread block here holds a 64-row
// tile's dK/dV (a 2048-row tile's is 1 MB of fp32).
//
// What bounds it on the H100.  At the training shape (q [4,16,2048,64],
// kv [4,8,2048,64], causal) the fused kernel does ~172 GFLOP, so the bound
// is the tensor cores, not HBM.  The WMMA template reaches far less: every
// product goes through shared memory (fragments are stored and reloaded), a
// 64 x 64 tile pair needs five barriers, and a dK/dV block walks its Q tiles
// one after the other (group x N / 64 steps).
//
// What the template does about it.
//   * Causal block skipping in both kernels: a dK/dV block starts at the
//     first Q tile whose last row sees its first column, and a dQ block
//     stops at the last KV tile its last row sees.  Skipped tiles are
//     neither loaded nor computed.
//   * K and V (dK/dV) or Q, dO, lse and delta (dQ) load once per block and
//     stay in shared memory; dK/dV and dQ live in fp32 fragments (bf16) or
//     registers (fp32) for the whole walk.
//   * bf16 products run on the tensor cores through WMMA 16x16x16
//     (wmma_tiles.cuh); fp32 P and dS are written over the scores they come
//     from (the fp32 tiles at D = 128 would not fit 227 KB otherwise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dq_slots.cuh"
#include "flash_bwd_sm90.cuh"
#include "wmma_tiles.cuh"

namespace {

static_assert(kTile == dq_slots::kTile, "a dQ slot is one tile pair");
using dq_slots::batch_offset;
using dq_slots::first_slot;
using dq_slots::last_visible;
using dq_slots::visible_kv_tiles;

// One block per (KV tile, KV head, batch): dK and dV of the tile, summed
// over the group's q-heads and their visible Q tiles.  kFused: also each
// visible pair's dQ contribution (unscaled) into its slot of dq_ws, which
// holds n_pairs slots per q-head (dq_slots.cuh).  q_offset: per-batch
// offsets read no higher than off_bound; null: off_bound for every batch.
template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ q_offset, int off_bound, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dq_ws, int n_pairs,
                         int n_heads, int n_kv_heads, int n_q, int n_kv, float sm_scale,
                         float scale_log2) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem<T, D>& sm = *reinterpret_cast<BwdSmem<T, D>*>(smem_raw);
  T* p = sm.p_tile();
  T* ds = sm.ds_tile();

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r = tid >> 1;    // tile row: a Q row in the walk, a KV row at the store
  const int half = tid & 1;  // which half of the row's columns it owns
  const int kv_start = blockIdx.x * kTile;
  const int h_kv = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv_heads;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;
  const int cols_valid = min(kTile, n_kv - kv_start);
  const int off = batch_offset(q_offset, b, off_bound);
  // Rows r >= kv_start - off see the tile's first column; earlier Q tiles
  // see none of it and are skipped.
  const int q_first = max(0, kv_start - off) / kTile;
  const int n_q_tiles = (n_q + kTile - 1) / kTile;

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
    for (int j = 0; j < C::kOut; ++j) dk_reg[j] = dv_reg[j] = 0.0f;
  }

  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)b * n_heads + h_kv * group + g;
    const size_t q_rows = bh * n_q;
    int slot = kFused ? first_slot(q_first, n_q, n_kv, off) : 0;  // Q tile qt's first
    for (int qt = q_first; qt < n_q_tiles; ++qt) {
      const int q_start = qt * kTile;
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

      if constexpr (C::kBf16) {
        mma_atb_bf16<D>(dv_acc, p, sm.dout, warp);
        mma_atb_bf16<D>(dk_acc, ds, sm.q, warp);
      } else {
        mma_atb_f32<D>(dv_reg, p, sm.dout, r, half);
        mma_atb_f32<D>(dk_reg, ds, sm.q, r, half);
      }
      // Row kv_start - off can fall past a ragged last Q tile's valid rows:
      // that tile sees nothing of this KV tile and has no slot for it.
      const int n_cols = kFused ? visible_kv_tiles(qt, n_q, n_kv, off) : 0;
      if (kFused && (int)blockIdx.x < n_cols) {
        // The pair's slot: 64 x D fp32, whole tiles.
        float* ws = dq_ws + (bh * n_pairs + slot + blockIdx.x) * (size_t)(kTile * D);
        if constexpr (C::kBf16) {
          Acc dq_acc[D / 16];
#pragma unroll
          for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.0f);
          mma_ab_bf16<D>(dq_acc, ds, sm.k, warp);
          store_acc<D>(ws, dq_acc, warp, D);
        } else {
          float dq_reg[C::kOut];
#pragma unroll
          for (int j = 0; j < C::kOut; ++j) dq_reg[j] = 0.0f;
          mma_ab_f32<D>(dq_reg, ds, sm.k, r, half);
#pragma unroll
          for (int j = 0; j < C::kOut; ++j) ws[r * D + half * C::kOut + j] = dq_reg[j];
        }
      }
      slot += n_cols;
      // The next tile's loads overwrite q, dout, lse2 and delta.
      __syncthreads();
    }
  }

  if constexpr (C::kBf16) {
    // Warp w holds KV rows 16w..16w+15; thread (r, half) stores row r.
    store_acc<D>(sm.s, dk_acc, warp);
    store_acc<D>(sm.dp, dv_acc, warp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < C::kOut; ++j) {
      dk_reg[j] = sm.s[r * C::kLdS + half * C::kOut + j];
      dv_reg[j] = sm.dp[r * C::kLdS + half * C::kOut + j];
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
// tile over its visible KV tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ q_offset, int off_bound,
                            float* __restrict__ dq, int n_heads, int n_kv_heads, int n_q,
                            int n_kv, float sm_scale, float scale_log2) {
  using C = Cfg<float, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem<float, D>& sm = *reinterpret_cast<BwdSmem<float, D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
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
  // The KV walk stops at the last tile any row of the tile sees.
  const int n_steps = visible_kv_tiles(blockIdx.x, n_q, n_kv, off);

  load_tile<float, D>(sm.q, q + (q_rows + q_start) * D, rows_valid);
  load_tile<float, D>(sm.dout, dout + (q_rows + q_start) * D, rows_valid);
  load_rows(sm, lse + q_rows + q_start, delta + q_rows + q_start, rows_valid);

  float dq_reg[C::kOut];
#pragma unroll
  for (int j = 0; j < C::kOut; ++j) dq_reg[j] = 0.0f;

  for (int step = 0; step < n_steps; ++step) {
    const int kv_start = step * kTile;
    const int cols_valid = min(kTile, n_kv - kv_start);
    load_tile<float, D>(sm.k, k + (kv_rows + kv_start) * D, cols_valid);
    load_tile<float, D>(sm.v, v + (kv_rows + kv_start) * D, cols_valid);
    __syncthreads();

    bwd_scores(sm, warp, r, half);
    __syncthreads();

    // P and dS over the scores and dP.
    softmax_grad(sm, r, half, kv_start, col_limit, scale_log2);
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
  // The kernels' offsets: q_offset read no higher than off_bound when
  // causal, else n_kv - 1 (every column) with no read.  The split pair's
  // bound is n_kv - 1, which sees what any higher offset sees.
  const int* offsets() const {
    return causal ? static_cast<const int*>(q_offset) : nullptr;
  }
  int bound(int off_bound) const { return causal ? off_bound : n_kv - 1; }
};

// The dK/dV kernel; kFused adds the dQ slots of dq_ws (n_pairs per q-head).
template <typename T, int D, bool kFused>
cudaError_t launch_dkv(const Args& a, int off_bound, void* dk, void* dv, void* dq_ws,
                       int n_pairs) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(BwdSmem<T, D>);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D, kFused>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + kTile - 1) / kTile, a.n_kv_heads, a.batch);
  flash_bwd_dkv_kernel<T, D, kFused><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      a.offsets(), a.bound(off_bound), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dq_ws), n_pairs, a.n_heads, a.n_kv_heads, a.n_q, a.n_kv,
      a.sm_scale, a.sm_scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fused(const Args& a, int off_bound, void* dk, void* dv, void* dq,
                         void* dq_ws, int n_pairs) {
  cudaError_t err = launch_dkv<T, D, true>(a, off_bound, dk, dv, dq_ws, n_pairs);
  if (err != cudaSuccess) return err;
  return dq_slots::launch_reduce<T, D>(static_cast<const float*>(dq_ws), a.offsets(),
                                       a.bound(off_bound), static_cast<T*>(dq), a.batch,
                                       a.n_heads, a.n_q, a.n_kv, n_pairs, a.sm_scale,
                                       a.stream);
}

template <int D>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(BwdSmem<float, D>);
  cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + kTile - 1) / kTile, a.n_heads, a.batch);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), a.offsets(),
      a.bound(a.n_kv - 1), static_cast<float*>(dq), a.n_heads, a.n_kv_heads, a.n_q, a.n_kv,
      a.sm_scale, a.sm_scale * kLog2e);
  return cudaGetLastError();
}

// The split pair: bf16 on the Hopper kernels (flash_bwd_sm90.cuh), fp32 on
// the template above.
template <int D>
cudaError_t launch_split_dkv(const Args& a, int dtype, void* dk, void* dv) {
  if (dtype == 1) return launch_dkv<float, D, false>(a, a.n_kv - 1, dk, dv, nullptr, 0);
  return sm90::launch_dkv<D>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.offsets(), dk, dv,
                             a.batch, a.n_heads, a.n_kv_heads, a.n_q, a.n_kv, a.sm_scale,
                             a.stream);
}

template <int D>
cudaError_t launch_split_dq(const Args& a, int dtype, void* dq) {
  if (dtype == 1) return launch_dq_f32<D>(a, dq);
  return sm90::launch_dq<D>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.offsets(), dq, a.batch,
                            a.n_heads, a.n_kv_heads, a.n_q, a.n_kv, a.sm_scale, a.stream);
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
// [B, H, N_q]; q_offset int32 [B] (read only when causal).  dtype: 0 =
// bf16, 1 = fp32.  Each returns its launches' cudaError_t (0 on success).
extern "C" int fam_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_offset,
                                 void* dk, void* dv, int batch, int n_heads,
                                 int n_kv_heads, int n_q, int n_kv,
                                 int head_dim, float sm_scale, int causal,
                                 int dtype, void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, dout, lse, delta, q_offset, batch, n_heads, n_kv_heads,
               n_q, n_kv, causal, sm_scale, static_cast<cudaStream_t>(stream)};
  return (int)(head_dim == 64 ? launch_split_dkv<64>(a, dtype, dk, dv)
                              : launch_split_dkv<128>(a, dtype, dk, dv));
}

extern "C" int fam_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* q_offset,
                                void* dq, int batch, int n_heads,
                                int n_kv_heads, int n_q, int n_kv, int head_dim,
                                float sm_scale, int causal, int dtype,
                                void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, dout, lse, delta, q_offset, batch, n_heads, n_kv_heads,
               n_q, n_kv, causal, sm_scale, static_cast<cudaStream_t>(stream)};
  return (int)(head_dim == 64 ? launch_split_dq<64>(a, dtype, dq)
                              : launch_split_dq<128>(a, dtype, dq));
}

// The fused backward: dk, dv as above, dq [B, H, N_q, D]; dq_ws fp32
// [B * H * n_pairs, 64, D] with n_pairs the (Q tile, KV tile) pairs of 64
// rows visible at off_bound (causal) or at n_kv - 1 (dq_slots.cuh,
// utils/roofline.py::dq_slot_count).  When causal, each q_offset entry is
// read no higher than off_bound.
extern "C" int fam_flash_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* q_offset,
                                   void* dk, void* dv, void* dq, void* dq_ws,
                                   int n_pairs, int off_bound, int batch, int n_heads,
                                   int n_kv_heads, int n_q, int n_kv, int head_dim,
                                   float sm_scale, int causal, int dtype,
                                   void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim, dtype) ||
      n_pairs != dq_slots::visible_pairs(n_q, n_kv, causal ? off_bound : n_kv - 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, dout, lse, delta, q_offset, batch, n_heads, n_kv_heads,
               n_q, n_kv, causal, sm_scale, static_cast<cudaStream_t>(stream)};
#define FAM_LAUNCH(T, D) \
  return (int)launch_fused<T, D>(a, off_bound, dk, dv, dq, dq_ws, n_pairs)
  if (dtype == 0 && head_dim == 64) FAM_LAUNCH(bf16, 64);
  if (dtype == 0 && head_dim == 128) FAM_LAUNCH(bf16, 128);
  if (dtype == 1 && head_dim == 64) FAM_LAUNCH(float, 64);
  FAM_LAUNCH(float, 128);
#undef FAM_LAUNCH
}
