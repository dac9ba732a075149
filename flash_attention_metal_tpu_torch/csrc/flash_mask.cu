// Block-sparse attention for Hopper (sm_90a), bf16 and fp32, head dim 64 or
// 128: the forward, and the backward's dK/dV and dQ kernels.
//
// Replaces three Pallas kernels of
// flash_attention_metal_tpu/kernels/flash_mask.py, each with its own entry:
//   * _fwd_sparse_kernel (fam_flash_sparse_fwd): online softmax over each Q
//     block's KV skip list, the mask applied elementwise on visited blocks;
//   * _dkv_sparse_kernel (fam_flash_sparse_dkv): dK and dV per KV block over
//     its transposed Q list;
//   * _dq_sparse_kernel (fam_flash_sparse_dq): dQ per Q block over its KV
//     list.
//
// The mask.  A Pallas kernel traces the mask predicate into its body; a CUDA
// kernel cannot call it.  kernels/flash_mask.py::compile_tables evaluates it
// once on the host at this file's 64 x 64 tile and hands the kernels:
//   q_ptr [n_q_tiles + 1], q_list [nnz] of (KV tile, bits): Q tile i's
//     visited pairs are entries q_ptr[i] .. q_ptr[i + 1] - 1, in KV order;
//   kv_ptr [n_kv_tiles + 1], kv_list [nnz] of (Q tile, bits): the same pairs
//     per KV tile, in Q order;
//   bits -1 for a full pair, else the index of a 64 x 64 bit tile
//     (bit_tiles [n_partial][64 rows][2 words]: bit c % 32 of word c / 32 of
//     row r is element (r, c) of the pair, 1 = visible).  Elements past n_q
//     or n_kv are 0, so ragged edge tiles are never full.
// What the kernels read of the mask scales with the visited pairs: 16 bytes
// a pair and 512 per partial one, no [N, N] mask.
//
// Contract, for batch b, q-head h (KV head h / group), row r, column c
// visible when the mask says so:
//   forward  o[r] = softmax_c(sm_scale q[r] . k[c]) V over the visible c;
//            lse[r] (optional, natural log, fp32 [B, H, N_q]); a row that
//            sees nothing gives o = 0 and lse = -inf.
//   backward P[r,c] = exp(sm_scale q[r] . k[c] - lse[r]) on visible pairs,
//            0 elsewhere (lse = -inf takes a 1e30 sentinel: P = 0);
//            dS = P (dO V^T - delta), delta = rowsum(dO o O) (the wrapper's
//            torch op); dV = sum over the group of P^T dO, dK = sm_scale
//            sum over the group of dS^T Q (fp32 sums, one store, in k's
//            type), dQ = sm_scale dS K.  The Pallas backward takes equal
//            heads (its op repeats K/V and sums the group after in the
//            input type); GQA is native here, as in flash_bwd.cu.
// Softmax statistics and products accumulate in fp32; P and dS enter the
// bf16 products rounded to bf16; fp32 inputs use IEEE FMA, never TF32.
//
// What bounds it on the H100.  Per visited pair a head does 4 * D flops per
// visible element in the forward, 8 * D in dK/dV and 6 * D in dQ, against
// its Q, K and V tiles read once: at the sparse training shape (B4 H16/8
// N2048 D64, 34% of elements visible) the forward's 23.6 GFLOP against
// 51 MB put it on the tensor cores' side of the roofline, as dense
// attention (roofline.block_sparse_work).
//
// What the design does about it.
//   * One block per (Q tile, head, batch) walks that tile's list only: empty
//     pairs cost neither bytes nor products (the Pallas grid's elided DMA).
//   * The bf16 forward runs the dense forward's wgmma mainloop
//     (flash_fwd_sm90.cuh) on its sparse walk: S, P and O stay in
//     registers, S_{i+1} is issued before PV_i, K and V come through
//     cp.async rings of their own with a partial pair's bit tile beside K,
//     one barrier a step; a full pair fetches and tests no bits.  One block
//     per (q-head x batch, Q tile), the Q tiles issued longest list first
//     across heads.
//   * The bf16 backward runs the split pair's wgmma mainloop
//     (flash_bwd_sm90.cuh) on its sparse walk: S, dP, P and dS stay in
//     registers, a 2-stage cp.async ring carries each step's tiles and bit
//     rows, one barrier a step.  dQ: one block per (Q tile, head, batch)
//     over the tile's KV list, longest list first.  dK/dV: one block per
//     chunk of a KV tile's walk over the group's q-heads and its transposed
//     list; a walk longer than the cap (kernels/flash_mask.py::
//     dkv_chunk_cap, from list lengths and static shapes) is split, and the
//     last of its chunks sums their fp32 partials in chunk order
//     (deterministic, no float atomics), so a mask whose transposed lists
//     are uneven no longer waits on its longest one.
//   * fp32 keeps the first-generation template (this file): a thread's half
//     row is one 32-bit word of the pair's bit tile, read from device memory
//     once per pair; products in IEEE FMA (wmma_tiles.cuh's fp32 helpers),
//     P and dS written over the scores they come from (the fp32 tiles at
//     D = 128 would not fit 227 KB otherwise).  The fp32 dK/dV block walks
//     the group's q-heads and the whole transposed list of its (KV tile,
//     KV head, batch), one store.
// Not yet done: TMA in place of cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"
#include "wmma_tiles.cuh"

namespace {

constexpr int kBitWords = kTile / 32;  // words per row of a bit tile
static_assert(kBitWords == 2, "a thread's half row is one word of its bit-tile row");

// This thread's word of a visited pair's bit tile: bit j is column
// half * 32 + j of tile row r.  A full pair (bits < 0) sees every column.
__device__ __forceinline__ uint32_t visible_word(const uint32_t* __restrict__ bit_tiles,
                                                 int bits, int r, int half) {
  return bits < 0 ? 0xffffffffu : bit_tiles[((size_t)bits * kTile + r) * kBitWords + half];
}

// ---------------------------------------------------------------------------
// Forward.
// ---------------------------------------------------------------------------

// fp32 (bf16 runs flash_fwd_sm90.cuh's SparseFwdWalk).
template <int D>
struct FwdSmem {
  using C = Cfg<float, D>;
  float q[kTile * C::kLdT];
  float k[kTile * C::kLdT];
  float v[kTile * C::kLdT];
  float s[kTile * C::kLdS];  // scores, P over them
};

// fp32.  One block per (Q tile, q-head, batch) over the tile's KV list.
template <int D>
__global__ void __launch_bounds__(kThreads)
    sparse_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                      const int* __restrict__ q_ptr, const int2* __restrict__ q_list,
                      const uint32_t* __restrict__ bit_tiles, int n_heads, int n_kv_heads,
                      int n_q, int n_kv, float scale_log2) {
  using C = Cfg<float, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(smem_raw);
  float* p = sm.s;

  const int tid = threadIdx.x;
  const int r = tid >> 1;    // this thread's row of the tile
  const int half = tid & 1;  // which half of the row's columns it owns
  const int q_start = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int h_kv = h / (n_heads / n_kv_heads);
  const size_t q_rows = ((size_t)b * n_heads + h) * n_q;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;
  const int rows_valid = min(kTile, n_q - q_start);
  const int first = q_ptr[blockIdx.x];
  const int last = q_ptr[blockIdx.x + 1];

  load_tile<float, D>(sm.q, q + (q_rows + q_start) * D, rows_valid);

  float o_acc[C::kOut];
#pragma unroll
  for (int j = 0; j < C::kOut; ++j) o_acc[j] = 0.0f;
  float m_i = -INFINITY;  // running max, log2 units
  float l_i = 0.0f;       // running sum of exp2(s - m_i)

  for (int e = first; e < last; ++e) {  // the Q tile's KV list
    const int2 entry = q_list[e];
    const int kv_start = entry.x * kTile;
    const int cols_valid = min(kTile, n_kv - kv_start);
    load_tile<float, D>(sm.k, k + (kv_rows + kv_start) * D, cols_valid);
    load_tile<float, D>(sm.v, v + (kv_rows + kv_start) * D, cols_valid);
    const uint32_t word = visible_word(bit_tiles, entry.y, r, half);
    __syncthreads();

    mm_abt_f32<D>(sm.q, sm.k, sm.s, r, half);
    __syncthreads();

    // Online softmax over this thread's half row; the pair of threads that
    // share a row are lanes 2i and 2i+1 of one warp.
    float s_reg[kHalf];
    float step_max = kMaskValue;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float x = (word >> j) & 1u ? sm.s[r * C::kLdS + half * kHalf + j] * scale_log2
                                       : kMaskValue;
      s_reg[j] = x;
      step_max = fmaxf(step_max, x);
    }
    step_max = fmaxf(step_max, __shfl_xor_sync(0xffffffffu, step_max, 1));
    const float m_new = fmaxf(m_i, step_max);
    const float alpha = exp2f(m_i - m_new);  // 0 on the first pair
    float row_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float pj = (word >> j) & 1u ? exp2f(s_reg[j] - m_new) : 0.0f;
      row_sum += pj;
      p[r * C::kLdS + half * kHalf + j] = pj;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    l_i = l_i * alpha + row_sum;
    m_i = m_new;
    __syncthreads();

#pragma unroll
    for (int j = 0; j < C::kOut; ++j) o_acc[j] *= alpha;
    mma_ab_f32<D>(o_acc, p, sm.v, r, half);
    // The next pair's loads overwrite k and v; its first write to s comes
    // after the barrier that follows them.
    __syncthreads();
  }

  if (r < rows_valid) {
    const float inv_l = l_i > 0.0f ? 1.0f / l_i : 0.0f;
    float* dst = o + (q_rows + q_start + r) * D + half * C::kOut;
#pragma unroll
    for (int j = 0; j < C::kOut; ++j) dst[j] = o_acc[j] * inv_l;
    if (lse != nullptr && half == 0) {
      lse[q_rows + q_start + r] = l_i > 0.0f ? (m_i + log2f(l_i)) * kLn2 : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

// P and dS of one visited pair for this thread's half row, from the scores
// in s and dO V^T in dp, over them (fp32); invisible elements get 0.
template <int D>
__device__ __forceinline__ void softmax_grad_bits(BwdSmem<float, D>& sm, int r, int half,
                                                  uint32_t word, float scale_log2) {
  using C = Cfg<float, D>;
  float* p = sm.p_tile();
  float* ds = sm.ds_tile();
  const float lse2 = sm.lse2[r];
  const float delta = sm.delta[r];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int c = half * kHalf + j;
    const float pj = (word >> j) & 1u ? exp2f(sm.s[r * C::kLdS + c] * scale_log2 - lse2) : 0.0f;
    const float dsj = pj * (sm.dp[r * C::kLdS + c] - delta);
    p[r * C::kLdS + c] = pj;
    ds[r * C::kLdS + c] = dsj;
  }
}

// fp32.  One block per (KV tile j, KV head, batch): dK and dV of the tile
// over the group's q-heads and the tile's transposed list.
template <int D>
__global__ void __launch_bounds__(kThreads)
    sparse_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      const int* __restrict__ kv_ptr, const int2* __restrict__ kv_list,
                      const uint32_t* __restrict__ bit_tiles, int n_heads, int n_kv_heads,
                      int n_q, int n_kv, float sm_scale, float scale_log2) {
  using C = Cfg<float, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem<float, D>& sm = *reinterpret_cast<BwdSmem<float, D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int r = tid >> 1;    // tile row: a Q row in the walk, a KV row at the store
  const int half = tid & 1;  // which half of the row's columns it owns
  const int kv_start = blockIdx.x * kTile;
  const int h_kv = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv_heads;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;
  const int cols_valid = min(kTile, n_kv - kv_start);
  const int first = kv_ptr[blockIdx.x];
  const int last = kv_ptr[blockIdx.x + 1];

  load_tile<float, D>(sm.k, k + (kv_rows + kv_start) * D, cols_valid);
  load_tile<float, D>(sm.v, v + (kv_rows + kv_start) * D, cols_valid);

  float dk_reg[C::kOut], dv_reg[C::kOut];
#pragma unroll
  for (int j = 0; j < C::kOut; ++j) dk_reg[j] = dv_reg[j] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const size_t q_rows = ((size_t)b * n_heads + h_kv * group + g) * n_q;
    for (int e = first; e < last; ++e) {  // the transposed Q list
      const int2 entry = kv_list[e];
      const int q_start = entry.x * kTile;
      const int rows_valid = min(kTile, n_q - q_start);
      load_tile<float, D>(sm.q, q + (q_rows + q_start) * D, rows_valid);
      load_tile<float, D>(sm.dout, dout + (q_rows + q_start) * D, rows_valid);
      load_rows(sm, lse + q_rows + q_start, delta + q_rows + q_start, rows_valid);
      const uint32_t word = visible_word(bit_tiles, entry.y, r, half);
      __syncthreads();

      bwd_scores(sm, r, half);
      __syncthreads();

      softmax_grad_bits(sm, r, half, word, scale_log2);
      __syncthreads();

      mma_atb_f32<D>(dv_reg, sm.p_tile(), sm.dout, r, half);
      mma_atb_f32<D>(dk_reg, sm.ds_tile(), sm.q, r, half);
      // The next pair's loads overwrite q, dout, lse2 and delta.
      __syncthreads();
    }
  }

  if (r < cols_valid) {
    const size_t at = (kv_rows + kv_start + r) * D + half * C::kOut;
#pragma unroll
    for (int j = 0; j < C::kOut; ++j) {
      dk[at + j] = dk_reg[j] * sm_scale;
      dv[at + j] = dv_reg[j];
    }
  }
}

// fp32.  One block per (Q tile i, q-head, batch): dQ of the tile over its
// KV list.
template <int D>
__global__ void __launch_bounds__(kThreads)
    sparse_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, const int* __restrict__ q_ptr,
                     const int2* __restrict__ q_list, const uint32_t* __restrict__ bit_tiles,
                     int n_heads, int n_kv_heads, int n_q, int n_kv, float sm_scale,
                     float scale_log2) {
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
  const int first = q_ptr[blockIdx.x];
  const int last = q_ptr[blockIdx.x + 1];

  load_tile<float, D>(sm.q, q + (q_rows + q_start) * D, rows_valid);
  load_tile<float, D>(sm.dout, dout + (q_rows + q_start) * D, rows_valid);
  load_rows(sm, lse + q_rows + q_start, delta + q_rows + q_start, rows_valid);

  float dq_reg[C::kOut];
#pragma unroll
  for (int j = 0; j < C::kOut; ++j) dq_reg[j] = 0.0f;

  for (int e = first; e < last; ++e) {  // the KV list again
    const int2 entry = q_list[e];
    const int kv_start = entry.x * kTile;
    const int cols_valid = min(kTile, n_kv - kv_start);
    load_tile<float, D>(sm.k, k + (kv_rows + kv_start) * D, cols_valid);
    load_tile<float, D>(sm.v, v + (kv_rows + kv_start) * D, cols_valid);
    const uint32_t word = visible_word(bit_tiles, entry.y, r, half);
    __syncthreads();

    bwd_scores(sm, r, half);
    __syncthreads();

    softmax_grad_bits(sm, r, half, word, scale_log2);
    __syncthreads();

    mma_ab_f32<D>(dq_reg, sm.ds_tile(), sm.k, r, half);
    // The next pair's loads overwrite k and v.
    __syncthreads();
  }

  if (r < rows_valid) {
    float* dst = dq + (q_rows + q_start + r) * D + half * C::kOut;
#pragma unroll
    for (int j = 0; j < C::kOut; ++j) dst[j] = dq_reg[j] * sm_scale;
  }
}

// The shapes every entry takes: the arguments the launchers share.
struct Shape {
  int batch, n_heads, n_kv_heads, n_q, n_kv;
  float sm_scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                           const void* q_ptr, const void* q_list, const void* bits,
                           const Shape& s) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(FwdSmem<D>);
  cudaError_t err = allow_smem(sparse_fwd_kernel<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.n_q + kTile - 1) / kTile, s.n_heads, s.batch);
  sparse_fwd_kernel<D><<<grid, kThreads, smem, s.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), static_cast<const int*>(q_ptr),
      static_cast<const int2*>(q_list), static_cast<const uint32_t*>(bits), s.n_heads,
      s.n_kv_heads, s.n_q, s.n_kv, s.sm_scale * kLog2e);
  return cudaGetLastError();
}

// The backward's lists: per KV tile (dK/dV) or per Q tile (dQ), and the
// bit tiles.
struct Lists {
  const void *ptr, *list, *bits;
};

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv,
                           const Lists& l, const Shape& s) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(BwdSmem<float, D>);
  cudaError_t err = allow_smem(sparse_dkv_kernel<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.n_kv + kTile - 1) / kTile, s.n_kv_heads, s.batch);
  sparse_dkv_kernel<D><<<grid, kThreads, smem, s.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const int*>(l.ptr), static_cast<const int2*>(l.list),
      static_cast<const uint32_t*>(l.bits), s.n_heads, s.n_kv_heads, s.n_q, s.n_kv, s.sm_scale,
      s.sm_scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, const Lists& l,
                          const Shape& s) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(BwdSmem<float, D>);
  cudaError_t err = allow_smem(sparse_dq_kernel<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.n_q + kTile - 1) / kTile, s.n_heads, s.batch);
  sparse_dq_kernel<D><<<grid, kThreads, smem, s.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), static_cast<const int*>(l.ptr),
      static_cast<const int2*>(l.list), static_cast<const uint32_t*>(l.bits), s.n_heads,
      s.n_kv_heads, s.n_q, s.n_kv, s.sm_scale, s.sm_scale * kLog2e);
  return cudaGetLastError();
}

// bf16: the split pair's wgmma kernels on the sparse walk.
sm90::BwdArgs sm90_args(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, void* dq,
                        const Shape& s) {
  return {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<bf16*>(dq),
          s.n_heads, s.n_kv_heads, s.n_q, s.n_kv, s.sm_scale, s.sm_scale * kLog2e};
}

sm90::SparseWalk sparse_walk(const void* plan, const Lists& l, void* part, void* tickets) {
  return {static_cast<const int*>(plan), static_cast<const int*>(l.ptr),
          static_cast<const int2*>(l.list), static_cast<const uint32_t*>(l.bits),
          static_cast<float*>(part), static_cast<int*>(tickets)};
}

bool valid(int batch, int n_heads, int n_kv_heads, int n_q, int n_kv, int head_dim, int dtype) {
  return (head_dim == 64 || head_dim == 128) && (dtype == 0 || dtype == 1) && batch >= 1 &&
         batch <= 65535 && n_kv_heads >= 1 && n_heads % n_kv_heads == 0 && n_heads <= 65535 &&
         n_q >= 1 && n_kv >= 1 && n_q <= 65535 * kTile &&
         (long long)batch * n_heads <= 0x7fffffff;  // the bf16 grids' x: q-head x batch
}

}  // namespace

// C entry points, bound with ctypes (kernels/flash_mask.py).  Pointers are
// device pointers of contiguous tensors: q, dout, o, dq [B, H, N_q, D]; k, v,
// dk, dv [B, H_kv, N_kv, D]; lse, delta fp32 [B, H, N_q] (the forward's lse
// may be null); the mask's tables as compile_tables makes them (int32; each
// list entry two ints; bit tiles [n_partial, 64, 2] words).  dtype: 0 =
// bf16, 1 = fp32; head_dim 64 or 128.  Each returns the launch's
// cudaError_t (0 on success).

// The forward.  bf16: order int32 [n_q tiles], the Q tiles in issue order
// (longest list first); fp32 does not read it.
extern "C" int fam_flash_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const void* q_ptr, const void* q_list,
                                    const void* bits, const void* order, int batch, int n_heads,
                                    int n_kv_heads, int n_q, int n_kv, int head_dim,
                                    float sm_scale, int dtype, void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim, dtype) ||
      (dtype == 0 && order == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Shape s{batch, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                static_cast<cudaStream_t>(stream)};
  if (dtype == 1) {
    return (int)(head_dim == 64 ? launch_fwd_f32<64>(q, k, v, o, lse, q_ptr, q_list, bits, s)
                                : launch_fwd_f32<128>(q, k, v, o, lse, q_ptr, q_list, bits, s));
  }
  const sm90::SparseFwdWalk w{static_cast<const int*>(q_ptr), static_cast<const int2*>(q_list),
                              static_cast<const uint32_t*>(bits), static_cast<const int*>(order)};
  return (int)(head_dim == 64 ? sm90::launch_fwd_sparse<64>(q, k, v, o, lse, w, batch, n_heads,
                                                            n_kv_heads, n_q, n_kv, sm_scale,
                                                            s.stream)
                              : sm90::launch_fwd_sparse<128>(q, k, v, o, lse, w, batch, n_heads,
                                                             n_kv_heads, n_q, n_kv, sm_scale,
                                                             s.stream));
}

// dK/dV.  bf16: plan int32 [n_chunks, 8] (kernels/flash_mask.py::
// dkv_plan), one block per (KV head x batch, plan entry); part fp32, 64 x D
// x 2 floats per (workspace slot, KV head x batch) (null when no tile is
// split); tickets int32 per (split tile, KV head x batch), zero, left zero.
// fp32 reads none of them (one block per KV tile, KV head and batch).
extern "C" int fam_flash_sparse_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const void* kv_ptr, const void* kv_list,
                                    const void* bits, const void* plan, void* part,
                                    void* tickets, int batch, int n_heads, int n_kv_heads,
                                    int n_q, int n_kv, int head_dim, float sm_scale, int dtype,
                                    int n_chunks, void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim, dtype) ||
      (dtype == 0 && (plan == nullptr || n_chunks < 1 || n_chunks > 65535))) {
    return (int)cudaErrorInvalidValue;
  }
  const Shape s{batch, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                static_cast<cudaStream_t>(stream)};
  const Lists l{kv_ptr, kv_list, bits};
  if (dtype == 1) {
    return (int)(head_dim == 64 ? launch_dkv_f32<64>(q, k, v, dout, lse, delta, dk, dv, l, s)
                                : launch_dkv_f32<128>(q, k, v, dout, lse, delta, dk, dv, l, s));
  }
  const sm90::BwdArgs a = sm90_args(q, k, v, dout, lse, delta, dk, dv, nullptr, s);
  const dim3 grid(batch * n_kv_heads, n_chunks);
  const sm90::SparseWalk w = sparse_walk(plan, l, part, tickets);
  return (int)(head_dim == 64 ? sm90::launch_dkv<64>(a, w, grid, s.stream)
                              : sm90::launch_dkv<128>(a, w, grid, s.stream));
}

// dQ.  bf16: order int32 [n_q tiles], the Q tiles in issue order (longest
// list first); fp32 does not read it.
extern "C" int fam_flash_sparse_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, const void* q_ptr, const void* q_list,
                                   const void* bits, const void* order, int batch, int n_heads,
                                   int n_kv_heads, int n_q, int n_kv, int head_dim,
                                   float sm_scale, int dtype, void* stream) {
  if (!valid(batch, n_heads, n_kv_heads, n_q, n_kv, head_dim, dtype) ||
      (dtype == 0 && order == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Shape s{batch, n_heads, n_kv_heads, n_q, n_kv, sm_scale,
                static_cast<cudaStream_t>(stream)};
  const Lists l{q_ptr, q_list, bits};
  if (dtype == 1) {
    return (int)(head_dim == 64 ? launch_dq_f32<64>(q, k, v, dout, lse, delta, dq, l, s)
                                : launch_dq_f32<128>(q, k, v, dout, lse, delta, dq, l, s));
  }
  const sm90::BwdArgs a = sm90_args(q, k, v, dout, lse, delta, nullptr, nullptr, dq, s);
  const dim3 grid(batch * n_heads, (n_q + kTile - 1) / kTile);
  const sm90::SparseWalk w = sparse_walk(order, l, nullptr, nullptr);
  return (int)(head_dim == 64 ? sm90::launch_dq<64>(a, w, grid, s.stream)
                              : sm90::launch_dq<128>(a, w, grid, s.stream));
}
