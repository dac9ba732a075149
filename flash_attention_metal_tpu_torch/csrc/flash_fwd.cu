// Forward flash attention for Hopper (sm_90a), bf16 and fp32.
//
// Replaces flash_attention_metal_tpu/kernels/flash_fwd.py::_fwd_kernel, the
// Pallas kernel that both phases of the serving path end in: chunked prefill
// (native GQA, pos_div = 1) and GQA-folded decode (pos_div = group).
//
// Contract, for every batch b, q-head h and query row r:
//   o[b,h,r,:] = softmax_c(s) . V,  s = sm_scale * q[b,h,r] . k[b,h/group,c]
// over the visible columns c < n_kv and, when causal,
// c <= r / pos_div + q_offset[b], with q_offset an int32 [B] array on the
// device.  A row with no visible column gives o = 0 and lse = -inf.  The
// optional lse is the natural-log logsumexp per row, fp32 [B, H, N_q].
// Softmax statistics and both products accumulate in fp32; fp32 inputs use
// plain IEEE FMA (never TF32).
//
// What bounds it on the H100.  Decode (n_q = group rows per KV head) reads
// each visible K and V row once and does 4 * group flops per byte: it is
// bound by KV bytes from HBM (3.35 TB/s).  Prefill at n_q >= 512 does
// ~n_q / 2 flops per KV byte and is bound by the tensor-core rate.
//
// What this first design does about it.
//   * One thread block per (64-row q tile, q-head, batch); its KV loop stops
//     at the last column visible to the tile's last row, so decode reads
//     length[b] rows, not max_len, and causal prefill skips the upper
//     triangle (the counterpart of the Pallas whole-block skip and DMA clamp).
//   * GQA reads KV head h / group directly: nothing is repeated in memory.
//     Folded decode packs a KV head's group q-heads into the rows of one
//     tile, so the cache streams once per KV head.
//   * bf16 QK^T and PV run on the tensor cores through WMMA 16x16x16
//     fragments with fp32 accumulators; warps whose 16 rows are all past n_q
//     (most of a folded-decode tile) skip their products.
//   * Exact online softmax in exp2, with sm_scale * log2(e) applied to the
//     fp32 scores.
// Not yet done (later PRs): wgmma, TMA and a multi-stage copy pipeline for
// prefill; split-KV so that decode fills all 132 SMs (B * H_kv blocks today).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 64;   // query rows per block (16 per warp)
constexpr int kBlockN = 64;   // key columns per KV step
constexpr int kHeadDim = 64;
constexpr int kThreads = 2 * kBlockM;  // two threads per query row
constexpr int kSCols = kBlockN / 2;    // score columns per thread
constexpr int kOCols = kHeadDim / 2;   // output columns per thread
// Shared-memory row pitches: padded to spread banks, and kept multiples of
// 16 bytes (vector copies) and of 32 bytes per 16 rows (WMMA pointers).
constexpr int kLdT = kHeadDim + 8;
constexpr int kLdP = kBlockN + 8;
constexpr int kLdS = kBlockN + 4;
static_assert(kHeadDim <= kLdS, "the score buffer also holds the PV tile");
// Finite mask value (config.DEFAULT_MASK_VALUE): exp2(mask - mask) is never
// NaN, and visibility is tested explicitly, so masked entries add nothing.
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

template <typename T>
struct Smem {
  T q[kBlockM * kLdT];
  T k[kBlockN * kLdT];
  T v[kBlockN * kLdT];
  T p[kBlockM * kLdP];      // probabilities, in the input type for PV
  float s[kBlockM * kLdS];  // scores, then the PV product of the step
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Copy `kRows` rows of head_dim elements (row pitch kHeadDim in global
// memory) into shared memory with pitch kLdT; rows >= rows_valid are zero.
template <typename T, int kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows_valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = kHeadDim / kVec;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * kHeadDim + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = val;
  }
}

// s[16 warp rows][kBlockN] = Q K^T on the tensor cores.
__device__ __forceinline__ void qk_bf16(Smem<bf16>& sm, int warp) {
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBlockN / 16];
#pragma unroll
  for (int n = 0; n < kBlockN / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kHeadDim; kk += 16) {
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

// s[16 warp rows][kHeadDim] = P V on the tensor cores.
__device__ __forceinline__ void pv_bf16(Smem<bf16>& sm, int warp) {
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kHeadDim / 16];
#pragma unroll
  for (int n = 0; n < kHeadDim / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kBlockN; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sm.p + warp * 16 * kLdP + kk, kLdP);
#pragma unroll
    for (int n = 0; n < kHeadDim / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, sm.v + kk * kLdT + n * 16, kLdT);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kHeadDim / 16; ++n) {
    wmma::store_matrix_sync(sm.s + warp * 16 * kLdS + n * 16, acc[n], kLdS,
                            wmma::mem_row_major);
  }
}

// fp32 products in IEEE FMA: each thread computes its own row's half.
__device__ __forceinline__ void qk_f32(Smem<float>& sm, int r, int half) {
  float acc[kSCols];
#pragma unroll
  for (int j = 0; j < kSCols; ++j) acc[j] = 0.0f;
  for (int d = 0; d < kHeadDim; ++d) {
    const float qv = sm.q[r * kLdT + d];
#pragma unroll
    for (int j = 0; j < kSCols; ++j) {
      acc[j] = fmaf(qv, sm.k[(half * kSCols + j) * kLdT + d], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kSCols; ++j) sm.s[r * kLdS + half * kSCols + j] = acc[j];
}

__device__ __forceinline__ void pv_f32(Smem<float>& sm, int r, int half) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_offset,
                     T* __restrict__ o, float* __restrict__ lse, int n_heads,
                     int n_kv_heads, int n_q, int n_kv, float scale_log2,
                     int causal, int pos_div) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r = tid >> 1;    // this thread's row of the tile
  const int half = tid & 1;  // which half of the row's columns it owns
  const int q_start = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int h_kv = h / (n_heads / n_kv_heads);
  const size_t q_rows = ((size_t)b * n_heads + h) * n_q;  // row index base
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;

  const int rows_valid = min(kBlockM, n_q - q_start);
  const bool warp_active = warp * 16 < rows_valid;
  const int off = causal ? q_offset[b] : 0;
  const int row = q_start + r;
  // Last column this thread's row may see (-1: none).
  int col_limit = -1;
  if (r < rows_valid) {
    col_limit = causal ? min(n_kv - 1, row / pos_div + off) : n_kv - 1;
  }
  // Last column any row of the tile may see: the KV loop stops there.
  int tile_limit = n_kv - 1;
  if (causal) tile_limit = min(tile_limit, (q_start + rows_valid - 1) / pos_div + off);
  const int n_steps = tile_limit < 0 ? 0 : tile_limit / kBlockN + 1;

  load_tile<T, kBlockM>(sm.q, q + (q_rows + q_start) * kHeadDim, rows_valid);

  float o_acc[kOCols];
#pragma unroll
  for (int j = 0; j < kOCols; ++j) o_acc[j] = 0.0f;
  float m_i = -INFINITY;  // running max, log2 units
  float l_i = 0.0f;       // running sum of exp2(s - m_i)

  for (int step = 0; step < n_steps; ++step) {
    const int kv_start = step * kBlockN;
    const int cols_valid = min(kBlockN, n_kv - kv_start);
    load_tile<T, kBlockN>(sm.k, k + (kv_rows + kv_start) * kHeadDim, cols_valid);
    load_tile<T, kBlockN>(sm.v, v + (kv_rows + kv_start) * kHeadDim, cols_valid);
    __syncthreads();

    if constexpr (std::is_same<T, bf16>::value) {
      if (warp_active) qk_bf16(sm, warp);
    } else {
      qk_f32(sm, r, half);
    }
    __syncthreads();

    // Online softmax over this thread's half row; the pair of threads that
    // share a row are lanes 2i and 2i+1 of one warp.
    float s_reg[kSCols];
    float step_max = kMaskValue;
    const int col0 = kv_start + half * kSCols;
#pragma unroll
    for (int j = 0; j < kSCols; ++j) {
      const float x = col0 + j <= col_limit
                          ? sm.s[r * kLdS + half * kSCols + j] * scale_log2
                          : kMaskValue;
      s_reg[j] = x;
      step_max = fmaxf(step_max, x);
    }
    step_max = fmaxf(step_max, __shfl_xor_sync(0xffffffffu, step_max, 1));
    const float m_new = fmaxf(m_i, step_max);
    const float alpha = exp2f(m_i - m_new);  // 0 on the first step
    float row_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kSCols; ++j) {
      const float p = col0 + j <= col_limit ? exp2f(s_reg[j] - m_new) : 0.0f;
      row_sum += p;
      sm.p[r * kLdP + half * kSCols + j] = from_float<T>(p);
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
    // The next step's loads write k/v only; its first write to s comes
    // after the barrier that follows them.
  }

  if (r < rows_valid) {
    const float inv_l = l_i > 0.0f ? 1.0f / l_i : 0.0f;
    T* dst = o + (q_rows + row) * kHeadDim + half * kOCols;
#pragma unroll
    for (int j = 0; j < kOCols; ++j) dst[j] = from_float<T>(o_acc[j] * inv_l);
    if (lse != nullptr && half == 0) {
      lse[q_rows + row] = l_i > 0.0f ? (m_i + log2f(l_i)) * kLn2 : -INFINITY;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_offset, void* o, void* lse, int batch,
                   int n_heads, int n_kv_heads, int n_q, int n_kv,
                   float sm_scale, int causal, int pos_div,
                   cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<T>);
  // The dynamic shared-memory limit is raised once per kernel and device.
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((n_q + kBlockM - 1) / kBlockM, n_heads, batch);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_offset),
      static_cast<T*>(o), static_cast<float*>(lse), n_heads, n_kv_heads, n_q,
      n_kv, sm_scale * kLog2e, causal, pos_div);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (kernels/flash_fwd.py).  Pointers are
// device pointers of contiguous [B, H, N, 64] tensors; q_offset is int32
// [B] (read only when causal); lse may be null.  dtype: 0 = bf16, 1 = fp32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int fam_flash_fwd(const void* q, const void* k, const void* v,
                             const void* q_offset, void* o, void* lse,
                             int batch, int n_heads, int n_kv_heads, int n_q,
                             int n_kv, int head_dim, float sm_scale,
                             int causal, int pos_div, int dtype, void* stream) {
  if (head_dim != kHeadDim || pos_div < 1 || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0 ||
      batch < 1 || n_q < 1 || n_kv < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<bf16>(q, k, v, q_offset, o, lse, batch, n_heads,
                             n_kv_heads, n_q, n_kv, sm_scale, causal, pos_div, s);
  }
  if (dtype == 1) {
    return (int)launch<float>(q, k, v, q_offset, o, lse, batch, n_heads,
                              n_kv_heads, n_q, n_kv, sm_scale, causal, pos_div, s);
  }
  return (int)cudaErrorInvalidValue;
}
