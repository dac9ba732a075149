// FlashAttention V1 for Hopper (sm_90a): tiled fp32 attention, streaming and
// folded, bf16 and fp32 inputs.
//
// Replaces flash_attention_metal_tpu/kernels/flash_v1.py::_flash_v1_kernel
// (streaming: one KV tile per step of an online softmax) and
// ::_flash_v1_kernel_folded (one pass over the whole KV row, several batch
// elements per grid step): the ladder's rung 2 and the benchmark sweep's
// FlashV1 column, the reference's FA-1 rung (kernels.metal:66-171).
//
// Contract, for every batch b, head h (equal head counts) and query row r:
//   o[r] = sum_c P[r,c] v[c] / sum_c P[r,c],  P[r,c] = exp(s[r,c] - m[r]),
//   s[r,c] = sm_scale * q[r] . k[c] over every column c < n_kv (causal: only
//   c <= r, with n_q == n_kv), m[r] the row max; a row whose sum is 0 divides
//   by 1.  No lse.  Everything is fp32 (IEEE FMA, never TF32) whatever the
//   input type; o comes back in q's type.
//   * Streaming: the row is walked in 64-column KV tiles with running max m,
//     running sum l and an accumulator rescaled by exp2(m_prev - m_next)
//     between tiles; one division by l at the end.
//   * Folded (n_kv <= 512): the block scores the whole row into shared
//     memory first, takes the max over all of it, then exp2, the sum and PV
//     in one pass: no running statistics.  One block serves `fold` batch
//     elements of one head and one 64-row query tile, one after the other.
//
// What bounds it on the H100.  4 * N_q * N_kv * 64 flops per head on the
// CUDA cores (67 TF/s fp32): at the benchmark's sweep points (B * N^2 =
// 2^23) ~32 us, against ~4 MB of inputs (1.3 us at 3.35 TB/s): operations.
//
// What the design does about it.  Two threads per query row, each owning 32
// of the 64 score columns of a tile and 32 of the 64 output columns; the
// row's statistics stay in registers and the pair combines them with one
// shuffle.  Every shared-memory operand is read as float4 (4 FMAs per
// load); the K, V and score rows a warp reads are broadcast (two addresses
// per warp).  It stays the simple rung: no tensor cores, no copy pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 64;  // query rows per tile
constexpr int kBlockN = 64;  // key columns per tile
constexpr int kHeadDim = 64;
constexpr int kThreads = 2 * kBlockM;  // two threads per tile row, 4 warps
constexpr int kHalf = 32;              // columns per thread of a 64-wide row
// Row pitch of the fp32 tiles in shared memory: a multiple of 4 floats
// (float4 accesses), padded so a quarter warp's rows fall on distinct banks.
constexpr int kLd = kHeadDim + 8;
constexpr int kLdP = kBlockN + 4;
// The longest row the folded kernel scores into shared memory.
constexpr int kFoldedMaxKv = 512;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Eight consecutive elements as floats.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Copy `rows_valid` rows of head_dim elements (row pitch kHeadDim in global
// memory) into a [64][kLd] fp32 shared tile; the other rows are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows_valid) {
  constexpr int kPerRow = kHeadDim / 8;
  for (int i = threadIdx.x; i < kBlockM * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows_valid) load8(src + (size_t)r * kHeadDim + c, x);
    *reinterpret_cast<float4*>(dst + r * kLd + c) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(dst + r * kLd + c + 4) = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// s[j] = q[r] . k[half * 32 + j]: this thread's half of a score row.
__device__ __forceinline__ void scores(const float* q, const float* k, int r,
                                       int half, float (&s)[kHalf]) {
#pragma unroll
  for (int j = 0; j < kHalf; ++j) s[j] = 0.0f;
  for (int d = 0; d < kHeadDim; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(q + r * kLd + d);
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(k + (half * kHalf + j) * kLd + d);
      s[j] = fmaf(a.x, b.x, s[j]);
      s[j] = fmaf(a.y, b.y, s[j]);
      s[j] = fmaf(a.z, b.z, s[j]);
      s[j] = fmaf(a.w, b.w, s[j]);
    }
  }
}

// acc[j] += sum_c p[c] v[c][half * 32 + j] over the 64 columns of a tile;
// p points at the row's first column of the tile.
__device__ __forceinline__ void accumulate_pv(const float* p, const float* v,
                                              int half, float (&acc)[kHalf]) {
  for (int c = 0; c < kBlockN; c += 4) {
    const float4 p4 = *reinterpret_cast<const float4*>(p + c);
    const float pc[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* vrow = v + (c + cc) * kLd + half * kHalf;
#pragma unroll
      for (int j = 0; j < kHalf; j += 4) {
        const float4 b = *reinterpret_cast<const float4*>(vrow + j);
        acc[j] = fmaf(pc[cc], b.x, acc[j]);
        acc[j + 1] = fmaf(pc[cc], b.y, acc[j + 1]);
        acc[j + 2] = fmaf(pc[cc], b.z, acc[j + 2]);
        acc[j + 3] = fmaf(pc[cc], b.w, acc[j + 3]);
      }
    }
  }
}

// Write this thread's half of output row `row` (if it is a real row).
template <typename T>
__device__ __forceinline__ void store_row(T* o, const float (&acc)[kHalf], float l,
                                          int half, bool valid) {
  if (!valid) return;
  const float inv_l = l == 0.0f ? 1.0f : 1.0f / l;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) o[half * kHalf + j] = from_float<T>(acc[j] * inv_l);
}

// Last column row `row` sees (n_kv - 1 unless causal).
__device__ __forceinline__ int last_visible(int row, int n_kv, int causal) {
  return causal ? min(row, n_kv - 1) : n_kv - 1;
}

struct StreamSmem {
  float q[kBlockM * kLd];
  float k[kBlockN * kLd];
  float v[kBlockN * kLd];
  float p[kBlockM * kLdP];  // probabilities of the step
};

// Streaming: one block per (batch x head, 64-row query tile); the KV walk
// stops at the tile's last visible column.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_v1_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int n_q,
                    int n_kv, float scale_log2, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  StreamSmem& sm = *reinterpret_cast<StreamSmem*>(smem_raw);

  const int tid = threadIdx.x;
  const int r = tid >> 1;    // this thread's row of the tile
  const int half = tid & 1;  // which half of the row's columns it owns
  const size_t bh = blockIdx.x;
  const int q_start = blockIdx.y * kBlockM;
  const int rows_valid = min(kBlockM, n_q - q_start);
  const int row = q_start + r;
  const int col_limit = last_visible(row, n_kv, causal);
  const int tile_limit = last_visible(q_start + rows_valid - 1, n_kv, causal);
  const int n_steps = tile_limit / kBlockN + 1;

  load_tile<T>(sm.q, q + (bh * n_q + q_start) * kHeadDim, rows_valid);

  float acc[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) acc[j] = 0.0f;
  float m_i = -INFINITY;  // running max, log2 units
  float l_i = 0.0f;       // running sum of exp2(s - m_i)

  for (int step = 0; step < n_steps; ++step) {
    const int kv_start = step * kBlockN;
    const int cols_valid = min(kBlockN, n_kv - kv_start);
    load_tile<T>(sm.k, k + (bh * n_kv + kv_start) * kHeadDim, cols_valid);
    load_tile<T>(sm.v, v + (bh * n_kv + kv_start) * kHeadDim, cols_valid);
    __syncthreads();

    float s[kHalf];
    scores(sm.q, sm.k, r, half, s);
    const int col0 = kv_start + half * kHalf;
    float step_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      s[j] *= scale_log2;
      if (col0 + j <= col_limit) step_max = fmaxf(step_max, s[j]);
    }
    // The pair of threads sharing a row are lanes 2i and 2i + 1 of a warp.
    step_max = fmaxf(step_max, __shfl_xor_sync(0xffffffffu, step_max, 1));
    const float m_next = fmaxf(m_i, step_max);
    // exp2(-inf) = 0 on the first step; a row that has seen no column yet
    // keeps m = -inf and adds nothing.
    const float alpha = m_next == -INFINITY ? 1.0f : exp2f(m_i - m_next);
    float row_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float p = col0 + j <= col_limit ? exp2f(s[j] - m_next) : 0.0f;
      row_sum += p;
      s[j] = p;
    }
#pragma unroll
    for (int j = 0; j < kHalf; j += 4) {
      *reinterpret_cast<float4*>(sm.p + r * kLdP + half * kHalf + j) =
          make_float4(s[j], s[j + 1], s[j + 2], s[j + 3]);
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    l_i = alpha * l_i + row_sum;
    m_i = m_next;
    __syncwarp();  // the partner's half of the P row

#pragma unroll
    for (int j = 0; j < kHalf; ++j) acc[j] *= alpha;
    accumulate_pv(sm.p + r * kLdP, sm.v, half, acc);
    // The next step's loads overwrite k, v and p.
    __syncthreads();
  }
  store_row<T>(o + (bh * n_q + row) * kHeadDim, acc, l_i, half, r < rows_valid);
}

// Folded: one block per (group of `fold` batch elements x head, 64-row query
// tile); n_kv <= kFoldedMaxKv.  The whole score row of each element lives
// in shared memory (srow, pitch ld_row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_v1_folded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int n_heads,
                           int n_q, int n_kv, int fold, int ld_row,
                           float scale_log2, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* skv = sq + kBlockM * kLd;        // a K tile, then a V tile
  float* srow = skv + kBlockN * kLd;      // [64][ld_row] scores, then P

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int group = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int q_start = blockIdx.y * kBlockM;
  const int rows_valid = min(kBlockM, n_q - q_start);
  const int row = q_start + r;
  const int col_limit = last_visible(row, n_kv, causal);
  const int n_chunks = (n_kv + kBlockN - 1) / kBlockN;
  float* prow = srow + r * ld_row;

  for (int f = 0; f < fold; ++f) {
    const size_t bh = (size_t)(group * fold + f) * n_heads + h;
    const T* kb = k + bh * n_kv * kHeadDim;
    const T* vb = v + bh * n_kv * kHeadDim;
    load_tile<T>(sq, q + (bh * n_q + q_start) * kHeadDim, rows_valid);

    // Score the whole row, 64 columns at a time, in log2 units.
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int kv_start = ch * kBlockN;
      load_tile<T>(skv, kb + (size_t)kv_start * kHeadDim, min(kBlockN, n_kv - kv_start));
      __syncthreads();
      float s[kHalf];
      scores(sq, skv, r, half, s);
#pragma unroll
      for (int j = 0; j < kHalf; j += 4) {
        *reinterpret_cast<float4*>(prow + kv_start + half * kHalf + j) =
            make_float4(s[j] * scale_log2, s[j + 1] * scale_log2,
                        s[j + 2] * scale_log2, s[j + 3] * scale_log2);
      }
      // The next chunk's load overwrites skv.
      __syncthreads();
    }

    // The max over the whole row, then exp2 and the sum in place: each
    // thread walks its half of every chunk.
    float m = -INFINITY;
    for (int ch = 0; ch < n_chunks; ++ch) {  // row max over every chunk
#pragma unroll 4
      for (int j = 0; j < kHalf; ++j) {
        const int c = ch * kBlockN + half * kHalf + j;
        if (c <= col_limit) m = fmaxf(m, prow[c]);
      }
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    float l = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
#pragma unroll 4
      for (int j = 0; j < kHalf; ++j) {
        const int c = ch * kBlockN + half * kHalf + j;
        const float p = c <= col_limit ? exp2f(prow[c] - m) : 0.0f;
        prow[c] = p;
        l += p;
      }
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);

    float acc[kHalf];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) acc[j] = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int kv_start = ch * kBlockN;
      load_tile<T>(skv, vb + (size_t)kv_start * kHeadDim, min(kBlockN, n_kv - kv_start));
      // Also orders every thread's P row writes before the reads below.
      __syncthreads();
      accumulate_pv(prow + kv_start, skv, half, acc);
      __syncthreads();
    }
    store_row<T>(o + (bh * n_q + row) * kHeadDim, acc, l, half, r < rows_valid);
  }
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

int folded_row_pitch(int n_kv) {
  return (n_kv + kBlockN - 1) / kBlockN * kBlockN + 4;
}

int folded_smem(int n_kv) {
  return (int)sizeof(float) * ((kBlockM + kBlockN) * kLd + kBlockM * folded_row_pitch(n_kv));
}

template <typename T>
cudaError_t launch_stream(const void* q, const void* k, const void* v, void* o,
                          int batch, int n_heads, int n_q, int n_kv, float sm_scale,
                          int causal, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = (int)sizeof(StreamSmem);
  cudaError_t err = allow_smem(flash_v1_kernel<T>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (n_q + kBlockM - 1) / kBlockM);
  flash_v1_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), n_q, n_kv, sm_scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_folded(const void* q, const void* k, const void* v, void* o,
                          int batch, int n_heads, int n_q, int n_kv, int fold,
                          float sm_scale, int causal, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  cudaError_t err = allow_smem(flash_v1_folded_kernel<T>, folded_smem(kFoldedMaxKv), done);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch / fold * n_heads, (n_q + kBlockM - 1) / kBlockM);
  flash_v1_folded_kernel<T><<<grid, kThreads, folded_smem(n_kv), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), n_heads, n_q, n_kv, fold, folded_row_pitch(n_kv),
      sm_scale * kLog2e, causal);
  return cudaGetLastError();
}

bool valid(int batch, int n_heads, int n_q, int n_kv, int head_dim, int causal) {
  return head_dim == kHeadDim && batch >= 1 && n_heads >= 1 && n_q >= 1 &&
         n_kv >= 1 && (!causal || n_q == n_kv) && n_q <= 65535 * kBlockM;
}

}  // namespace

// C entry points, bound with ctypes (kernels/flash_v1.py).  Pointers are
// device pointers of contiguous tensors: q, o [B, H, N_q, 64]; k, v [B, H,
// N_kv, 64] (equal head counts); causal requires n_q == n_kv.  dtype: 0 =
// bf16, 1 = fp32.  Each returns its launch's cudaError_t (0 on success).
extern "C" int fam_flash_v1(const void* q, const void* k, const void* v, void* o,
                            int batch, int n_heads, int n_q, int n_kv, int head_dim,
                            float sm_scale, int causal, int dtype, void* stream) {
  if (!valid(batch, n_heads, n_q, n_kv, head_dim, causal)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_stream<bf16>(q, k, v, o, batch, n_heads, n_q, n_kv, sm_scale,
                                    causal, s);
  }
  if (dtype == 1) {
    return (int)launch_stream<float>(q, k, v, o, batch, n_heads, n_q, n_kv, sm_scale,
                                     causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Folded: `fold` divides batch and n_kv <= 512.
extern "C" int fam_flash_v1_folded(const void* q, const void* k, const void* v,
                                   void* o, int batch, int n_heads, int n_q, int n_kv,
                                   int head_dim, int fold, float sm_scale, int causal,
                                   int dtype, void* stream) {
  if (!valid(batch, n_heads, n_q, n_kv, head_dim, causal) || fold < 1 ||
      batch % fold != 0 || n_kv > kFoldedMaxKv) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_folded<bf16>(q, k, v, o, batch, n_heads, n_q, n_kv, fold,
                                    sm_scale, causal, s);
  }
  if (dtype == 1) {
    return (int)launch_folded<float>(q, k, v, o, batch, n_heads, n_q, n_kv, fold,
                                     sm_scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
