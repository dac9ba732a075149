// Naive O(N^2) attention for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces flash_attention_metal_tpu/kernels/naive.py::_naive_kernel, the
// denominator of the benchmark's speedup and the ladder's first rung.
//
// Contract, for every batch b, head h (equal head counts) and query row r:
//   s[c] = sm_scale * q[b,h,r] . k[b,h,c]   over every column c < n_kv,
//   s[c] = mask value (-0.7 * FLT_MAX) where causal and c > r + (n_kv - n_q)
//   (end-aligned diagonal), then a two-pass softmax over the WHOLE row: the
//   row max first, then exp, sum and P . V.  No online statistics, no lse.
//   Everything is computed in fp32 (IEEE FMA, never TF32) whatever the input
//   type; o comes back in q's type.  A row that sees no column gives
//   mean(V), exactly as the Pallas kernel does.
//
// What bounds it on the H100.  It does 4 * N_q * N_kv * D flops per head
// (head dim D = 64 or 128) in fp32 on the CUDA cores (67 TF/s), so at the
// benchmark's sweep points (B * N^2 = 2^23, D = 64) the bound is ~32 us.
// Its design is what makes it the baseline: nothing is tiled or reused
// across query rows.
//
// The design.  One warp per query row, four rows per block.  The row's fp32
// scores live in shared memory (4 B per column: 32 KB per row at N = 8192,
// the most the sweep asks of it; kMaxKv).  K and V are read from global
// memory (through L2) once for every query row: lane l scores columns
// l, l + 32, ..., each a D-term dot product against the query row held in
// registers; then each lane owns D / 32 output columns and walks every key
// row of V.  Masked columns are scored and exponentiated like any other, so
// a causal call does the full N^2 work, as the Pallas kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowsPerBlock = 4;  // one warp per query row
constexpr int kThreads = 32 * kRowsPerBlock;
// Longest score row shared memory holds: 4 rows x 8192 x 4 B = 128 KB.
constexpr int kMaxKv = 8192;
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    naive_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n_q,
                 int n_kv, float sm_scale, int causal) {
  extern __shared__ __align__(16) float scores_raw[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= n_q) return;  // no block-wide barrier below
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const T* q_row = q + (bh * n_q + row) * D;
  const T* k_head = k + bh * n_kv * D;
  const T* v_head = v + bh * n_kv * D;
  float* s = scores_raw + (size_t)warp * n_kv;
  // Last column the row sees when causal (end-aligned diagonal).
  const int limit = row + (n_kv - n_q);

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; d += 8) {
    float x[8];
    load8(q_row + d, x);
#pragma unroll
    for (int j = 0; j < 8; ++j) qr[d + j] = x[j];
  }

  // Pass 1: every score of the row, masked, and the row max.
  float row_max = -INFINITY;
  for (int c = lane; c < n_kv; c += 32) {
    const T* k_row = k_head + (size_t)c * D;
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < D; d += 8) {
      float x[8];
      load8(k_row + d, x);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(qr[d + j], x[j], acc);
    }
    const bool visible = !causal || c <= limit;
    const float sc = visible ? acc * sm_scale : kMaskValue;
    s[c] = sc;
    row_max = fmaxf(row_max, sc);
  }
  row_max = warp_max(row_max);

  // Pass 2: exp and sum; the probability overwrites its score.
  float row_sum = 0.0f;
  for (int c = lane; c < n_kv; c += 32) {
    const float p = expf(s[c] - row_max);
    s[c] = p;
    row_sum += p;
  }
  row_sum = warp_sum(row_sum);
  __syncwarp();

  // P . V: lane l owns output columns l, l + 32, ...
  constexpr int kCols = D / 32;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
#pragma unroll 8
  for (int c = 0; c < n_kv; ++c) {
    const float p = s[c];
    const T* v_row = v_head + (size_t)c * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = fmaf(p, to_float(v_row[lane + 32 * j]), acc[j]);
  }
  const float inv = 1.0f / row_sum;
  T* o_row = o + (bh * n_q + row) * D;
#pragma unroll
  for (int j = 0; j < kCols; ++j) o_row[lane + 32 * j] = from_float<T>(acc[j] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int n_heads, int n_q, int n_kv, float sm_scale,
                   int causal, cudaStream_t stream) {
  // The dynamic shared-memory limit is raised once per device, to the most
  // any call asks.
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(naive_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kRowsPerBlock * kMaxKv * sizeof(float)));
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((n_q + kRowsPerBlock - 1) / kRowsPerBlock, n_heads, batch);
  const size_t smem = (size_t)kRowsPerBlock * n_kv * sizeof(float);
  naive_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_q, n_kv, sm_scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (kernels/naive.py).  Pointers are device
// pointers of contiguous [B, H, N, D] tensors, D = head_dim, 64 or 128 (q,
// o: N = n_q; k, v: N = n_kv <= 8192).  dtype: 0 = bf16, 1 = fp32.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int fam_naive(const void* q, const void* k, const void* v, void* o,
                         int batch, int n_heads, int n_q, int n_kv,
                         int head_dim, float sm_scale, int causal, int dtype,
                         void* stream) {
  if (batch < 1 || n_heads < 1 || n_q < 1 || n_kv < 1 || n_kv > kMaxKv) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FAM_LAUNCH(T, D) \
  return (int)launch<T, D>(q, k, v, o, batch, n_heads, n_q, n_kv, sm_scale, causal, s)
  if (dtype == 0 && head_dim == 64) FAM_LAUNCH(bf16, 64);
  if (dtype == 0 && head_dim == 128) FAM_LAUNCH(bf16, 128);
  if (dtype == 1 && head_dim == 64) FAM_LAUNCH(float, 64);
  if (dtype == 1 && head_dim == 128) FAM_LAUNCH(float, 128);
#undef FAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
