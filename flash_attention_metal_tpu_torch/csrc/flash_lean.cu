// Single-KV-extent ("lean") forward attention for Hopper (sm_90a), bf16
// and fp32, head dim 64 or 128.
//
// Replaces flash_attention_metal_tpu/kernels/flash_fwd.py::_fwd_kernel_lean,
// the forward the router takes when the whole KV row fits one block
// (n_kv <= 1024) and the causal offset is a static int: the benchmark's
// non-causal sweep at N <= 1024 and the ladder's rungs 3-5.
//
// Contract, for every batch b, q-head h (KV head h / group) and query row r:
//   o[b,h,r,:] = softmax_c(s) . V,  s = sm_scale * q[b,h,r] . k[b,h/group,c]
// over the columns c < n_kv and, when causal, c <= r + q_offset, with
// q_offset an int given at launch.  The softmax is exact with no online
// rescale: the max over the whole row first, then exp2, the sum and P . V.
// The optional lse is the natural-log logsumexp per row, fp32 [B, H, N_q].
// A row with no visible column gives o = 0 and lse = -inf (the Pallas lean
// path gives mean(V) there; such rows need a negative offset).  Scores,
// statistics and products accumulate in fp32; fp32 inputs use IEEE FMA.
//
// What bounds it on the H100.  At the sweep's small-N points (N = 128,
// B = 512) a head does 4 * N^2 * 64 flops against 4 * N * 64 elements of
// I/O: ~N / 4 flops per byte in bf16, far below the tensor cores' ~295, so
// N = 128 is bound by HBM bytes and N = 1024 is near the balance point.
//
// What the design does about it.  One block per 16 query rows (4096 blocks
// at N = 128, B = 512, so every SM is busy); Q, K and V are read from HBM
// once per block and the row block's whole fp32 score tile [16, n_kv] stays
// in shared memory, sized by n_kv (8 KB at N = 128, 64 KB at N = 1024), so
// short rows keep many blocks resident.  Pass 1 fills it from 64-column K
// tiles (WMMA bf16 16x16x16 with fp32 accumulators, or FMA in fp32); one
// pass takes each row's max, exp2 and sum; pass 2 multiplies P by 64-row V
// tiles into one accumulator per warp.
// Not yet done (later PRs): wgmma, TMA, and more rows per block at N = 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 16;   // query rows per block
constexpr int kBlockN = 64;   // K/V rows per tile
constexpr int kThreads = 128;            // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSub = kThreads / kBlockM;  // threads per row outside the MMAs
constexpr int kMaxKv = 1024;
// D, the head dim (64 or 128): Q/K/V tile pitch and fp32 output tile pitch
// (elements).
template <int D>
struct Dims {
  static constexpr int kLdT = D + 8;
  static constexpr int kLdO = D + 4;
  static constexpr int kOutFrags = D / 16 / kWarps;  // output fragments per warp
};
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

// Shared-memory layout for a score row of n_kv_pad (a multiple of 64)
// columns and head dim d.  bf16 keeps P in its own tile for the tensor
// cores; fp32 writes P over the scores.  The bf16 output tile reuses the
// score tile, which is sized to hold it ([16][d + 4]) at short rows.
struct Layout {
  int ld_s, ld_p;
  size_t q, kv, s, p, stats, total;
  __host__ __device__ Layout(int n_kv_pad, int d, int elem, bool separate_p) {
    ld_s = n_kv_pad + 4;
    ld_p = n_kv_pad + 8;
    const int ld_t = d + 8;
    const int s_cols = ld_s > d + 4 ? ld_s : d + 4;
    q = 0;
    kv = align128(q + (size_t)kBlockM * ld_t * elem);
    s = align128(kv + (size_t)kBlockN * ld_t * elem);
    p = align128(s + (size_t)kBlockM * s_cols * sizeof(float));
    stats = align128(p + (separate_p ? (size_t)kBlockM * ld_p * elem : 0));
    total = stats + 2 * kBlockM * sizeof(float);
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Copy `kRows` rows of D elements (row pitch D in global memory) into
// shared memory with pitch kLdT; rows >= rows_valid are zero.
template <typename T, int kRows, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows_valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int kLdT = Dims<D>::kLdT;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_lean_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int n_heads, int n_kv_heads,
                      int n_q, int n_kv, float scale_log2, int causal,
                      int q_offset) {
  using namespace nvcuda;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kLdT = Dims<D>::kLdT, kLdO = Dims<D>::kLdO, kOutFrags = Dims<D>::kOutFrags;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n_tiles = (n_kv + kBlockN - 1) / kBlockN;
  const Layout lay(n_tiles * kBlockN, D, (int)sizeof(T), kBf16);
  T* sq = reinterpret_cast<T*>(smem_raw + lay.q);
  T* skv = reinterpret_cast<T*>(smem_raw + lay.kv);
  float* ss = reinterpret_cast<float*>(smem_raw + lay.s);
  T* sp = reinterpret_cast<T*>(smem_raw + lay.p);  // bf16 only
  float* row_m = reinterpret_cast<float*>(smem_raw + lay.stats);
  float* row_l = row_m + kBlockM;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int r = tid / kSub;    // this thread's row outside the MMAs
  const int sub = tid % kSub;  // its column phase in that row
  const int q_start = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int h_kv = h / (n_heads / n_kv_heads);
  const size_t q_rows = ((size_t)b * n_heads + h) * n_q;
  const size_t kv_rows = ((size_t)b * n_kv_heads + h_kv) * n_kv;
  const int rows_valid = min(kBlockM, n_q - q_start);
  const int row = q_start + r;
  // Columns [0, n_visible) of this thread's row are visible.
  int n_visible = 0;
  if (r < rows_valid) n_visible = causal ? max(0, min(n_kv, row + q_offset + 1)) : n_kv;

  load_tile<T, kBlockM, D>(sq, q + (q_rows + q_start) * D, rows_valid);

  // Pass 1: the score tile S = Q K^T, [16, n_kv], one K tile at a time.
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kBlockN;
    load_tile<T, kBlockN, D>(skv, k + (kv_rows + c0) * D, min(kBlockN, n_kv - c0));
    __syncthreads();
    if constexpr (kBf16) {
      // Warp w: the 16 x 16 block of columns c0 + 16w.
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sq + kk, kLdT);
        // K^T as a column-major B operand: element (d, c) sits at k[c][d].
        wmma::load_matrix_sync(fb, skv + warp * 16 * kLdT + kk, kLdT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ss + c0 + warp * 16, acc, lay.ld_s, wmma::mem_row_major);
    } else {
      // Thread (r, sub): columns sub, sub + 8, ... of the tile.
      float acc[kBlockN / kSub];
#pragma unroll
      for (int j = 0; j < kBlockN / kSub; ++j) acc[j] = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float qv = sq[r * kLdT + d];
#pragma unroll
        for (int j = 0; j < kBlockN / kSub; ++j) {
          acc[j] = fmaf(qv, skv[(sub + kSub * j) * kLdT + d], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBlockN / kSub; ++j) ss[r * lay.ld_s + c0 + sub + kSub * j] = acc[j];
    }
    __syncthreads();  // the next tile's load overwrites skv
  }

  // Exact softmax per row: the max over every visible column, then exp2
  // and the sum.  Masked and padding columns get p = 0.  The kSub threads
  // of a row are adjacent lanes of one warp.
  const int n_cols = n_tiles * kBlockN;
  const float* srow = ss + r * lay.ld_s;
  float row_max = -INFINITY;
  for (int c = sub; c < n_visible; c += kSub) row_max = fmaxf(row_max, srow[c]);
#pragma unroll
  for (int s = kSub / 2; s > 0; s >>= 1) {
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, s));
  }
  const float m2 = row_max * scale_log2;  // log2 units (scale > 0)
  float row_sum = 0.0f;
  for (int c = sub; c < n_cols; c += kSub) {
    const float p = c < n_visible ? exp2f(srow[c] * scale_log2 - m2) : 0.0f;
    row_sum += p;
    if constexpr (kBf16) {
      sp[r * lay.ld_p + c] = from_float<T>(p);
    } else {
      ss[r * lay.ld_s + c] = p;
    }
  }
#pragma unroll
  for (int s = kSub / 2; s > 0; s >>= 1) {
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, s);
  }
  if (sub == 0) {
    row_m[r] = m2;
    row_l[r] = row_sum;
  }
  __syncthreads();

  // Pass 2: O = P V over 64-row V tiles.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag[kOutFrags];
  float o_reg[D / kSub];
  if constexpr (kBf16) {
#pragma unroll
    for (int f = 0; f < kOutFrags; ++f) wmma::fill_fragment(o_frag[f], 0.0f);
  } else {
#pragma unroll
    for (int j = 0; j < D / kSub; ++j) o_reg[j] = 0.0f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kBlockN;
    load_tile<T, kBlockN, D>(skv, v + (kv_rows + c0) * D, min(kBlockN, n_kv - c0));
    __syncthreads();
    if constexpr (kBf16) {
      // Warp w: output columns 16 (w + 4 f) .. 16 (w + 4 f) + 15.
#pragma unroll
      for (int kk = 0; kk < kBlockN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sp + c0 + kk, lay.ld_p);
#pragma unroll
        for (int f = 0; f < kOutFrags; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, skv + kk * kLdT + (warp + kWarps * f) * 16, kLdT);
          wmma::mma_sync(o_frag[f], fa, fb, o_frag[f]);
        }
      }
    } else {
      // Thread (r, sub): output columns sub, sub + 8, ...
      for (int c = 0; c < kBlockN; ++c) {
        const float p = ss[r * lay.ld_s + c0 + c];
#pragma unroll
        for (int j = 0; j < D / kSub; ++j) {
          o_reg[j] = fmaf(p, skv[c * kLdT + sub + kSub * j], o_reg[j]);
        }
      }
    }
    __syncthreads();  // the next tile's load overwrites skv
  }

  if constexpr (kBf16) {
    // The score tile is free now: stage the fp32 output through it (the
    // layout sizes it for [16][kLdO]).
#pragma unroll
    for (int f = 0; f < kOutFrags; ++f) {
      wmma::store_matrix_sync(ss + (warp + kWarps * f) * 16, o_frag[f], kLdO, wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < D / kSub; ++j) o_reg[j] = ss[r * kLdO + sub + kSub * j];
  }
  if (r < rows_valid) {
    const float l = row_l[r];
    const float inv_l = l > 0.0f ? 1.0f / l : 0.0f;
    T* dst = o + (q_rows + row) * D;
#pragma unroll
    for (int j = 0; j < D / kSub; ++j) dst[sub + kSub * j] = from_float<T>(o_reg[j] * inv_l);
    if (lse != nullptr && sub == 0) {
      lse[q_rows + row] = l > 0.0f ? (row_m[r] + log2f(l)) * kLn2 : -INFINITY;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int n_heads, int n_kv_heads, int n_q,
                   int n_kv, float sm_scale, int causal, int q_offset,
                   cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // The dynamic shared-memory limit is raised once per device, to the most
  // any call asks (n_kv = kMaxKv).
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_lean_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout(kMaxKv, D, sizeof(T), kBf16).total);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const int n_kv_pad = (n_kv + kBlockN - 1) / kBlockN * kBlockN;
  const size_t smem = Layout(n_kv_pad, D, sizeof(T), kBf16).total;
  const dim3 grid((n_q + kBlockM - 1) / kBlockM, n_heads, batch);
  flash_lean_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      n_heads, n_kv_heads, n_q, n_kv, sm_scale * kLog2e, causal, q_offset);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (kernels/flash_fwd.py).  Pointers are
// device pointers of contiguous tensors: q, o [B, H, N_q, D]; k, v
// [B, H_kv, N_kv, D] with N_kv <= 1024 and D = head_dim, 64 or 128; lse
// fp32 [B, H, N_q] or null.
// q_offset is read only when causal.  dtype: 0 = bf16, 1 = fp32.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int fam_flash_lean(const void* q, const void* k, const void* v,
                              void* o, void* lse, int batch, int n_heads,
                              int n_kv_heads, int n_q, int n_kv, int head_dim,
                              float sm_scale, int causal, int q_offset,
                              int dtype, void* stream) {
  if (n_kv_heads < 1 || n_heads % n_kv_heads != 0 || batch < 1 || n_q < 1 || n_kv < 1 ||
      n_kv > kMaxKv) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FAM_LAUNCH(T, D)                                                                     \
  return (int)launch<T, D>(q, k, v, o, lse, batch, n_heads, n_kv_heads, n_q, n_kv, sm_scale, \
                           causal, q_offset, s)
  if (dtype == 0 && head_dim == 64) FAM_LAUNCH(bf16, 64);
  if (dtype == 0 && head_dim == 128) FAM_LAUNCH(bf16, 128);
  if (dtype == 1 && head_dim == 64) FAM_LAUNCH(float, 64);
  if (dtype == 1 && head_dim == 128) FAM_LAUNCH(float, 128);
#undef FAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
