// Hopper (sm_90a) building blocks of the port's wgmma kernels: the forward
// (flash_fwd_sm90.cuh, dense and block-sparse), the split backward pair
// (flash_bwd_sm90.cuh, causal and block-sparse) and the fused backward
// (flash_bwd_fused_sm90.cuh).
//
// One warpgroup (128 threads, 4 warps of 16 rows) per 64-row output tile.
// Tiles are bf16, copied global -> shared with cp.async and stored in
// wgmma's 128-byte-swizzle layout (16-byte chunk c of row r at c ^ (r & 7),
// in 64-column blocks), so neither the copies nor the tensor cores' reads
// conflict on banks.  Products are wgmma.m64nNk16 (bf16 in, fp32
// accumulate): both operands from shared memory through descriptors, or A
// from registers.  A 64-row accumulator's layout is the A-register layout
// of the next product, so a score tile turns into an A operand without
// leaving registers (acc_to_a).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup: 4 warps of 16 rows
constexpr int kTile = 64;      // rows a block owns
constexpr int kStages = 2;     // the walked tiles' ring
constexpr int kAlign = 1024;   // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;  // devices a launcher raises its shared-memory limit on

// Element offset of 16-byte chunk c of row r in a [kRows][D] tile, stored
// as D / 64 column blocks of [kRows][64] with the 128-byte swizzle (chunk
// c of a block row at c ^ (r & 7)): wgmma's canonical layout, both K-major
// (the product's K along the row) and MN-major (K down the rows).
template <int kRows>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * (kRows * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// This thread's copies have landed and are visible to wgmma's reads (the
// async proxy); a barrier then publishes every thread's.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `rows_valid` rows of D elements (row pitch D) into a swizzled
// [kRows][D] tile; the other rows are zero.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows_valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool valid = r < rows_valid;
    cp_async16(dst + swz<kRows>(r, c), src + (valid ? (size_t)r * D + c * 8 : 0), valid);
  }
}

// `rows_valid` int32 segment ids into [kRows] (a bit-tile stage); the rest
// zero.
template <int kRows>
__device__ __forceinline__ void load_ids(uint32_t* dst, const int* src, int rows_valid) {
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const bool valid = i < rows_valid;
    cp_async4(dst + i, src + (valid ? i : 0), valid);
  }
}

// `rows_valid` fp32 row values (lse or delta) into [kRows]; the rest zero.
template <int kRows>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int rows_valid) {
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    cp_async4(dst + i, src + (i < rows_valid ? i : 0), i < rows_valid);
  }
}

// `kRows` rows from `row0` of bit tile `tile` of a block-sparse mask's
// bit_tiles (64 rows of 2 words, kernels/flash_mask.py::compile_tables)
// into a ring stage: kRows / 2 chunks of 16 bytes.
template <int kRows>
__device__ __forceinline__ void load_bits(uint32_t* dst, const uint32_t* bit_tiles, int tile,
                                          int row0) {
  if (threadIdx.x < kRows / 2) {
    const uint32_t* src = bit_tiles + ((size_t)tile * kTile + row0) * 2;
    cp_async16(dst + threadIdx.x * 4, src + threadIdx.x * 4, true);
  }
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: the product's K runs along the tile's rows (Q K^T reads
// K and Q this way).  k-step kk: columns 16 kk .. 16 kk + 15; 8-row groups
// 1024 bytes apart.
template <int kRows>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return make_desc(tile + (kk >> 2) * (kRows * 64) + (kk & 3) * 16, 16, 1024);
}

// MN-major operand: the product's K runs down the tile's rows and N along
// them (dS K reads K this way).  k-step kk: rows 16 kk .. 16 kk + 15; 8-row
// groups 1024 bytes apart, 64-column blocks kRows x 128 bytes apart.
template <int kRows>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return make_desc(tile + kk * 16 * 64, kRows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// Commit the products queued since the last commit and wait for them; the
// accumulators are then read by ordinary code.
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&acc)[N]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}
// Commit the products queued since the last commit as one group, and wait
// until at most N committed groups are still in flight (groups finish in
// order); fence_acc then hands the finished accumulators to ordinary code.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait_groups() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// d (m64n32, fp32) += a b; a and b (K-major) from shared memory.
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (m64n64, fp32) += a b; a and b (K-major) from shared memory.
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (m64n32, fp32) += a b; a MN-major (transposed: M along the tile's
// rows) and b K-major, both from shared memory.
__device__ __forceinline__ void wgmma_ta(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (m64n64, fp32) += a b; a K-major and b MN-major, both from shared memory.
__device__ __forceinline__ void wgmma_tb(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (m64n64, fp32) += a b; a from registers, b (MN-major) from shared memory.
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n128, fp32) += a b; a from registers, b (MN-major) from shared memory.
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of one k16 step from the accumulator's two n8 tiles that
// cover its 16 columns (8 floats: tile 2 kk, then 2 kk + 1), rounded to
// bf16: the accumulator layout of a 64-row product is its A-register layout.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* acc) {
  a[0] = pack_bf16(acc[0], acc[1]);
  a[1] = pack_bf16(acc[2], acc[3]);
  a[2] = pack_bf16(acc[4], acc[5]);
  a[3] = pack_bf16(acc[6], acc[7]);
}

// Four 8 x 8 bf16 blocks of a warp's packed accumulator (a[i]: block i,
// this lane's pair in row lane / 4), stored transposed: lane l gives the
// address of row l % 8 of block l / 8 as stored, 16 bytes.
__device__ __forceinline__ void stmatrix_trans(bf16* row, const uint32_t (&a)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_addr(row)),
               "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])
               : "memory");
}

// Row `half` (0: g, 1: g + 8) of this thread's rows of a [64][D] fp32
// accumulator, scaled, to dst (2 columns per n8 tile).
template <int D>
__device__ __forceinline__ void store_row(bf16* dst, const float (&acc)[D / 2], int half,
                                          float scale, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * t) =
        pack_bf16(acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
  }
}

// The same rows in fp32 (float2 stores).
template <int D>
__device__ __forceinline__ void store_row(float* dst, const float (&acc)[D / 2], int half,
                                          float scale, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(dst + j * 8 + 2 * t) =
        make_float2(acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
  }
}

// The block's shared memory, 1024-byte aligned (the swizzle atoms').
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlign - (smem_addr(raw) & (kAlign - 1))) & (kAlign - 1));
}

}  // namespace sm90
}  // namespace
