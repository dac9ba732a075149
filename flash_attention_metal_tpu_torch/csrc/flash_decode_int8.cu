// The split-KV decode grid (flash_decode.cuh) over an int8 cache with per-token scales: its
// instances for bf16 and fp32 q, dense and paged, head dim 64 and 128, in a
// translation unit of their own so that nvcc builds them beside the others.

#include "flash_decode.cuh"

cudaError_t fam::flash_decode_int8(const DecodeCall& call, int dtype, int head_dim,
                                   bool paged) {
  return decode_for<int8_t>(call, dtype, head_dim, paged);
}
