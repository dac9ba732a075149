// Attention dropout inside the kernels: the keep mask of
// flash_attention_metal_tpu/kernels/_common.py::dropout_keep (lines 76-109;
// the port's plain side is kernels/_common.py), which the general forward
// (flash_fwd_sm90.cuh's FeatWalk, flash_fwd.cu's template) and the split
// backward pair (flash_bwd_sm90.cuh's CausalWalkT, flash_bwd.cu's fp32
// template) rebuild from nothing but a seed and each score's coordinates.
//
// Contract (flash_fwd.py:233-267, 372-400; flash_bwd.py:222-245, 380-386):
// the score of (bh, row, col) is kept, and its P multiplied by 1 / (1 -
// rate), when the lowbias32 hash
//   h = mix(mix(mix(seed ^ bh A) + row B) + col A)
// has (h & 0x7fffffff) >= threshold, threshold = min(round(rate 2^31),
// 2^31 - 1); else its P is dropped.  The coordinates are tensor indices,
// not positions: row and col the score's q row and KV column plus the
// packed row and column offsets, bh = (b + batch_off) * heads + (h +
// head_off) with h the q-head and heads the global head count (the local
// one by default).  The causal offset and the cache position never enter
// it.  The forward keeps the row statistics (m, l) and the lse of the
// undropped P and multiplies only the P of O += P V; the backward feeds
// dV the dropped P and forms dS = P (dP keep - delta) with the undropped P.
//
// Arithmetic in uint32_t: JAX hashes in int32 with wraparound products and
// logical shifts, the same bits as unsigned arithmetic here, whereas a
// signed overflow is undefined in C++ and a signed >> is arithmetic.
//
// Cost.  The two mixes that do not depend on the column are taken once
// per (bh, row) (row_hash); a score then costs one mix (two multiplies,
// three shift-xors), an add, the mask test and a select: about 11 integer
// operations beside the 4 D flops of its products.
//
// The seed and the offsets are read on the device, packed int32 [seed,
// row_off, col_off, batch_off, head_off] (_common.pack_dropout_seed): a new
// seed every step costs no host sync and no rebuild, the counterpart of
// JAX's traced seed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMixA = 0x9E3779B9u;  // golden-ratio increment
constexpr uint32_t kMixB = 0x85EBCA6Bu;  // murmur3 / lowbias32 multipliers
constexpr uint32_t kMixC = 0x7FEB352Du;
constexpr uint32_t kMixD = 0x846CA68Bu;

// The lowbias32 avalanche finalizer.
__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMixC;
  x ^= x >> 15;
  x *= kMixD;
  x ^= x >> 16;
  return x;
}

// A call's dropout, as the C entries take it: seed null for none.
struct Drop {
  const int* seed = nullptr;  // int32 [5] on the device: seed, row, col, batch, head offsets
  uint32_t threshold = 0;     // min(round(rate * 2^31), 2^31 - 1)
  float inv_keep = 1.0f;      // fp32 of 1 / (1 - rate)
  int heads = 0;              // the (b, h) stream's head count
  __host__ __device__ bool on() const { return seed != nullptr; }
};

// One block's view of a call's dropout: the packed seed read once, for
// batch b.
struct DropBlock {
  uint32_t seed, row_off, col_off, bh0, threshold;
  float inv_keep;
  __device__ __forceinline__ DropBlock() : seed(0), row_off(0), col_off(0), bh0(0),
                                           threshold(0), inv_keep(1.0f) {}
  __device__ __forceinline__ DropBlock(const Drop& d, int b) {
    seed = (uint32_t)d.seed[0];
    row_off = (uint32_t)d.seed[1];
    col_off = (uint32_t)d.seed[2];
    bh0 = ((uint32_t)b + (uint32_t)d.seed[3]) * (uint32_t)d.heads + (uint32_t)d.seed[4];
    threshold = d.threshold;
    inv_keep = d.inv_keep;
  }
  // The first mix, of q-head h's stream.
  __device__ __forceinline__ uint32_t head_hash(int h) const {
    return mix32(seed ^ ((bh0 + (uint32_t)h) * kMixA));
  }
  // The part of the hash of q row r (a tensor index) that no column
  // changes.
  __device__ __forceinline__ uint32_t row_hash(uint32_t head, int r) const {
    return mix32(head + ((uint32_t)r + row_off) * kMixB);
  }
  // The term of KV column c (a tensor index).  A score's hash input is its
  // row hash plus its column's term; a column dc to the right adds dc *
  // kMixA, a constant in the kernels' unrolled loops.
  __device__ __forceinline__ uint32_t col_term(int c) const {
    return ((uint32_t)c + col_off) * kMixA;
  }
  // The keep factor {0, 1 / (1 - rate)} of a score whose hash input is x.
  __device__ __forceinline__ float keep(uint32_t x) const {
    return (mix32(x) & 0x7fffffffu) >= threshold ? inv_keep : 0.0f;
  }
};

}  // namespace
