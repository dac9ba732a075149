// The score transforms: the tanh softcap and the ALiBi bias, which the
// general forward (flash_fwd_sm90.cuh's FeatWalk, flash_fwd.cu's template,
// flash_decode.cuh), the split backward pair (flash_bwd_sm90.cuh's
// CausalWalkT, flash_bwd.cu's fp32 template) and the cache kernels take.
//
// Contract (flash_attention_metal_tpu/kernels/flash_fwd.py:146-173,
// flash_bwd.py:180-265): on the natural scaled score s = sm_scale * s_k *
// (q . k) (s_k the 8-bit cache's K scale, 1 otherwise), first the softcap
// s -> cap * tanh(s / cap), then the bias s -> s + slope_h * (c - p), with
// slope_h the q-head's fp32 slope and p the row's position (r + the batch's
// q_offset, also when the call is not causal); then the mask.  The kernels
// work in log2 units: with a cap, t = c2 * tanh(raw * sm_scale / cap) with
// c2 = cap * log2 e; without one, t = raw * sm_scale * log2 e; the bias
// adds slope_h * log2 e * (c - p).  In the backward, dS = P (dP - delta) is
// the cotangent of the transformed score: d_slopes[h] gathers dS * (c - p)
// over the pairs, before the softcap's chain dS *= 1 - u^2 (u = tanh(...),
// recovered as t / c2), and sm_scale stays in the epilogue.
//
// Precision: a row whose visible columns all lie far from it (ALiBi with
// a window's sinks far behind, or not causal) scores in the thousands of
// log2 units, where an fp32 score keeps only 2^-12 to 2^-11: rounding t +
// bias there and then subtracting the row's max would err by ~2e-4 in
// every P.  So the bias enters the exponent in one FMA with the reference
// it is measured against, t + fma(slope2, dist, -ref) (the row max in the
// forward, lse in the backward): near the max the result is small and
// exact to fp32's relative precision.  The max itself may take the rounded
// t + bias: it is only the reference.
//
// The kernels take the transforms as a template flag (kXf) on their
// featured walks, so an untransformed call runs the code it ran before.
// Inside a flagged instance the cap (0: none) and the slopes (null: none)
// are read at run time: no cap is c2 = 0, and then u = t * (1 / c2) is
// taken as 0 (its chain factor 1); no ALiBi is a slope of 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kXfLog2e = 1.4426950408889634f;

// tanh(x).  kExact (the fp32 kernels, held at 1e-5): tanhf.  Otherwise (the
// bf16 kernels) tanh.approx.f32, one MUFU op beside the softmax's exp2: its
// ~5e-4 relative error, times the cap (up to ~43 log2 units at cap 30),
// moves the lse by ~1e-4 and the output not at all beside its bf16 rounding
// (tests/test_torch_gpu.py::test_xf_tanh_choice, PERF.md §6: on the peaked
// fixture at caps 20 and 30 the lse read 6e-5 to 1.1e-4 against the bound
// of 1e-2, o unchanged at 3e-3).  1 - 2 / (2^(2 x log2 e) + 1) on ex2 and
// rcp, two MUFU ops, read 3e-6 to 4e-6 and cost the capped forward 1.53x
// its untransformed time at D 64.
template <bool kExact>
__device__ __forceinline__ float xf_tanh(float x) {
  if constexpr (kExact) {
    return tanhf(x);
  } else {
    float y;
    asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  }
}

// One q-head's transforms in a kernel's log2 units.
struct XfHead {
  bool cap;       // a softcap is set
  float pre;      // raw product -> tanh argument (sm_scale / cap), else -> log2 units
  float c2;       // cap * log2 e (0: no cap)
  float inv_c2;   // 1 / c2 (0: no cap)
  float slope2;   // slope_h * log2 e (0: no ALiBi)

  __device__ __forceinline__ XfHead() : cap(false), pre(0.0f), c2(0.0f), inv_c2(0.0f),
                                        slope2(0.0f) {}
  // softcap: 0 for none; slopes: fp32 [H_q] or null; h: the q-head.  An
  // 8-bit cache's K scale is on the raw product the caller passes.
  __device__ __forceinline__ XfHead(float softcap, const float* slopes, int h, float sm_scale) {
    cap = softcap > 0.0f;
    pre = cap ? sm_scale / softcap : sm_scale * kXfLog2e;
    c2 = cap ? softcap * kXfLog2e : 0.0f;
    inv_c2 = cap ? 1.0f / c2 : 0.0f;
    slope2 = slopes != nullptr ? slopes[h] * kXfLog2e : 0.0f;
  }
  // The capped score t in log2 units of a raw product (before the bias).
  template <bool kExact>
  __device__ __forceinline__ float capped(float raw) const {
    return cap ? c2 * xf_tanh<kExact>(raw * pre) : raw * pre;
  }
  // The bias of a pair at distance c - p, log2 units.
  __device__ __forceinline__ float bias(float dist) const { return slope2 * dist; }
  // t + bias - ref, the bias and the reference in one FMA (see above).
  __device__ __forceinline__ float shifted(float t, float dist, float ref) const {
    return t + fmaf(slope2, dist, -ref);
  }
  // The softcap's chain factor 1 - u^2 of a capped score t (1: no cap).
  __device__ __forceinline__ float chain(float t) const {
    const float u = t * inv_c2;
    return 1.0f - u * u;
  }
};

// Capped scores in place over a fragment: the branch on the cap is taken
// once for the whole fragment, not per element.
template <bool kExact, int N>
__device__ __forceinline__ void xf_cap(const XfHead& x, float (&s)[N]) {
  if (x.cap) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = x.c2 * xf_tanh<kExact>(s[i] * x.pre);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= x.pre;
  }
}

// A warp's sum of v, written by lane 0 to *dst: a d_slopes partial.  The
// fp32 kernels accumulate theirs in double: d_slopes is a sum of dS * dist
// that cancels (dS sums to 0 over a row), so an fp32 accumulator's
// rounding, relative to the terms, shows at 1e-5 of the result.
template <typename A>
__device__ __forceinline__ void xf_warp_store(A v, float* dst) {
#pragma unroll
  for (int w = 16; w > 0; w /= 2) v += __shfl_xor_sync(0xffffffffu, v, w);
  if ((threadIdx.x & 31) == 0) *dst = (float)v;
}

// Warps of the kernels' 128-thread blocks: d_slopes partials per (batch,
// q-head, KV tile, warp), fp32 [B, H_q, n_kv_tiles, kXfWarps], zero where
// no step ran; the wrapper sums them (kernels/flash_bwd.py).
constexpr int kXfWarps = 4;

}  // namespace
