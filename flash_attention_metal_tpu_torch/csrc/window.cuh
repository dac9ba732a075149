// The sliding window with attention sinks, and packed segment ids: the
// masking features every dense walk of the forward, backward and decode
// kernels takes (flash_fwd_sm90.cuh, flash_fwd.cu, flash_decode.cuh,
// flash_bwd_sm90.cuh, flash_bwd_fused_sm90.cuh, flash_bwd.cu).
//
// Contract (flash_attention_metal_tpu/kernels/flash_fwd.py:189-219): a row
// at position p sees column c when c <= p and (c > p - window or c <
// sinks); with segment ids, also only when its id equals the column's.  A
// window needs causal.  The kernels take "no window" as kNoWindow, so the
// test needs no branch: p - kNoWindow lies below every column.
//
// Out-of-window KV tiles are skipped, not masked: a Q tile's walk is the
// sink tiles, then the tiles from the first row's window to the last row's
// diagonal (kv_runs), and a KV tile's walk over Q tiles ends at the last
// row whose window reaches it, unless the tile holds sinks (q_end).  The
// two are the same relation seen from either side, so the fused backward's
// ordered dQ adds (dq_ordered.cuh) can count a Q tile's adders from the Q
// side while every adder walks it from the KV side.  Segment ids skip no
// tile (as in JAX): they are an element test on every step.  The kernels
// take the features as a template flag: a call without them runs the
// causal walks as they were, with no window state in registers (each
// register a thread holds counts: measured on the H100, PERF.md §6).

#pragma once

#include <cuda_runtime.h>

#include "dropout.cuh"
#include "xf.cuh"

namespace {

// Far past any position: p - kNoWindow < 0 <= c, and c > p - kNoWindow
// holds for every column without an int overflow.
constexpr int kNoWindow = 1 << 30;

// The features of a call.  window: kNoWindow for none (then sinks is 0);
// q_seg, kv_seg: int32 [B, N_q] and [B, N_kv], or null for none; the score
// transforms (xf.cuh): softcap 0 for none, slopes fp32 [H_q] or null;
// drop: attention dropout (dropout.cuh; the general forward and the split
// pair only), its seed null for none; kv_pos: a rolling cache's int32
// [B, N_kv] positions (the forward kernels over a dense cache), or null.
struct Feat {
  int window = kNoWindow;
  int sinks = 0;
  const int* q_seg = nullptr;
  const int* kv_seg = nullptr;
  float softcap = 0.0f;
  const float* slopes = nullptr;
  Drop drop = {};
  const int* kv_pos = nullptr;
  __host__ __device__ bool xf() const { return softcap > 0.0f || slopes != nullptr; }
};

// A C entry's window argument (0: none) as the kernels take it.
__host__ __forceinline__ int window_or_none(int window) { return window > 0 ? window : kNoWindow; }

// Two runs of tiles, [a0, a1) then [b0, b1): a walk's steps in order.
struct TileRuns {
  int a0, a1, b0, b1;
  __host__ __device__ __forceinline__ int n_a() const { return a1 > a0 ? a1 - a0 : 0; }
  __host__ __device__ __forceinline__ int steps() const {
    return n_a() + (b1 > b0 ? b1 - b0 : 0);
  }
  // Step j's tile.
  __host__ __device__ __forceinline__ int tile(int j) const {
    return j < n_a() ? a0 + j : b0 + (j - n_a());
  }
  // The step that visits tile t, or -1 when the walk skips it.
  __host__ __device__ __forceinline__ int rank(int t) const {
    if (t >= a0 && t < a1) return t - a0;
    if (t >= b0 && t < b1) return n_a() + t - b0;
    return -1;
  }
  // The part of the walk inside tiles [t0, t1).
  __host__ __device__ __forceinline__ TileRuns within(int t0, int t1) const {
    return {a0 > t0 ? a0 : t0, a1 < t1 ? a1 : t1, b0 > t0 ? b0 : t0, b1 < t1 ? b1 : t1};
  }
};

// The kT-column KV tiles that rows at positions p_lo .. p_hi see, below
// n_kv: the sink tiles, then the window's, up to the last row's diagonal.
// Without a window (kNoWindow, sinks 0) it is tiles 0 .. the diagonal's.
// A call that is not causal passes p_hi >= n_kv - 1.
template <int kT>
__host__ __device__ __forceinline__ TileRuns kv_runs(int p_lo, int p_hi, int n_kv, int window,
                                                     int sinks) {
  const int last = p_hi < n_kv - 1 ? p_hi : n_kv - 1;
  if (last < 0) return {0, 0, 0, 0};
  const int end = last / kT + 1;
  const int sink_tiles = (sinks + kT - 1) / kT;
  const int n_sink = sink_tiles < end ? sink_tiles : end;
  const int lo = p_lo - window + 1;  // the first row's first column in its window
  int first = lo > n_kv - 1 ? end : lo <= 0 ? 0 : lo / kT;
  if (first < n_sink) first = n_sink;
  return {0, n_sink, first, end};
}

// The end of the kRows-row Q steps that see the KV tile of columns
// kv_start .. kv_last (causal, offset off), which begin at the first step
// whose last row reaches kv_start, max(0, kv_start - off) / kRows: the
// step after the last whose first row's window reaches kv_last, or n_q's
// when the tile holds a sink column.
template <int kRows>
__host__ __device__ __forceinline__ int q_end(int kv_start, int kv_last, int off, int n_q,
                                              int window, int sinks) {
  const int all = (n_q + kRows - 1) / kRows;
  if (kv_start < sinks) return all;
  const int hi = kv_last + window - 1 - off;  // the last row whose window reaches kv_last
  if (hi < 0) return 0;
  return hi / kRows + 1 < all ? hi / kRows + 1 : all;
}

// Whether column c is inside the window of a row at position p (or a sink).
__device__ __forceinline__ bool in_window(int c, int p, int window, int sinks) {
  return c > p - window || c < sinks;
}

// Whether every column of kv_start .. kv_start + cols - 1 is inside the
// windows of rows at positions up to p_hi (or all are sinks).
__device__ __forceinline__ bool tile_in_window(int kv_start, int cols, int p_hi, int window,
                                               int sinks) {
  return kv_start > p_hi - window || kv_start + cols <= sinks;
}

}  // namespace
