// Triangular causal attention for Hopper (sm_90a), bf16 and fp32, head dim
// 64 or 128: the forward and the fused backward with a static causal
// offset, the entry points alone.
//
// Replaces flash_attention_metal_tpu/kernels/flash_tri.py::_tri_kernel
// (forward) and ::_tri_bwd_kernel (backward), the JAX routers' default for
// plain causal calls whose offset is a Python int: the benchmark's causal
// sweep and its high-occupancy phase, and the ladder's rungs 5c, 6, 7b, 7c.
//
// Contract, for every batch b, q-head h (KV head h / group) and query row r,
// with row r seeing column c when c < n_kv and c <= r + q_offset (q_offset
// an int given at launch, negative allowed):
//   forward   o[r] = softmax_c(sm_scale * q[r] . k[c]) . V, and optionally
//             lse[r], the natural-log row logsumexp, fp32 [B, H, N_q]; a row
//             with no visible column gives o = 0 and lse = -inf.
//   backward  (equal head counts) with P[r,c] = exp(sm_scale q[r].k[c] -
//             lse[r]) (lse = -inf takes a 1e30 sentinel: P = 0),
//             dS = P (dO V^T - delta), delta = rowsum(dO o O) - dlse (the
//             wrapper's torch op):  dV = P^T dO, dK = sm_scale dS^T Q,
//             dQ = sm_scale dS K, with S and P computed ONCE per visible
//             (Q tile, KV tile) pair for all three.  dK and dV come back
//             fp32 (as the Pallas kernel's do), dQ in q's type; rows that
//             see nothing get zero gradients.  Deterministic.
// Softmax statistics and products accumulate in fp32; P and dS enter the
// bf16 products rounded to bf16; fp32 inputs use IEEE FMA (never TF32).
//
// The JAX package has a triangular kernel of its own because Mosaic needs
// a static unroll and has a compile wall for long rows; on Hopper the
// contract adds only an offset known at launch.  So both directions run
// the kernels of the general paths, with that offset as an int:
//   * forward, bf16: the wgmma kernel of flash_fwd_sm90.cuh (q_offset null,
//     fixed_offset the int), as flash_lean.cu launches it.  Q tiles are
//     issued last tile first (the longest walks), only tiles that cross
//     the diagonal or the n_kv edge compare columns, and S, P and O stay in
//     registers behind a cp.async ring.  fp32: the dense FMA template of
//     flash_fwd.cu with one int offset (fam::flash_lean_fp32).
//   * backward, bf16: the fused wgmma kernel of flash_bwd_fused_sm90.cuh
//     (q_offset null, off_bound the int), storing dK and dV in fp32.  One
//     block per (KV tile, batch x head) keeps the tile's dK and dV in
//     registers over its visible Q steps and adds each step's dQ to one
//     fp32 accumulator in KV-tile order (dq_ordered.cuh): the workspace is
//     O(B H N_q D) (67 MB at B16 H8 N2048 D64), where the first design's
//     64 x D slot per visible tile pair took 1.1 GB there.  fp32: the fused
//     FMA template of flash_bwd.cu (fam_flash_bwd_fused), whose dK and dV
//     are fp32 already.
//
// What bounds it on the H100.  At the benchmark's high-occupancy shape (B16
// H8 N2048 causal, bf16) the forward does 68.7 GFLOP and the backward
// 171.8 GFLOP against ~34 MB and ~75 MB of I/O: both are bound by the
// tensor cores (0.069 ms and 0.174 ms at 989 TF/s), not by HBM.  What each
// kernel's design does about it is noted in its header.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dq_ordered.cuh"
#include "flash_bwd_fused_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace fam {
// flash_fwd.cu: the dense fp32 template with one int causal offset.
cudaError_t flash_lean_fp32(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch, int n_heads, int n_kv_heads, int n_q, int n_kv,
                            int head_dim, float sm_scale, int causal, int q_offset,
                            cudaStream_t stream);
}  // namespace fam

// flash_bwd.cu: the fused backward's entry (its fp32 template for dtype 1).
extern "C" int fam_flash_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* q_offset, void* dk, void* dv, void* dq,
                                   void* dq_acc, void* counters, int n_counters, int off_bound,
                                   int window, int sinks, const void* q_seg, const void* kv_seg,
                                   int batch, int n_heads, int n_kv_heads, int n_q, int n_kv,
                                   int head_dim, float sm_scale, int causal, int dtype,
                                   void* stream);

namespace {

bool valid(int batch, int n_heads, int n_q, int n_kv, int head_dim, int dtype) {
  return batch >= 1 && batch <= 65535 && n_heads >= 1 && n_heads <= 65535 && n_q >= 1 &&
         n_kv >= 1 && n_q <= 65535 * 64 && n_kv <= 65535 * 64 &&
         (head_dim == 64 || head_dim == 128) && (dtype == 0 || dtype == 1);
}

// The same visibility with an offset that keeps r + off in int range: at
// -n_q no row sees a column, at n_kv - 1 every row sees every column.
int clamp_offset(int q_offset, int n_q, int n_kv) {
  return q_offset < -n_q ? -n_q : q_offset > n_kv - 1 ? n_kv - 1 : q_offset;
}

// The bf16 backward: the fused kernel with `off` for every batch, dK and dV
// stored in fp32.
template <int D>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            void* dq_acc, void* counters, int batch, int n_heads, int n_q,
                            int n_kv, float sm_scale, int off, cudaStream_t stream) {
  return sm90::launch_fused<D, float>(q, k, v, dout, lse, delta, nullptr, off, dk, dv, dq,
                                      static_cast<float*>(dq_acc), static_cast<int*>(counters),
                                      batch, n_heads, n_heads, n_q, n_kv, sm_scale, stream);
}

}  // namespace

// C entry points, bound with ctypes (kernels/flash_tri.py).  Pointers are
// device pointers of contiguous tensors; q_offset is the static causal
// offset (row r sees c <= r + q_offset); dtype: 0 = bf16, 1 = fp32.  Each
// launcher returns its launch's cudaError_t (0 on success).
//
// Forward: q, o [B, H, N_q, D]; k, v [B, H_kv, N_kv, D], D = head_dim, 64
// or 128; lse fp32 [B, H, N_q] or null.
extern "C" int fam_flash_tri_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int batch, int n_heads,
                                 int n_kv_heads, int n_q, int n_kv,
                                 int head_dim, float sm_scale, int q_offset,
                                 int dtype, void* stream) {
  if (!valid(batch, n_heads, n_q, n_kv, head_dim, dtype) || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int off = clamp_offset(q_offset, n_q, n_kv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return (int)fam::flash_lean_fp32(q, k, v, o, lse, batch, n_heads, n_kv_heads, n_q, n_kv,
                                     head_dim, sm_scale, 1, off, s);
  }
  if (head_dim == 64) {
    return (int)sm90::launch_fwd<64>(q, k, v, nullptr, off, o, lse, batch, n_heads,
                                     n_kv_heads, n_q, n_kv, sm_scale, 1, s);
  }
  return (int)sm90::launch_fwd<128>(q, k, v, nullptr, off, o, lse, batch, n_heads, n_kv_heads,
                                    n_q, n_kv, sm_scale, 1, s);
}

// Backward (equal head counts): q, dout, dq [B, H, N_q, D]; k, v [B, H,
// N_kv, D], D = head_dim, 64 or 128; lse, delta fp32 [B, H, N_q]; dk, dv
// fp32 [B, H, N_kv, D]; dq_acc fp32 [B, H, N_q, D], any contents; counters
// int32 [n_counters] = dq_ordered::counter_count(batch, n_heads, n_q), all
// zero (kernels/flash_bwd.py::dq_workspace_shape counts both).
extern "C" int fam_flash_tri_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk, void* dv,
                                 void* dq_acc, void* counters, int n_counters, int batch,
                                 int n_heads, int n_q, int n_kv, int head_dim,
                                 float sm_scale, int q_offset, int dtype, void* stream) {
  if (!valid(batch, n_heads, n_q, n_kv, head_dim, dtype) ||
      n_counters != dq_ordered::counter_count(batch, n_heads, n_q)) {
    return (int)cudaErrorInvalidValue;
  }
  const int off = clamp_offset(q_offset, n_q, n_kv);
  if (dtype == 1) {
    return fam_flash_bwd_fused(q, k, v, dout, lse, delta, nullptr, dk, dv, dq, dq_acc, counters,
                               n_counters, off, 0, 0, nullptr, nullptr, batch, n_heads, n_heads,
                               n_q, n_kv, head_dim,
                               sm_scale, 1, 1, stream);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(head_dim == 64
                   ? launch_bwd_bf16<64>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, counters,
                                         batch, n_heads, n_q, n_kv, sm_scale, off, s)
                   : launch_bwd_bf16<128>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc,
                                          counters, batch, n_heads, n_q, n_kv, sm_scale, off, s));
}
