// Single-KV-extent ("lean") forward attention for Hopper (sm_90a), bf16
// and fp32, head dim 64 or 128: the entry point alone.
//
// Replaces flash_attention_metal_tpu/kernels/flash_fwd.py::_fwd_kernel_lean,
// the forward the router takes when the whole KV row fits one block
// (n_kv <= 1024) and the causal offset is a static int: the benchmark's
// non-causal sweep at N <= 1024 and the ladder's rungs 3-5.
//
// Contract, for every batch b, q-head h (KV head h / group) and query row r:
//   o[b,h,r,:] = softmax_c(s) . V,  s = sm_scale * q[b,h,r] . k[b,h/group,c]
// over the columns c < n_kv and, when causal, c <= r + q_offset, with
// q_offset an int given at launch (negative allowed).  The optional lse is
// the natural-log logsumexp per row, fp32 [B, H, N_q].  A row with no
// visible column gives o = 0 and lse = -inf (the Pallas lean path gives
// mean(V) there; such rows need a negative offset).
//
// It is the general forward's function with one int offset for every
// batch, so it runs the general forward's kernels: bf16 the wgmma kernel of
// flash_fwd_sm90.cuh (fixed_offset in place of the device array; what
// bounds it and what its design does are noted there), fp32 the FMA
// template of flash_fwd.cu (IEEE FMA, within 1e-5 of the plain version).
// The Pallas kernel's exact two-pass softmax becomes the online one, which
// changes only rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_fwd_sm90.cuh"

namespace {
constexpr int kMaxKv = 1024;
}  // namespace

namespace fam {
// flash_fwd.cu: the dense fp32 template with one int causal offset.
cudaError_t flash_lean_fp32(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch, int n_heads, int n_kv_heads, int n_q, int n_kv,
                            int head_dim, float sm_scale, int causal, int q_offset,
                            cudaStream_t stream);
}  // namespace fam

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
      n_kv > kMaxKv || (head_dim != 64 && head_dim != 128) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return (int)fam::flash_lean_fp32(q, k, v, o, lse, batch, n_heads, n_kv_heads, n_q, n_kv,
                                     head_dim, sm_scale, causal, q_offset, s);
  }
  if (head_dim == 64) {
    return (int)sm90::launch_fwd<64>(q, k, v, nullptr, q_offset, o, lse, batch, n_heads,
                                     n_kv_heads, n_q, n_kv, sm_scale, causal, s);
  }
  return (int)sm90::launch_fwd<128>(q, k, v, nullptr, q_offset, o, lse, batch, n_heads,
                                    n_kv_heads, n_q, n_kv, sm_scale, causal, s);
}
