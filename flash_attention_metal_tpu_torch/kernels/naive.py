"""Naive O(N^2) attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``flash_attention_metal_tpu/kernels/naive.py``: the whole
score row, a two-pass softmax (row max, then exp, sum and P V), no online
statistics, everything in fp32 whatever the input type.  It is the
benchmark's denominator and the ladder's first rung.  ``csrc/naive.cu``
computes it with the Pallas kernel's tiling on CUDA cores: one block per
64-row Q tile, K and V streamed through shared memory in
64-row tiles, register-tiled fp32 outer products, and the two passes as
two walks over K (the row max, then exp, sum and P V).

Route: a tensor on the CPU goes to ``naive_attention_plain``; a CUDA tensor
launches the kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..config import DEFAULT_MASK_VALUE, default_scale
from . import _build
from .flash_fwd import _DTYPE_CODES, _check_cuda_inputs

# Longest KV row the kernel takes (csrc/naive.cu, kMaxKv): the benchmark's
# sweep, like the JAX package's, caps naive at N = 8192.
NAIVE_MAX_KV = 8192


def naive_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: float, causal: bool
) -> torch.Tensor:
    """The kernel's contract in fp32 PyTorch: masked scores take the JAX
    package's finite mask value, so a row that sees nothing gives mean(V)."""
    n_q, n_kv = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        row = torch.arange(n_q, device=q.device)[:, None] + (n_kv - n_q)
        col = torch.arange(n_kv, device=q.device)
        s = s.masked_fill(col > row, DEFAULT_MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True)
    return o.to(q.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``fam_naive``'s C signature on a loaded library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fam_naive.argtypes = [
        ptr, ptr, ptr, ptr,  # q, k, v, o
        i32, i32, i32, i32, i32,  # batch, heads, n_q, n_kv, head_dim
        ctypes.c_float, i32, i32,  # sm_scale, causal, dtype
        ptr,  # stream
    ]
    lib.fam_naive.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load())


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    block_q: Optional[int] = None,
) -> torch.Tensor:
    """Naive attention over ``[B, H, N, D]`` inputs with equal head counts.

    With ``causal`` the diagonal is end-aligned: row ``r`` sees columns
    ``c <= r + n_kv - n_q``.  Returns ``o`` in ``q``'s dtype.  ``block_q``
    is the Pallas kernel's grid tile (128 rows there); the CUDA kernel's
    tile is fixed (64 rows), so it is accepted and ignored.
    """
    del block_q
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"expected [B, H, N, D] q, k, v with equal heads; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    batch, heads, n_q, head_dim = q.shape
    n_kv = k.shape[2]
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    if q.device.type == "cpu":
        return naive_attention_plain(q, k, v, sm_scale=sm_scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v)
    if n_kv > NAIVE_MAX_KV:
        raise ValueError(f"the naive kernel takes score rows up to {NAIVE_MAX_KV}, got {n_kv}")
    o = torch.empty_like(q)
    err = _lib().fam_naive(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        batch, heads, n_q, n_kv, q.shape[-1], sm_scale, int(causal), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"naive kernel launch failed: cudaError_t {err}")
    naive_attention.launches += 1
    return o


# Launches of the CUDA kernel since import (the CPU route does not count).
naive_attention.launches = 0
