"""Backward flash attention: the CUDA kernels' wrappers and their plain version.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_bwd.py``.  The JAX
wrapper routes between a split pair, a fused variant and the triangular
kernel; the training step (traced offsets, GQA group 2, no tuned entry)
reaches the split pair, ``_dkv_kernel`` and ``_dq_kernel``.
``csrc/flash_bwd.cu`` computes their contract with native GQA (no repeated
K/V, dK/dV summed over the group in fp32) and a per-batch device
``q_offset``.  The ``delta = rowsum(dO * O) - dlse`` precompute stays a
torch op, as it is plain jnp in the JAX package.

Route: tensors on the CPU go to ``flash_attention_bwd_plain`` (the two
kernels' plain versions); CUDA tensors launch the two kernels or raise.
Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from ..config import default_scale
from . import _build
from .flash_fwd import (
    _DTYPE_CODES,
    _check_cuda_inputs,
    _offsets,
    reject_unported,
)

# Stands in for lse = -inf (a row that sees no column) when P is rebuilt,
# as in the JAX kernels: exp(s - 1e30) is exactly 0, never inf or NaN.
LSE_SENTINEL = 1e30


def bwd_delta(o: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 ``[B, H, N_q]`` ``rowsum(dO * O) - dlse``, shared by both kernels.

    The lse cotangent folds in here because d(lse_r)/d(s_rc) = P_rc.
    """
    delta = (o.float() * do.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _plain_p_ds(q, k, v, do, lse, delta, off, sm_scale, causal):
    """fp32 P (rebuilt from ``lse``) and dS over repeated KV heads."""
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    lse_safe = torch.where(torch.isneginf(lse), LSE_SENTINEL, lse.float())
    p = torch.exp(s.sub_(lse_safe[..., None]))
    if causal:
        row = torch.arange(n_q, device=q.device)[:, None]
        col = torch.arange(n_kv, device=q.device)
        limit = row + off.to(q.device, torch.int64).reshape(b, 1, 1, 1)
        p = p.masked_fill_(col > limit, 0.0)
    dp = torch.matmul(do.float(), vf.transpose(-1, -2))
    ds = dp.sub_(delta[..., None]).mul_(p)
    return p, ds, kf


def _group_sum(x: torch.Tensor, h_kv: int) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.reshape(b, h_kv, h // h_kv, n, d).sum(dim=2)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, off, *, sm_scale: float, causal: bool):
    """The dK/dV kernel's contract in fp32 PyTorch: ``(dk, dv)``, summed over
    each KV head's group of q-heads."""
    p, ds, _ = _plain_p_ds(q, k, v, do, lse, delta, off, sm_scale, causal)
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), do.float()), k.shape[1])
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), q.float()), k.shape[1]) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, off, *, sm_scale: float, causal: bool):
    """The dQ kernel's contract in fp32 PyTorch."""
    _, ds, kf = _plain_p_ds(q, k, v, do, lse, delta, off, sm_scale, causal)
    return (torch.matmul(ds, kf) * sm_scale).to(q.dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    q_offset: torch.Tensor,
    dlse: Optional[torch.Tensor] = None,
    *,
    sm_scale: float,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_attention_bwd``'s contract in fp32 PyTorch (``q_offset``:
    int32 ``[B]``): the delta precompute and the two kernels' plain versions."""
    delta = bwd_delta(o, do, dlse)
    kw = dict(sm_scale=sm_scale, causal=causal)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_offset, **kw)
    return flash_bwd_dq_plain(q, k, v, do, lse, delta, q_offset, **kw), dk, dv


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the two backward entry points' C signatures on a library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    common = [
        i32, i32, i32, i32, i32, i32,  # batch, heads, kv heads, n_q, n_kv, head_dim
        ctypes.c_float, i32, i32,  # sm_scale, causal, dtype
        ptr,  # stream
    ]
    # q, k, v, dout, lse, delta, q_offset, then the outputs.
    lib.fam_flash_bwd_dkv.argtypes = [ptr] * 9 + common
    lib.fam_flash_bwd_dkv.restype = ctypes.c_int
    lib.fam_flash_bwd_dq.argtypes = [ptr] * 8 + common
    lib.fam_flash_bwd_dq.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load())


def _shape_args(q, k, sm_scale, causal):
    b, h, n_q, d = q.shape
    return (
        b, h, k.shape[1], n_q, k.shape[2], d, sm_scale, int(causal),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )


def _inputs(q, k, v, do, lse, delta, off):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), off.data_ptr())


def flash_bwd_dkv(q, k, v, do, lse, delta, off, *, sm_scale: float, causal: bool):
    """``(dk, dv)`` from the dK/dV kernel (CUDA tensors, checked by the caller)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib().fam_flash_bwd_dkv(
        *_inputs(q, k, v, do, lse, delta, off), dk.data_ptr(), dv.data_ptr(),
        *_shape_args(q, k, sm_scale, causal),
    )
    if err:
        raise RuntimeError(f"flash_bwd dK/dV kernel launch failed: cudaError_t {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, off, *, sm_scale: float, causal: bool):
    """``dq`` from the dQ kernel (CUDA tensors, checked by the caller)."""
    dq = torch.empty_like(q)
    err = _lib().fam_flash_bwd_dq(
        *_inputs(q, k, v, do, lse, delta, off), dq.data_ptr(),
        *_shape_args(q, k, sm_scale, causal),
    )
    if err:
        raise RuntimeError(f"flash_bwd dQ kernel launch failed: cudaError_t {err}")
    flash_bwd_dq.launches += 1
    return dq


# Launches of each CUDA kernel since import (the CPU route does not count).
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    q_offset: Union[None, int, torch.Tensor] = None,
    dlse: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    **features,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of flash attention over ``[B, H, N, D]`` inputs.

    ``o`` and ``lse`` (fp32 ``[B, H, N_q]``, natural log) are the forward's
    saved outputs, ``do`` the output's cotangent and ``dlse`` the optional
    lse cotangent.  ``k``/``v`` may have fewer heads than ``q`` (GQA); the
    masking rule and the ``q_offset`` default (``n_kv - n_q``) are the
    forward's.  The JAX wrapper's window/sinks/segment/softcap/ALiBi/dropout
    arguments and ``pos_div`` raise NotImplementedError if set.
    """
    pos_div = features.pop("pos_div", 1)
    if pos_div != 1:
        raise NotImplementedError(
            "pos_div (the GQA row-fold backward) is not ported: GQA is native "
            "in the port's kernels (see ROADMAP.md, Queue A item 3)"
        )
    reject_unported(features)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected [B, H, N, D] q, k, v; got {q.shape}, {k.shape}, {v.shape}")
    batch, heads, n_q, head_dim = q.shape
    if k.shape[0] != batch or k.shape[3] != head_dim or heads % k.shape[1]:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q shape {tuple(q.shape)}")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("o and do must be shaped like q, lse like q[..., 0]")
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    off = _offsets(q_offset, batch, k.shape[2] - n_q, q.device)
    if off.shape != (batch,):
        raise ValueError(f"q_offset must be an int or a [{batch}] tensor")

    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, o, do, lse, off, dlse, sm_scale=sm_scale, causal=causal
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, off)
    _check_cuda_inputs(do, k, v, off)
    if do.dtype != q.dtype:
        raise TypeError("do must share q's dtype")
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("lse must be a contiguous fp32 tensor on q's device")
    delta = bwd_delta(o, do, dlse)
    kw = dict(sm_scale=sm_scale, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, off, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, off, **kw)
    return dq, dk, dv

