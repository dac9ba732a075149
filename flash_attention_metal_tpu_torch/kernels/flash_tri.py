"""Triangular causal attention with a static offset: the CUDA kernels'
wrappers and their plain versions.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_tri.py``: the
forward ``flash_attention_tri`` and the fused backward
``flash_attention_bwd_tri``, which the JAX routers take for plain causal
calls whose offset is a Python int.  ``csrc/flash_tri.cu`` holds their C
entries; the kernels are the general paths' own, given the offset as an
int at launch.  The forward (bf16) is the ``wgmma`` kernel of
``csrc/flash_fwd_sm90.cuh``, which the general and lean forwards run too:
heaviest Q tile first, mask compares only on tiles that straddle the
diagonal.  The backward (bf16) is the fused ``wgmma`` kernel of
``csrc/flash_bwd_fused_sm90.cuh``: dQ, dK and dV from one recompute of S
and P per visible tile pair, dQ added to one fp32 accumulator in KV-tile
order (deterministic), dK and dV stored fp32, as the Pallas kernel's are.
fp32 runs the FMA templates of ``flash_fwd.cu`` and ``flash_bwd.cu``.

The JAX functions' ``block_q``, ``block_k`` and ``pv_transposed`` choose
Mosaic tile sizes and a transposed layout for the TPU's 128-wide matrix
unit; the CUDA kernels' 64-row tiles are fixed, so these are accepted and
ignored.  ``_tri_fold`` (batch packing per grid step) has no counterpart.

Route: tensors on the CPU go to the plain versions; CUDA tensors launch the
kernels or raise.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from ..config import default_scale
from . import _build
from .flash_bwd import _plain_p_ds, bwd_delta, dq_workspace
from .flash_fwd import (
    _DTYPE_CODES,
    _check_cuda_inputs,
    _new_outputs,
    check_shapes,
    flash_attention_fwd_plain,
)


def _static_offset(q_offset, n_q: int, n_kv: int) -> int:
    if torch.is_tensor(q_offset):
        raise TypeError(
            "the triangular kernels take a static int q_offset; per-batch "
            "tensor offsets go to flash_fwd_general / flash_attention_bwd"
        )
    return n_kv - n_q if q_offset is None else int(q_offset)


def flash_attention_tri_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int,
    *,
    sm_scale: float,
    save_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The forward kernel's contract in fp32 PyTorch."""
    off = torch.full((q.shape[0],), int(q_offset), dtype=torch.int32, device=q.device)
    return flash_attention_fwd_plain(
        q, k, v, off, sm_scale=sm_scale, causal=True, save_lse=save_lse
    )


def flash_attention_bwd_tri_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    q_offset: int,
    dlse: Optional[torch.Tensor] = None,
    *,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's contract in fp32 PyTorch: ``(dq, dk, dv)``
    with ``dq`` in ``q``'s dtype and ``dk``, ``dv`` fp32."""
    off = torch.full((q.shape[0],), int(q_offset), dtype=torch.int32, device=q.device)
    delta = bwd_delta(o, do, dlse)
    p, ds, kf, _ = _plain_p_ds(q, k, v, do, lse, delta, off, sm_scale, True)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * sm_scale
    dq = (torch.matmul(ds, kf) * sm_scale).to(q.dtype)
    return dq, dk, dv


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the triangular entry points' C signatures on a library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fam_flash_tri_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, o, lse
        i32, i32, i32, i32, i32, i32,  # batch, heads, kv heads, n_q, n_kv, head_dim
        ctypes.c_float, i32, i32,  # sm_scale, q_offset, dtype
        ptr,  # stream
    ]
    lib.fam_flash_tri_fwd.restype = ctypes.c_int
    lib.fam_flash_tri_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, dout, lse, delta
        ptr, ptr, ptr, ptr, ptr, i32,  # dq, dk, dv, dq accumulator, counters, n_counters
        i32, i32, i32, i32, i32,  # batch, heads, n_q, n_kv, head_dim
        ctypes.c_float, i32, i32,  # sm_scale, q_offset, dtype
        ptr,  # stream
    ]
    lib.fam_flash_tri_bwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load())


def flash_attention_tri(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    save_lse: bool = False,
    pv_transposed: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal flash attention over ``[B, H, N, D]`` inputs, triangular kernel.

    ``k``/``v`` may have fewer heads than ``q`` (GQA).  Row ``r`` sees
    columns ``c <= r + q_offset``, with ``q_offset`` a Python int (default
    ``n_kv - n_q``).  Returns ``o`` or ``(o, lse)`` with ``lse`` fp32
    ``[B, H, N_q]``; rows that see nothing give ``o = 0``, ``lse = -inf``.
    ``block_q``, ``block_k`` and ``pv_transposed`` are ignored (module
    docstring).
    """
    del block_q, block_k, pv_transposed
    check_shapes(q, k, v)
    batch, heads, n_q, head_dim = q.shape
    n_kv = k.shape[2]
    off = _static_offset(q_offset, n_q, n_kv)
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    if q.device.type == "cpu":
        return flash_attention_tri_plain(q, k, v, off, sm_scale=sm_scale, save_lse=save_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v)
    o, lse = _new_outputs(q, save_lse)
    err = _lib().fam_flash_tri_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        batch, heads, k.shape[1], n_q, n_kv, head_dim, sm_scale, off,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_tri forward kernel launch failed: cudaError_t {err}")
    flash_attention_tri.launches += 1
    return (o, lse) if save_lse else o


def flash_attention_bwd_tri(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    dlse: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    pos_div: int = 1,
    pv_transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of causal attention from the fused triangular kernel.

    Equal head counts and a static int ``q_offset`` (default
    ``n_kv - n_q``).  ``o`` and ``lse`` (fp32 ``[B, H, N_q]``) are the
    forward's outputs, ``do`` the output's cotangent and ``dlse`` the
    optional lse cotangent.  ``dq`` comes back in ``q``'s dtype, ``dk`` and
    ``dv`` in fp32.  ``pos_div`` (the JAX GQA row fold) raises: the port's
    kernels take GQA natively.  ``block_q``, ``block_k`` and
    ``pv_transposed`` are ignored (module docstring).
    """
    del block_q, block_k, pv_transposed
    if pos_div != 1:
        raise NotImplementedError(
            "pos_div (the GQA row-fold backward) is not ported: GQA is native "
            "in the port's kernels (see ROADMAP.md, Queue A item 5)"
        )
    check_shapes(q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(
            f"flash_attention_bwd_tri requires equal head counts, got "
            f"{q.shape[1]} vs {k.shape[1]}"
        )
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("o and do must be shaped like q, lse like q[..., 0]")
    batch, heads, n_q, head_dim = q.shape
    n_kv = k.shape[2]
    off = _static_offset(q_offset, n_q, n_kv)
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    if q.device.type == "cpu":
        return flash_attention_bwd_tri_plain(q, k, v, o, do, lse, off, dlse, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v)
    _check_cuda_inputs(do, k, v)
    if do.dtype != q.dtype:
        raise TypeError("do must share q's dtype")
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("lse must be a contiguous fp32 tensor on q's device")
    return flash_tri_bwd(q, k, v, do, lse, bwd_delta(o, do, dlse), off, sm_scale=sm_scale)


def flash_tri_bwd(q, k, v, do, lse, delta, off: int, *, sm_scale: float,
                  workspace: Optional[torch.Tensor] = None):
    """``(dq, dk, dv)`` from the triangular backward's one launch (CUDA
    tensors, checked by the caller; counted on ``flash_attention_bwd_tri``).
    ``workspace``: the fused kernel's, ``flash_bwd.dq_workspace``: an
    fp32 dQ accumulator and its counters, whatever ``off`` and ``n_kv``."""
    batch, heads, n_q, head_dim = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    workspace, ws_args = dq_workspace(q, workspace)
    err = _lib().fam_flash_tri_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *ws_args, batch, heads, n_q, k.shape[2], head_dim, sm_scale, off,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_tri backward kernel launch failed: cudaError_t {err}")
    flash_attention_bwd_tri.launches += 1
    return dq, dk, dv


# Launches of each CUDA kernel since import (the CPU route does not count).
flash_attention_tri.launches = 0
flash_attention_bwd_tri.launches = 0
