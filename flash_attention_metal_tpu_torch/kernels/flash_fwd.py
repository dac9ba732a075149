"""Forward flash attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_fwd.py``.  The JAX
wrapper routes between three Pallas kernels; the serving path reaches only
the general one (``_fwd_kernel``), and ``csrc/flash_fwd.cu`` computes its
contract: causal masking with a per-batch device ``q_offset``, native GQA,
``pos_div`` rows per position, and an optional per-row logsumexp.

Route: a tensor on the CPU goes to ``flash_attention_fwd_plain``; a CUDA
tensor launches the kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from ..config import DEFAULT_MASK_VALUE, default_scale
from . import _build

# The head dimension compiled into csrc/flash_fwd.cu (kHeadDim).
HEAD_DIM = 64
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

# Features of the JAX kernel not ported yet (ROADMAP.md, Queue A item 5).
UNPORTED_FEATURES = (
    "window", "sinks", "segment_ids", "kv_positions", "softcap",
    "alibi_slopes", "dropout_rate", "dropout_seed",
)


def reject_unported(features: dict) -> None:
    """Raise for any requested feature the CUDA kernel does not take."""
    unknown = sorted(set(features) - set(UNPORTED_FEATURES))
    if unknown:
        raise TypeError(f"unexpected keyword arguments {unknown}")
    # None, 0, 0.0 and False are each feature's "off" value.
    asked = sorted(
        n for n, val in features.items()
        if val is not None and not (isinstance(val, (bool, int, float)) and val == 0)
    )
    if asked:
        raise NotImplementedError(
            f"{asked} not ported to the PyTorch package yet "
            "(see ROADMAP.md, Queue A item 5)"
        )


def _offsets(q_offset, batch: int, default: int, device) -> torch.Tensor:
    """``q_offset`` (None, int or tensor) as an int32 ``[batch]`` tensor."""
    if q_offset is None:
        q_offset = default
    if not torch.is_tensor(q_offset):
        return torch.full((batch,), int(q_offset), dtype=torch.int32, device=device)
    off = q_offset.to(device=device, dtype=torch.int32).reshape(-1)
    return off.expand(batch).contiguous() if off.numel() == 1 else off


def flash_attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: torch.Tensor,
    *,
    sm_scale: float,
    causal: bool,
    pos_div: int = 1,
    save_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The kernel's contract in fp32 PyTorch (``q_offset``: int32 ``[B]``)."""
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    visible = torch.ones((1, 1, n_q, n_kv), dtype=torch.bool, device=q.device)
    if causal:
        row = torch.arange(n_q, device=q.device) // pos_div
        col = torch.arange(n_kv, device=q.device)
        limit = row[:, None] + q_offset.to(q.device, torch.int64).reshape(b, 1, 1, 1)
        visible = col <= limit
    s = s.masked_fill(~visible, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * visible
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (torch.matmul(p, vf) / l_safe).to(q.dtype)
    if not save_lse:
        return o
    lse = torch.where(l == 0.0, float("-inf"), m + torch.log(l_safe))[..., 0]
    return o, lse


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``fam_flash_fwd``'s C signature on a loaded library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fam_flash_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, q_offset, o, lse
        i32, i32, i32, i32, i32, i32,  # batch, heads, kv heads, n_q, n_kv, head_dim
        ctypes.c_float, i32, i32, i32,  # sm_scale, causal, pos_div, dtype
        ptr,  # stream
    ]
    lib.fam_flash_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load())


def _check_cuda_inputs(q, k, v, q_offset) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes bf16 or fp32 inputs, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(
            f"the CUDA kernel is compiled for head_dim {HEAD_DIM}, got {q.shape[-1]}"
        )
    for name, t in (("q", q), ("k", k), ("v", v), ("q_offset", q_offset)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "q_offset" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: Union[None, int, torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    save_lse: bool = False,
    pos_div: int = 1,
    **features,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flash-attention forward over ``[B, H, N, D]`` inputs.

    ``k``/``v`` may have fewer heads than ``q`` (GQA: q-head ``h`` reads
    kv-head ``h // group``).  With ``causal``, row ``r`` of batch ``b`` sees
    columns ``c <= r // pos_div + q_offset[b]``; ``q_offset`` is an int or
    a ``[B]`` tensor and defaults to ``n_kv - n_q // pos_div``.  Returns
    ``o`` (``q``'s dtype) or ``(o, lse)`` with ``lse`` fp32 ``[B, H, N_q]``;
    rows with nothing visible give ``o = 0`` and ``lse = -inf``.
    """
    reject_unported(features)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected [B, H, N, D] q, k, v; got {q.shape}, {k.shape}, {v.shape}")
    batch, heads, n_q, head_dim = q.shape
    if k.shape[0] != batch or k.shape[3] != head_dim or heads % k.shape[1]:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q shape {tuple(q.shape)}")
    if pos_div < 1 or (pos_div > 1 and not causal):
        raise ValueError(f"pos_div={pos_div} must be >= 1, and > 1 only with causal")
    n_kv = k.shape[2]
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    off = _offsets(q_offset, batch, n_kv - n_q // pos_div, q.device)
    if off.shape != (batch,):
        raise ValueError(f"q_offset must be an int or a [{batch}] tensor")

    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, off, sm_scale=sm_scale, causal=causal, pos_div=pos_div,
            save_lse=save_lse,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, off)
    o = torch.empty_like(q)
    lse = (
        torch.empty((batch, heads, n_q), dtype=torch.float32, device=q.device)
        if save_lse
        else None
    )
    err = _lib().fam_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        batch, heads, k.shape[1], n_q, n_kv, head_dim, sm_scale, int(causal),
        pos_div, _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {err}")
    flash_attention_fwd.launches += 1
    return (o, lse) if save_lse else o


# Launches of the CUDA kernel since import (the CPU route does not count).
flash_attention_fwd.launches = 0
