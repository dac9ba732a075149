"""Forward flash attention: the router, two CUDA kernels' wrappers and
their plain versions.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_fwd.py``.
``flash_attention_fwd`` routes as the JAX wrapper does
(``flash_fwd.py:750-958``), between three kernels:

* ``flash_tri.flash_attention_tri`` (``csrc/flash_tri.cu``) for causal
  calls with a static offset (None or an int) and ``pos_div == 1``;
* ``flash_fwd_lean`` (``csrc/flash_lean.cu``, the Pallas
  ``_fwd_kernel_lean``) for the other calls with a static offset,
  ``pos_div == 1`` and the whole KV row in one block (``n_kv <=
  LEAN_MAX_KV``, the default ``block_k_major``);
* ``flash_fwd_general`` (``csrc/flash_fwd.cu``, the Pallas ``_fwd_kernel``)
  for everything else: tensor offsets (per-batch, on the device), the
  ``pos_div`` row fold of GQA decode, longer non-causal rows.

fp16 inputs run the fp32 route and are cast back, as in JAX (Mosaic has no
fp16 datapath; the CUDA kernels take bf16 and fp32).  The JAX router also
sends causal calls away from the triangular kernel past N = 4096 or at
tile-unfriendly lengths (``tri_heuristic``, ``_TRI_MAX_N``,
``_UNROLL_CAP``): those are Mosaic compile limits, so the port's
triangular kernel takes every N.  Its features (window, softcap, ...)
raise ``NotImplementedError`` on every route (ROADMAP.md, Queue A item 5).

Each kernel's wrapper takes its plain version for a tensor on the CPU and
launches the kernel, or raises, for a CUDA tensor.  Nothing falls back.
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


def flash_fwd_lean_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int,
    *,
    sm_scale: float,
    causal: bool,
    save_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The lean kernel's contract in fp32 PyTorch: one static offset for
    every batch, the whole row's max first (``flash_attention_fwd_plain``
    takes the softmax in the same two passes)."""
    off = torch.full((q.shape[0],), int(q_offset), dtype=torch.int32, device=q.device)
    return flash_attention_fwd_plain(
        q, k, v, off, sm_scale=sm_scale, causal=causal, save_lse=save_lse
    )


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


def bind_lean(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``fam_flash_lean``'s C signature on a loaded library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fam_flash_lean.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, o, lse
        i32, i32, i32, i32, i32, i32,  # batch, heads, kv heads, n_q, n_kv, head_dim
        ctypes.c_float, i32, i32, i32,  # sm_scale, causal, q_offset, dtype
        ptr,  # stream
    ]
    lib.fam_flash_lean.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind_lean(bind(_build.load()))


def _check_cuda_inputs(q, k, v, q_offset=None) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes bf16 or fp32 inputs, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(
            f"the CUDA kernel is compiled for head_dim {HEAD_DIM}, got {q.shape[-1]}"
        )
    for name, t in (("q", q), ("k", k), ("v", v), ("q_offset", q_offset)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "q_offset" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """``[B, H, N, D]`` q over ``[B, H_kv, N_kv, D]`` k and v, ``H_kv | H``."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected [B, H, N, D] q, k, v; got {q.shape}, {k.shape}, {v.shape}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or q.shape[1] % k.shape[1]:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q shape {tuple(q.shape)}")


def _new_outputs(q: torch.Tensor, save_lse: bool):
    lse = (
        torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if save_lse else None
    )
    return torch.empty_like(q), lse


def flash_fwd_general(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: Union[None, int, torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    save_lse: bool = False,
    pos_div: int = 1,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The general kernel (``csrc/flash_fwd.cu``) over ``[B, H, N, D]``.

    ``k``/``v`` may have fewer heads than ``q`` (GQA: q-head ``h`` reads
    kv-head ``h // group``).  With ``causal``, row ``r`` of batch ``b`` sees
    columns ``c <= r // pos_div + q_offset[b]``; ``q_offset`` is an int or
    a ``[B]`` tensor and defaults to ``n_kv - n_q // pos_div``.  Returns
    ``o`` (``q``'s dtype) or ``(o, lse)`` with ``lse`` fp32 ``[B, H, N_q]``;
    rows with nothing visible give ``o = 0`` and ``lse = -inf``.
    """
    check_shapes(q, k, v)
    batch, heads, n_q, head_dim = q.shape
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
    o, lse = _new_outputs(q, save_lse)
    err = _lib().fam_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        batch, heads, k.shape[1], n_q, n_kv, head_dim, sm_scale, int(causal),
        pos_div, _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {err}")
    flash_fwd_general.launches += 1
    return (o, lse) if save_lse else o


# The longest KV row the lean kernel takes in one block (csrc/flash_lean.cu,
# kMaxKv): the JAX package's default ``block_k_major`` (config.py).
LEAN_MAX_KV = 1024


def flash_fwd_lean(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: Optional[int] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    save_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The lean kernel (``csrc/flash_lean.cu``): the whole KV row of
    ``n_kv <= LEAN_MAX_KV`` columns in one block, an exact softmax and a
    static int ``q_offset`` (default ``n_kv - n_q``), native GQA.  Returns
    ``o`` or ``(o, lse)`` like ``flash_fwd_general``."""
    check_shapes(q, k, v)
    if torch.is_tensor(q_offset):
        raise TypeError("the lean kernel takes a static int q_offset")
    batch, heads, n_q, head_dim = q.shape
    n_kv = k.shape[2]
    if n_kv > LEAN_MAX_KV:
        raise ValueError(f"the lean kernel takes n_kv <= {LEAN_MAX_KV}, got {n_kv}")
    off = n_kv - n_q if q_offset is None else int(q_offset)
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    if q.device.type == "cpu":
        return flash_fwd_lean_plain(
            q, k, v, off, sm_scale=sm_scale, causal=causal, save_lse=save_lse
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v)
    o, lse = _new_outputs(q, save_lse)
    err = _lib().fam_flash_lean(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        batch, heads, k.shape[1], n_q, n_kv, head_dim, sm_scale, int(causal), off,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_lean kernel launch failed: cudaError_t {err}")
    flash_fwd_lean.launches += 1
    return (o, lse) if save_lse else o


# Launches of each CUDA kernel since import (the CPU route does not count).
flash_fwd_general.launches = 0
flash_fwd_lean.launches = 0


def is_static_offset(q_offset) -> bool:
    """None or a Python int: known when the call is made, as the JAX
    routers require of the lean and triangular kernels."""
    return q_offset is None or (isinstance(q_offset, int) and not isinstance(q_offset, bool))


def fwd_route(n_kv: int, q_offset, *, causal: bool, pos_div: int = 1) -> str:
    """The kernel ``flash_attention_fwd`` runs: ``"tri"``, ``"lean"`` or
    ``"general"`` (the JAX router's rules without its Mosaic limits)."""
    if is_static_offset(q_offset) and pos_div == 1:
        if causal:
            return "tri"
        if n_kv <= LEAN_MAX_KV:
            return "lean"
    return "general"


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
    """Flash-attention forward over ``[B, H, N, D]`` inputs, routed to the
    triangular, lean or general kernel (see the module docstring).

    The contract is ``flash_fwd_general``'s: GQA, causal masking with
    ``q_offset`` (None, an int or a ``[B]`` tensor; default
    ``n_kv - n_q // pos_div``), ``pos_div`` rows per position, ``o`` or
    ``(o, lse)``.  fp16 inputs compute in fp32 and return fp16.
    """
    reject_unported(features)
    if q.dtype == torch.float16:
        out = flash_attention_fwd(
            q.float(), k.float(), v.float(), q_offset, sm_scale=sm_scale,
            causal=causal, save_lse=save_lse, pos_div=pos_div,
        )
        return (out[0].half(), out[1]) if save_lse else out.half()
    route = fwd_route(k.shape[-2], q_offset, causal=causal, pos_div=pos_div)
    if route == "tri":
        from .flash_tri import flash_attention_tri

        return flash_attention_tri(q, k, v, sm_scale=sm_scale, q_offset=q_offset, save_lse=save_lse)
    if route == "lean":
        return flash_fwd_lean(
            q, k, v, q_offset, sm_scale=sm_scale, causal=causal, save_lse=save_lse
        )
    return flash_fwd_general(
        q, k, v, q_offset, sm_scale=sm_scale, causal=causal, save_lse=save_lse,
        pos_div=pos_div,
    )
