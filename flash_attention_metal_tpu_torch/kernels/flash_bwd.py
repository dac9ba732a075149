"""Backward flash attention: the split pair's and the fused kernel's
wrappers, their plain versions and the backward router.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_bwd.py``.  The JAX
package has three backward variants.  ``flash_attention_bwd`` runs the
split pair, ``_dkv_kernel`` and ``_dq_kernel``, which the training step
reaches (traced offsets, GQA group 2): ``csrc/flash_bwd.cu`` computes their
contract with native GQA (no repeated K/V, dK/dV summed over the group in
fp32) and a per-batch device ``q_offset``.  ``flash_attention_bwd_fused``
runs the 5-matmul ``_fused_bwd_kernel``: the same source's dK/dV kernel
writes each visible pair's dQ contribution to its own fp32 slot, and a
second kernel sums each Q tile's slots in KV-tile order (deterministic).
The slots are packed as the triangular backward's (``csrc/dq_slots.cuh``):
one per pair visible at a host-known bound on the offsets.  GQA is native
there too: the JAX kernel takes equal heads only because the JAX op
repeats K/V first.  The ``delta = rowsum(dO * O) - dlse`` precompute
stays a torch op, as it is plain jnp in the JAX package.

``flash_attention_bwd_auto`` routes in the JAX dispatcher's order of
precedence (``flash_bwd.py:404-517``): explicit ``block_sizes`` take the
split pair; otherwise the autotuner's saved decision for the shape
(``harness/autotune.py::lookup_bwd``, read from ``autotune_cache_torch.json``
only when that file exists) wins, a ``"tri"`` decision only where the
triangular kernel applies; with no decision, plain causal calls with equal
head counts, a static offset (None or an int), ``pos_div == 1`` and no fp16
go to the fused triangular kernel (``flash_tri.flash_attention_bwd_tri``),
everything else to the split pair.  The JAX dispatcher also asks
``tri_bwd_heuristic`` (N a multiple of 512, N <= 4096, an unroll budget):
v5e tile measurements and Mosaic compile limits, not carried.

Route: tensors on the CPU go to the plain versions; CUDA tensors launch the
kernels or raise.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from ..config import BlockSizes, default_scale
from . import _build
from .flash_fwd import (
    _DTYPE_CODES,
    _check_cuda_inputs,
    _offsets,
    is_static_offset,
    reject_unported,
)

# Stands in for lse = -inf (a row that sees no column) when P is rebuilt,
# as in the JAX kernels: exp(s - 1e30) is exactly 0, never inf or NaN.
LSE_SENTINEL = 1e30
# Rows of the fused kernel's Q and KV tiles, and of one dQ workspace slot
# (csrc/dq_slots.cuh, kTile): each dQ partial covers this many KV rows.
DQ_TILE = 64


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


def flash_attention_bwd_fused_plain(
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
    """``flash_attention_bwd_fused``'s contract in fp32 PyTorch: dK/dV as the
    split pair's, and dQ as one partial ``dS K`` per ``DQ_TILE`` KV rows,
    summed in KV order (the kernel's workspace slots), then scaled."""
    delta = bwd_delta(o, do, dlse)
    p, ds, kf = _plain_p_ds(q, k, v, do, lse, delta, q_offset, sm_scale, causal)
    h_kv = k.shape[1]
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), do.float()), h_kv)
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), q.float()), h_kv) * sm_scale
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[2], DQ_TILE):
        dq += torch.matmul(ds[..., start:start + DQ_TILE], kf[:, :, start:start + DQ_TILE])
    return (dq * sm_scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_offset_bound(q_offset, q_offset_max: Optional[int], n_q: int, n_kv: int,
                       causal: bool) -> int:
    """The offset the fused kernel's workspace is sized for: a static
    ``q_offset`` (None or an int) itself, else ``q_offset_max``; ``n_kv -
    1`` (every pair visible) when not causal or when neither is known.
    The kernel reads each offset no higher than it."""
    if not causal:
        return n_kv - 1
    if is_static_offset(q_offset):
        bound = n_kv - n_q if q_offset is None else int(q_offset)
    else:
        bound = n_kv - 1 if q_offset_max is None else int(q_offset_max)
    return min(bound, n_kv - 1)


def dq_workspace_shape(batch: int, heads: int, n_q: int, n_kv: int, off: int) -> tuple:
    """The fp32 dQ workspace of the fused and the triangular backward
    kernels (``csrc/dq_slots.cuh``): one ``DQ_TILE`` x ``DQ_TILE`` slot per
    (batch, q-head, pair visible at offset ``off``), counted by the
    kernels' library (``fam_bwd_dq_pairs``)."""
    pairs = _lib().fam_bwd_dq_pairs(n_q, n_kv, off)
    return (batch * heads * pairs, DQ_TILE, DQ_TILE)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the backward entry points' C signatures on a library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    common = [
        i32, i32, i32, i32, i32, i32,  # batch, heads, kv heads, n_q, n_kv, head_dim
        ctypes.c_float, i32, i32,  # sm_scale, causal, dtype
        ptr,  # stream
    ]
    # q, k, v, dout, lse, delta, q_offset, then the outputs (and the fused
    # kernel's workspace).
    lib.fam_flash_bwd_dkv.argtypes = [ptr] * 9 + common
    lib.fam_flash_bwd_dkv.restype = ctypes.c_int
    lib.fam_flash_bwd_dq.argtypes = [ptr] * 8 + common
    lib.fam_flash_bwd_dq.restype = ctypes.c_int
    lib.fam_flash_bwd_fused.argtypes = [ptr] * 11 + [i32, i32] + common  # pairs, off_bound
    lib.fam_flash_bwd_fused.restype = ctypes.c_int
    lib.fam_bwd_dq_pairs.argtypes = [i32, i32, i32]  # n_q, n_kv, offset
    lib.fam_bwd_dq_pairs.restype = ctypes.c_int
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


def flash_bwd_fused(q, k, v, do, lse, delta, off, *, sm_scale: float, causal: bool,
                    off_bound: int, workspace: Optional[torch.Tensor] = None):
    """``(dq, dk, dv)`` from the fused kernel and its dQ reduction (CUDA
    tensors, checked by the caller).  ``off_bound``: ``fused_offset_bound``.
    ``workspace``: fp32 of ``dq_workspace_shape``, allocated here when
    None (a caller's shows which slots the kernel wrote)."""
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    shape = dq_workspace_shape(q.shape[0], q.shape[1], q.shape[2], k.shape[2], off_bound)
    if workspace is None:
        workspace = torch.empty(shape, dtype=torch.float32, device=q.device)
    elif (workspace.shape != shape or workspace.dtype != torch.float32
          or workspace.device != q.device or not workspace.is_contiguous()):
        raise ValueError(f"workspace must be a contiguous fp32 {shape} tensor on {q.device}")
    err = _lib().fam_flash_bwd_fused(
        *_inputs(q, k, v, do, lse, delta, off), dk.data_ptr(), dv.data_ptr(), dq.data_ptr(),
        workspace.data_ptr(), shape[0] // (q.shape[0] * q.shape[1]), off_bound,
        *_shape_args(q, k, sm_scale, causal),
    )
    if err:
        raise RuntimeError(f"flash_bwd fused kernel launch failed: cudaError_t {err}")
    flash_bwd_fused.launches += 1
    return dq, dk, dv


# Launches of each CUDA kernel since import (the CPU route does not count).
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_fused.launches = 0


def _checked(q, k, v, o, do, lse, q_offset, sm_scale):
    """Shape checks shared by the backward entry points; returns the scale
    and the offsets as an int32 ``[B]`` tensor."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected [B, H, N, D] q, k, v; got {q.shape}, {k.shape}, {v.shape}")
    batch, heads, n_q, head_dim = q.shape
    if k.shape[0] != batch or k.shape[3] != head_dim or heads % k.shape[1]:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q shape {tuple(q.shape)}")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("o and do must be shaped like q, lse like q[..., 0]")
    off = _offsets(q_offset, batch, k.shape[2] - n_q, q.device)
    if off.shape != (batch,):
        raise ValueError(f"q_offset must be an int or a [{batch}] tensor")
    return default_scale(head_dim) if sm_scale is None else sm_scale, off


def _check_cuda(q, k, v, do, lse, off) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, off)
    _check_cuda_inputs(do, k, v, off)
    if do.dtype != q.dtype:
        raise TypeError("do must share q's dtype")
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("lse must be a contiguous fp32 tensor on q's device")


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
    sm_scale, off = _checked(q, k, v, o, do, lse, q_offset, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, o, do, lse, off, dlse, sm_scale=sm_scale, causal=causal
        )
    _check_cuda(q, k, v, do, lse, off)
    delta = bwd_delta(o, do, dlse)
    kw = dict(sm_scale=sm_scale, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, off, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, off, **kw)
    return dq, dk, dv


def flash_attention_bwd_fused(
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
    q_offset_max: Optional[int] = None,
    **features,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the fused 5-matmul kernel; arguments and
    results as ``flash_attention_bwd`` (``dk``, ``dv`` in ``k``'s dtype, as
    the JAX kernel's).  The kernel's tiles are fixed (``DQ_TILE``).
    ``q_offset_max``: with a tensor ``q_offset``, an int no entry exceeds;
    the dQ workspace then holds only the pairs visible at it, and each
    entry is read no higher than it.  Without it the workspace holds every
    pair.  The JAX wrapper's window/sinks/segment arguments raise
    NotImplementedError if set."""
    reject_unported(features)
    sm_scale, off = _checked(q, k, v, o, do, lse, q_offset, sm_scale)
    bound = fused_offset_bound(q_offset, q_offset_max, q.shape[2], k.shape[2], causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_fused_plain(
            q, k, v, o, do, lse, off.clamp(max=bound), dlse, sm_scale=sm_scale, causal=causal
        )
    _check_cuda(q, k, v, do, lse, off)
    return flash_bwd_fused(q, k, v, do, lse, bwd_delta(o, do, dlse), off,
                           sm_scale=sm_scale, causal=causal, off_bound=bound)


def bwd_route(q: torch.Tensor, k: torch.Tensor, q_offset, *, causal: bool, pos_div: int = 1,
              block_sizes: Optional[BlockSizes] = None) -> str:
    """The kernel(s) ``flash_attention_bwd_auto`` runs: ``"tri"``,
    ``"fused"`` or ``"split"`` (module docstring)."""
    tri_ok = (
        causal
        and k.shape[1] == q.shape[1]
        and q.dtype != torch.float16
        and is_static_offset(q_offset)
        and pos_div == 1
    )
    if block_sizes is not None or pos_div != 1:
        return "split"
    from ..harness.autotune import lookup_bwd

    hit = lookup_bwd(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                     causal, q.dtype, device=q.device)
    if hit is not None:
        impl = hit[0]
        if impl == "fused":
            return "fused"
        if impl == "split" or not tri_ok:
            return "split"
    return "tri" if tri_ok else "split"


def flash_attention_bwd_auto(
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
    pos_div: int = 1,
    block_sizes: Optional[BlockSizes] = None,
    q_offset_max: Optional[int] = None,
    **features,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``, routed to the triangular kernel, the fused kernel
    or the split pair (module docstring).  Arguments as
    ``flash_attention_bwd``; ``q_offset_max`` as ``flash_attention_bwd_fused``
    (only the fused route reads it).  The triangular route returns ``dk``
    and ``dv`` in fp32, the others in ``k``'s dtype, as in JAX.  The split
    pair's tiles are fixed: ``block_sizes`` only skips the tuned lookup."""
    reject_unported(features)
    impl = bwd_route(q, k, q_offset, causal=causal, pos_div=pos_div, block_sizes=block_sizes)
    if impl == "tri":
        from .flash_tri import flash_attention_bwd_tri

        return flash_attention_bwd_tri(
            q, k, v, o, do, lse, dlse, sm_scale=sm_scale, q_offset=q_offset
        )
    if impl == "fused":
        return flash_attention_bwd_fused(
            q, k, v, o, do, lse, q_offset, dlse, sm_scale=sm_scale, causal=causal,
            q_offset_max=q_offset_max,
        )
    return flash_attention_bwd(
        q, k, v, o, do, lse, q_offset, dlse, sm_scale=sm_scale, causal=causal,
        pos_div=pos_div,
    )
