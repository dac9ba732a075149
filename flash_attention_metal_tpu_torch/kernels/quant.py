"""Attention against an 8-bit (int8 / fp8) KV cache: quantization, the CUDA
kernel's wrapper and its plain version.

Counterpart of ``flash_attention_metal_tpu/kernels/quant.py``.  The scheme
is the JAX package's: symmetric per-token absmax,

* ``k_q[t] = round(k[t] / s_k[t])`` (int8, half to even, clipped) or the
  plain cast (fp8), with ``s_k[t] = max(absmax(k[t]), 1e-12) / QMAX``;
* the K scale multiplies each score column, ``S[:, t] = (q . k_q[t]) *
  s_k[t] * sm_scale``, and the V scale folds into P, ``O += (P * s_v)[:, t]
  v_q[t]``.

The scales are kept ``[B, H_kv, N]``: the JAX package's ``[B, H, N / 128,
128]`` is a reshape for the TPU's 128 lanes, which the CUDA kernel
(``csrc/flash_fwd.cu``, ``fam_flash_quant``) does not need.  On the H100 the
fp8 formats are native: the TPU note that they run ~10x slower than int8
is a v5e fact, not this card's.

The wrapper takes the plain version for a tensor on the CPU and launches
the kernel, or raises, for a CUDA tensor.  It takes the JAX kernel's
window with its sinks, the softcap and ALiBi (which, as in JAX
``quant.py:377-384``, needs ``causal`` and no row fold), and a rolling
cache's ``kv_positions`` (causal, no row fold), which moves the mask and
ALiBi's distance into position space.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch

from ..config import default_scale
from . import _build
from .flash_fwd import (
    _DTYPE_CODES,
    DECODE_ROWS,
    KV_TILE,
    _new_outputs,
    _offsets,
    _ptr,
    check_head_dim,
    check_positions,
    check_xf,
    flash_attention_fwd_plain,
    folds,
    split_args,
    walk_tiles,
    window_args,
)

# Largest magnitude of each 8-bit format: the per-token scale maps a token's
# absmax onto it.
_QMAX = {
    torch.int8: 127.0,
    torch.float8_e4m3fn: 448.0,
    torch.float8_e5m2: 57344.0,
}
# The kernel's code for each 8-bit element type.
KV_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}
# The device kernel each route of kv_route launches (its name's stem, as a
# profiler trace shows it); the folded route's instances are the wgmma
# forward's on its folded walk (KV_ROUTE_WALKS: the walk in their names).
KV_ROUTE_KERNELS = {"decode": "flash_decode_kernel", "wgmma": "flash_fwd_sm90_kernel",
                    "fold": "flash_fwd_sm90_kernel", "template": "flash_fwd_kernel"}
KV_ROUTE_WALKS = {"fold": "FoldWalk"}


def kv_route(dtype: torch.dtype, n_q: int, pos_div: int = 1) -> str:
    """The kernel a call of the cache entries (``fam_flash_quant``,
    ``fam_flash_paged``, ``fam_flash_paged_quant``, and for these calls the
    dense ``fam_flash_fwd``) runs on the card, as ``csrc/flash_fwd.cu::
    launch`` routes it: ``"decode"``, the split-KV grid
    (``csrc/flash_decode.cuh``), for at most ``DECODE_ROWS`` query rows;
    ``"wgmma"``, the wgmma forward from the cache's KV source
    (``csrc/flash_kv_sm90.cu`` on ``flash_fwd_sm90.cuh``), for bf16 q
    without a row fold; ``"fold"``, the wgmma forward's split-KV folded grid
    (``csrc/flash_fold_sm90.cu``), for bf16 q folded by GQA (``pos_div >
    1``: a speculative verify window); else ``"template"``, the 64-row
    template of ``flash_fwd.cu`` (fp32 q).  Windows, sinks, the transforms
    and position maps do not change the route."""
    if n_q <= DECODE_ROWS:
        return "decode"
    if dtype == torch.bfloat16:
        return "wgmma" if pos_div == 1 else "fold"
    return "template"


@dataclasses.dataclass
class QuantizedKV:
    """An 8-bit KV pair with per-token scales."""

    k_q: torch.Tensor  # [B, H_kv, N, D] int8 / fp8
    v_q: torch.Tensor
    k_scale: torch.Tensor  # [B, H_kv, N] fp32
    v_scale: torch.Tensor

    @property
    def seq_len(self) -> int:
        return self.k_q.shape[2]


def quantize_tokens(x: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token absmax over the last dim: ``(x_q, scale)`` with
    ``scale`` fp32 of ``x``'s shape without its last dim.

    The JAX package's arithmetic in fp32, as its jitted serving steps run
    it: XLA turns ``absmax / QMAX`` into ``absmax * (1 / QMAX)``, which is
    one ulp off the quotient for about half the tokens, so the scale is
    taken that way here.  ``round`` is half to even and the fp8 casts round
    to nearest even in both packages (an element at the absmax may land a
    hair above QMAX; both round it to QMAX).
    """
    qmax = _QMAX[dtype]
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) * (1.0 / qmax)
    xs = xf / scale
    if dtype == torch.int8:
        xq = xs.round().clamp(-qmax, qmax).to(dtype)
    else:
        xq = xs.to(dtype)
    return xq, scale[..., 0]


def quantize_kv(k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype = torch.int8) -> QuantizedKV:
    """Symmetric per-token absmax quantization of a ``[B, H, N, D]`` pair."""
    k_q, k_scale = quantize_tokens(k, dtype)
    v_q, v_scale = quantize_tokens(v, dtype)
    return QuantizedKV(k_q, v_q, k_scale, v_scale)


def dequantize_kv(qkv: QuantizedKV, dtype: torch.dtype = torch.bfloat16):
    """``(k, v)`` back in ``dtype`` (for testing)."""

    def dq(xq, scale):
        return (xq.float() * scale[..., None]).to(dtype)

    return dq(qkv.k_q, qkv.k_scale), dq(qkv.v_q, qkv.v_scale)


def flash_attention_quant_plain(
    q: torch.Tensor,
    qkv: QuantizedKV,
    q_offset: torch.Tensor,
    *,
    sm_scale: float,
    causal: bool,
    pos_div: int = 1,
    save_lse: bool = False,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The kernel's contract in fp32 PyTorch (``q_offset``: int32 ``[B]``);
    the softcap acts on the score with its K scale, as in JAX."""
    return flash_attention_fwd_plain(
        q, qkv.k_q, qkv.v_q, q_offset, sm_scale=sm_scale, causal=causal,
        pos_div=pos_div, save_lse=save_lse, k_scale=qkv.k_scale, v_scale=qkv.v_scale,
        window=window, sinks=sinks, softcap=softcap, alibi_slopes=alibi_slopes,
        kv_positions=kv_positions,
    )


_LOG2E = 1.4426950408889634


def kv_prefill_walk_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: torch.Tensor,
    *,
    sm_scale: float,
    causal: bool = True,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of the wgmma prefill (``csrc/flash_kv_sm90.cu`` on
    ``flash_fwd_sm90.cuh``), step by step in PyTorch: ``(o, lse)``.

    The CUDA kernel cannot run on the CPU; its walk can.  Each 64-row Q
    tile of each batch walks the 64-column KV tiles of ``walk_tiles`` (every
    tile under ``kv_positions``); a step reads its tile's rows, through
    ``page_table`` (``[B, max_pages]``, ``k``/``v`` then a pool ``[P, H_kv,
    page, D]``) with the logical page clamped to ``max_pages - 1`` and the
    physical one to ``[0, P - 1]``; widens 8-bit elements exactly; scores
    ``q . k`` in fp32 times the K scale, then ``sm_scale log2 e`` (or the
    cap ``c2 tanh(s sm_scale / cap)``, ``c2 = cap log2 e``) and ALiBi's
    ``slope log2 e (c - p)``; takes the online softmax in log2 units; and
    adds ``P * s_v``, rounded to q's type, times V.  The row sums take P
    unscaled.  Scales are ``[B, H_kv, N]`` (dense) or ``[P, H_kv, page]``;
    only the tiles a walk visits are read, so page 0 may hold NaN.  Rows
    that see nothing give 0 and -inf.  Tests only.
    """
    batch, heads, n_q, head_dim = q.shape
    kv_heads = k.shape[1]
    group = heads // kv_heads
    paged = page_table is not None
    page = k.shape[2]
    n_kv = page_table.shape[1] * page if paged else page
    q_offset = q_offset.to(torch.int64)
    slopes2 = None if alibi_slopes is None else alibi_slopes.double() * _LOG2E
    o = torch.zeros((batch, heads, n_q, head_dim), dtype=torch.float32)
    lse = torch.full((batch, heads, n_q), float("-inf"))

    def tile_of(x, b, kv_start):
        """The 64 rows of x from logical column kv_start, zero past n_kv."""
        if paged:
            logical = min(kv_start // page, page_table.shape[1] - 1)
            phys = int(page_table[b, logical].clamp(0, x.shape[0] - 1))
            rows = x[phys, :, kv_start % page:kv_start % page + KV_TILE]
        else:
            rows = x[b, :, kv_start:kv_start + KV_TILE]
        rows = rows.float()  # every 8-bit value is exact in fp32 (and in bf16)
        pad = KV_TILE - rows.shape[1]
        if pad:
            rows = torch.cat([rows, rows.new_zeros((rows.shape[0], pad, *rows.shape[2:]))], 1)
        return rows.repeat_interleave(group, dim=0)

    for b in range(batch):
        off = int(q_offset[b]) if causal else n_kv
        for q_start in range(0, n_q, KV_TILE):
            rows = min(KV_TILE, n_q - q_start)
            qt = q[b, :, q_start:q_start + rows].float()
            pos = torch.arange(q_start, q_start + rows)[:, None] + int(q_offset[b])
            if kv_positions is not None:
                tiles = range(-(-n_kv // KV_TILE))
            else:
                tiles = walk_tiles(q_start + off, q_start + rows - 1 + off, n_kv, window, sinks)
            m = torch.full((heads, rows, 1), float("-inf"))
            lsum = torch.zeros((heads, rows, 1))
            acc = torch.zeros((heads, rows, head_dim))
            for tile in tiles:
                kv_start = tile * KV_TILE
                col = torch.arange(kv_start, kv_start + KV_TILE)
                s = torch.matmul(qt, tile_of(k, b, kv_start).transpose(-1, -2))
                if k_scale is not None:
                    s = s * tile_of(k_scale, b, kv_start)[:, None, :]
                s = (softcap * _LOG2E * torch.tanh(s * (sm_scale / softcap)) if softcap
                     else s * (sm_scale * _LOG2E))
                cpos = col if kv_positions is None else torch.cat(
                    [kv_positions[b].long(), kv_positions.new_full((KV_TILE,), -1).long()]
                )[kv_start:kv_start + KV_TILE]
                seen = (col < n_kv)[None, :].expand(rows, -1)
                if causal:
                    seen = seen & (cpos[None, :] <= pos)
                    if kv_positions is not None:
                        seen = seen & (cpos[None, :] >= 0)
                    if window is not None:
                        seen = seen & ((cpos[None, :] > pos - window) | (cpos[None, :] < sinks))
                bias = 0.0
                if slopes2 is not None:
                    bias = slopes2[:, None, None] * (cpos[None, :] - pos).double()[None]
                x = (s.double() + bias).float().masked_fill(~seen, float("-inf"))
                m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
                ref = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
                alpha = torch.exp2(m - ref)
                p = torch.exp2(x - ref)
                lsum = lsum * alpha + p.sum(dim=-1, keepdim=True)
                if v_scale is not None:
                    p = p * tile_of(v_scale, b, kv_start)[:, None, :]
                p = p.to(q.dtype).float()
                acc = acc * alpha + torch.matmul(p, tile_of(v, b, kv_start))
                m = m_new
            seen_any = lsum > 0
            o[b, :, q_start:q_start + rows] = torch.where(
                seen_any, acc / torch.where(seen_any, lsum, torch.ones_like(lsum)), 0.0)
            lse[b, :, q_start:q_start + rows] = torch.where(
                seen_any, (m + torch.log2(torch.where(seen_any, lsum, torch.ones_like(lsum))))
                * (1.0 / _LOG2E), float("-inf"))[..., 0]
    return o.to(q.dtype), lse


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of ``csrc/flash_fwd.cu``'s 8-bit and paged
    entry points on a loaded library."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fam_flash_quant.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q, k_q, v_q, k/v scale, q_offset, o, lse
        i32, i32, i32, i32, i32, i32,  # batch, heads, kv heads, n_q, n_kv, head_dim
        f32, i32, i32, i32, i32,  # sm_scale, causal, pos_div, dtype, kv dtype
        i32, i32,  # window (0: none), sinks
        f32, ptr,  # softcap (0: none), ALiBi slopes
        ptr,  # kv positions (null: none)
        i32, ptr, ptr,  # kv_chunk, part, tickets
        ptr,  # stream
    ]
    lib.fam_flash_paged.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, pool k/v, table, lengths, o
        i32, i32, i32, i32,  # batch, heads, kv heads, n_q
        i32, i32, i32, i32,  # n_pages, page_size, max_pages, head_dim
        f32, i32, i32,  # sm_scale, pos_div, dtype
        i32, i32,  # window (0: none), sinks
        f32, ptr,  # softcap (0: none), ALiBi slopes
        i32, ptr, ptr,  # kv_chunk, part, tickets
        ptr,  # stream
    ]
    lib.fam_flash_paged_quant.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q, pool k/v, k/v scale, table, lengths, o
        i32, i32, i32, i32,  # batch, heads, kv heads, n_q
        i32, i32, i32, i32,  # n_pages, page_size, max_pages, head_dim
        f32, i32, i32, i32,  # sm_scale, pos_div, dtype, kv dtype
        i32, i32,  # window (0: none), sinks
        f32, ptr,  # softcap (0: none), ALiBi slopes
        i32, ptr, ptr,  # kv_chunk, part, tickets
        ptr,  # stream
    ]
    for fn in (lib.fam_flash_quant, lib.fam_flash_paged, lib.fam_flash_paged_quant):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load())


def check_cuda_tensors(q: torch.Tensor, rows: dict, others: dict) -> None:
    """What the kernels of ``csrc/flash_fwd.cu`` take: bf16 or fp32 ``q`` of
    head dim 64 or 128; every tensor on q's device and contiguous; q and the K/V
    storage (``rows``, read 16 bytes at a time) 16-byte aligned."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes bf16 or fp32 q, got {q.dtype}")
    check_head_dim(q.shape[-1])
    rows = {"q": q, **rows}
    for name, t in (*rows.items(), *others.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in rows and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def check_scales(kq: torch.Tensor, vq: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor) -> None:
    """8-bit K/V of one type with fp32 scales of their shape without D."""
    if kq.dtype not in KV_CODES or vq.dtype != kq.dtype:
        raise TypeError(f"8-bit K/V of one type expected, got {kq.dtype}, {vq.dtype}")
    if vq.shape != kq.shape or ks.shape != kq.shape[:-1] or vs.shape != kq.shape[:-1]:
        raise ValueError(
            f"K/V {tuple(kq.shape)}, {tuple(vq.shape)} with scales "
            f"{tuple(ks.shape)}, {tuple(vs.shape)}: scales are K/V's shape without D"
        )
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError("scales must be fp32")


def flash_attention_quant(
    q: torch.Tensor,
    qkv: QuantizedKV,
    q_offset: Union[None, int, torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    save_lse: bool = False,
    pos_div: int = 1,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flash attention of ``q [B, H, N_q, D]`` (bf16/fp32) against an 8-bit
    cache (``csrc/flash_fwd.cu``, ``fam_flash_quant``).

    Native GQA (q-head ``h`` reads KV head ``h // group``).  With
    ``causal``, row ``r`` of batch ``b`` sees columns ``c <= r // pos_div +
    q_offset[b]``; ``q_offset`` is an int or a ``[B]`` tensor and defaults
    to ``n_kv - n_q // pos_div``; ``pos_div > 1`` (the GQA decode fold)
    needs ``causal``.  Returns ``o`` in q's dtype, or ``(o, lse)`` with lse
    fp32 ``[B, H, N_q]``; rows with nothing visible give 0 and -inf.
    ``window`` and ``sinks`` (with ``causal``) as ``flash_fwd_general``'s:
    the KV tiles outside both are skipped.  ``softcap`` and
    ``alibi_slopes`` as ``flash_fwd_general``'s, on the K-scaled score;
    ALiBi needs ``causal`` and ``pos_div`` 1, as in JAX.  ``kv_positions``
    (int32 ``[B, N_kv]``) as ``flash_fwd_general``'s: the mask, the window
    and ALiBi in the positions the slots hold, every KV tile visited.
    """
    w, n_sinks = window_args(window, sinks, causal)
    if alibi_slopes is not None and not causal:
        raise ValueError("alibi_slopes requires causal=True on the quant path")
    check_scales(qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)
    if q.ndim != 4 or qkv.k_q.ndim != 4 or qkv.k_q.shape[0] != q.shape[0] \
            or qkv.k_q.shape[3] != q.shape[3] or q.shape[1] % qkv.k_q.shape[1]:
        raise ValueError(f"8-bit K/V {tuple(qkv.k_q.shape)} does not fit q {tuple(q.shape)}")
    batch, heads, n_q, head_dim = q.shape
    if pos_div < 1 or (pos_div > 1 and not causal):
        raise NotImplementedError("pos_div > 1 requires causal=True")
    cap, slopes = check_xf(softcap, alibi_slopes, heads, q.device, pos_div)
    n_kv = qkv.seq_len
    pos = check_positions(kv_positions, batch, n_kv, causal=causal, pos_div=pos_div,
                          device=q.device)
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    off = _offsets(q_offset, batch, n_kv - n_q // pos_div, q.device)
    if off.shape != (batch,):
        raise ValueError(f"q_offset must be an int or a [{batch}] tensor")

    if q.device.type == "cpu":
        return flash_attention_quant_plain(
            q, qkv, off, sm_scale=sm_scale, causal=causal, pos_div=pos_div, save_lse=save_lse,
            window=window if w else None, sinks=n_sinks, softcap=softcap, alibi_slopes=slopes,
            kv_positions=pos,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_cuda_tensors(
        q, dict(k_q=qkv.k_q, v_q=qkv.v_q),
        dict(k_scale=qkv.k_scale, v_scale=qkv.v_scale, q_offset=off,
             **({} if pos is None else dict(kv_positions=pos))),
    )
    return _launch_quant(q, qkv, off, sm_scale=sm_scale, causal=causal, pos_div=pos_div,
                         save_lse=save_lse, window=w, sinks=n_sinks, softcap=cap, slopes=slopes,
                         kv_positions=pos)


def _launch_quant(q, qkv, off, *, sm_scale, causal, pos_div, save_lse, window=0, sinks=0,
                  softcap=0.0, slopes=None, kv_positions=None):
    """``fam_flash_quant`` on checked tensors: ``o`` or ``(o, lse)``."""
    batch, heads, n_q, head_dim = q.shape
    n_kv = qkv.seq_len
    o, lse = _new_outputs(q, save_lse)
    grid, part, tickets, stream = split_args(q, n_kv, pos_div=pos_div)
    err = _lib().fam_flash_quant(
        q.data_ptr(), qkv.k_q.data_ptr(), qkv.v_q.data_ptr(), qkv.k_scale.data_ptr(),
        qkv.v_scale.data_ptr(), off.data_ptr(), o.data_ptr(), _ptr(lse),
        batch, heads, qkv.k_q.shape[1], n_q, n_kv, head_dim, sm_scale, int(causal),
        pos_div, _DTYPE_CODES[q.dtype], KV_CODES[qkv.k_q.dtype], window, sinks,
        softcap, _ptr(slopes), _ptr(kv_positions), grid.kv_chunk, _ptr(part), _ptr(tickets),
        stream,
    )
    if err:
        raise RuntimeError(f"flash_quant kernel launch failed: cudaError_t {err}")
    flash_attention_quant.launches += 1
    flash_attention_quant.pos_launches += kv_positions is not None
    flash_attention_quant.fold_launches += folds(q.dtype, n_q, pos_div)
    flash_attention_quant.grid = grid
    return (o, lse) if save_lse else o


# Launches of the CUDA kernel since import (the CPU route does not count),
# those with a position map among them (its kPos instances) and those on
# the folded grid (flash_fwd.folds), and its grid at the last launch
# (flash_fwd.SplitGrid; None before one).
flash_attention_quant.launches = 0
flash_attention_quant.pos_launches = 0
flash_attention_quant.fold_launches = 0
flash_attention_quant.grid = None
