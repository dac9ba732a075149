"""Paged flash attention: causal attention over a pooled KV cache read
through a page table, in bf16/fp32 and over an 8-bit pool.

Counterpart of ``flash_attention_metal_tpu/kernels/paged.py``.  Physical
KV storage is a shared pool of pages ``[P, H_kv, page_size, D]``; each
batch slot owns an int32 row of a table ``[B, max_pages]`` mapping logical
page -> physical page.  Masking is causal in logical positions (the slot's
``lengths[b]`` is the causal offset), so physical placement never enters
the scores.  Entries past ``ceil((lengths[b] + T) / page_size)`` may be
unallocated zeros: the kernels never read past a row block's diagonal.

The CUDA kernels are ``fam_flash_paged`` and ``fam_flash_paged_quant`` of
``csrc/flash_fwd.cu``; a page holds whole 64-row KV tiles, so
``page_size`` is a multiple of 64 (the JAX package asks 128, its lane
width).  The plain versions gather each slot's pages through the table
and run the dense plain attention.  Both kernels take the JAX kernels'
window and sinks (the pages outside both are never read), the softcap and
ALiBi, whose bias measures each row from ``lengths[b]``; ALiBi takes no row
fold (``pos_div`` 1), as in JAX (``paged.py:116, 265``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import default_scale
from .flash_fwd import (
    _DTYPE_CODES,
    _ptr,
    check_xf,
    flash_attention_fwd_plain,
    folds,
    split_args,
    window_args,
)
from .quant import KV_CODES, _lib, check_cuda_tensors, check_scales

# Rows of the kernels' KV tile: a page holds whole tiles.
KV_TILE = 64


def gather_pages(
    pool: torch.Tensor, table: torch.Tensor, n_live: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``pool [P, H_kv, page, ...]`` read through ``table [B, max_pages]``
    as a dense ``[B, H_kv, max_pages * page, ...]``; page ids are clamped
    to ``[0, P - 1]`` as the kernels clamp them.  With ``n_live [B]``, the
    logical pages from ``n_live[b]`` on are zeros, never read from the
    pool (the kernels do not read past a slot's diagonal either)."""
    raw = pool.view(torch.uint8) if pool.element_size() == 1 else pool
    g = raw[table.long().clamp(0, pool.shape[0] - 1)]  # [B, max_pages, H_kv, page, ...]
    if n_live is not None:
        live = torch.arange(table.shape[1], device=table.device)[None, :] < n_live[:, None]
        g = torch.where(live.reshape(*live.shape, *[1] * (g.ndim - 2)), g, torch.zeros_like(g))
    g = g.transpose(1, 2)
    g = g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])
    return g.view(pool.dtype) if pool.element_size() == 1 else g


def flash_attention_paged_plain(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float,
    pos_div: int = 1,
    pool_k_scale: Optional[torch.Tensor] = None,
    pool_v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Both paged kernels' contract in fp32 PyTorch: the slots' pages up to
    each one's last visible column gathered through the table, then the
    dense plain attention (with the 8-bit pool's scales when given)."""
    last = (q.shape[2] - 1) // pos_div + lengths.to(q.device, torch.int64)
    n_live = last // pool_k.shape[2] + 1

    def gather(pool):
        return gather_pages(pool, page_table, n_live)

    scales = {}
    if pool_k_scale is not None:
        scales = dict(k_scale=gather(pool_k_scale), v_scale=gather(pool_v_scale))
    return flash_attention_fwd_plain(
        q, gather(pool_k), gather(pool_v), lengths, sm_scale=sm_scale, causal=True,
        pos_div=pos_div, window=window, sinks=sinks, softcap=softcap,
        alibi_slopes=alibi_slopes, **scales,
    )


def _check(q, pool_k, pool_v, page_table, lengths, pos_div) -> None:
    if q.ndim != 4 or pool_k.ndim != 4 or pool_v.shape != pool_k.shape:
        raise ValueError(f"expected [B, H, T, D] q and [P, H_kv, page, D] pools, got "
                         f"{tuple(q.shape)}, {tuple(pool_k.shape)}, {tuple(pool_v.shape)}")
    batch, heads = q.shape[:2]
    if pool_k.shape[3] != q.shape[3]:
        raise ValueError(f"head_dim mismatch: q {q.shape[3]} vs pool {pool_k.shape[3]}")
    if heads % pool_k.shape[1]:
        raise ValueError(f"q heads ({heads}) must be a multiple of kv heads ({pool_k.shape[1]})")
    if pool_k.shape[2] % KV_TILE:
        raise ValueError(f"page_size={pool_k.shape[2]} must be a multiple of {KV_TILE}")
    if page_table.ndim != 2 or page_table.shape[0] != batch or lengths.shape != (batch,):
        raise ValueError(f"page_table [{batch}, max_pages] and lengths [{batch}] expected, got "
                         f"{tuple(page_table.shape)}, {tuple(lengths.shape)}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if pos_div < 1:
        raise ValueError(f"pos_div={pos_div} must be >= 1")


def flash_attention_paged(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    pos_div: int = 1,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal flash attention reading a bf16/fp32 KV pool through a page
    table (``fam_flash_paged``).

    * ``q``: ``[B, H, T, D]``, the step's query rows, in the pool's dtype.
    * ``pool_k`` / ``pool_v``: ``[P, H_kv, page_size, D]`` (one layer's).
    * ``page_table``: int32 ``[B, max_pages]``; every logical page up to
      ``ceil((lengths[b] + T) / page_size)`` must be allocated.
    * ``lengths``: int32 ``[B]``, the tokens in the cache before this
      step's rows: the causal offset.  ``pos_div``: the GQA decode fold.
    * ``window``, ``sinks``, ``softcap``, ``alibi_slopes``: as
      ``flash_fwd.flash_fwd_general``'s (ALiBi with ``pos_div`` 1 only).
    """
    w, n_sinks = window_args(window, sinks, True)
    _check(q, pool_k, pool_v, page_table, lengths, pos_div)
    cap, slopes = check_xf(softcap, alibi_slopes, q.shape[1], q.device, pos_div)
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(f"the pool must be in q's dtype {q.dtype}, got {pool_k.dtype}")
    if sm_scale is None:
        sm_scale = default_scale(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_paged_plain(
            q, pool_k, pool_v, page_table, lengths, sm_scale=sm_scale, pos_div=pos_div,
            window=window if w else None, sinks=n_sinks, softcap=softcap, alibi_slopes=slopes,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_cuda_tensors(
        q, dict(pool_k=pool_k, pool_v=pool_v), dict(page_table=page_table, lengths=lengths)
    )
    return _launch_paged(q, pool_k, pool_v, page_table, lengths, sm_scale=sm_scale,
                         pos_div=pos_div, window=w, sinks=n_sinks, softcap=cap, slopes=slopes)


def _launch_paged(q, pool_k, pool_v, page_table, lengths, *, sm_scale, pos_div, window=0,
                  sinks=0, softcap=0.0, slopes=None):
    """``fam_flash_paged`` on checked tensors."""
    batch, heads, n_q, head_dim = q.shape
    n_pages, kv_heads, page_size, _ = pool_k.shape
    o = torch.empty_like(q)
    grid, part, tickets, stream = split_args(q, page_table.shape[1] * page_size,
                                             pos_div=pos_div)
    err = _lib().fam_flash_paged(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), o.data_ptr(), batch, heads, kv_heads, n_q, n_pages, page_size,
        page_table.shape[1], head_dim, sm_scale, pos_div, _DTYPE_CODES[q.dtype],
        window, sinks, softcap, _ptr(slopes), grid.kv_chunk, _ptr(part), _ptr(tickets), stream,
    )
    if err:
        raise RuntimeError(f"flash_paged kernel launch failed: cudaError_t {err}")
    flash_attention_paged.launches += 1
    flash_attention_paged.fold_launches += folds(q.dtype, n_q, pos_div)
    flash_attention_paged.grid = grid
    return o


def flash_attention_paged_quant(
    q: torch.Tensor,
    pool_k_q: torch.Tensor,
    pool_v_q: torch.Tensor,
    pool_k_scale: torch.Tensor,
    pool_v_scale: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    pos_div: int = 1,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal flash attention over an 8-bit paged pool
    (``fam_flash_paged_quant``): ``flash_attention_paged`` with
    ``flash_attention_quant``'s arithmetic.

    * ``pool_k_q`` / ``pool_v_q``: ``[P, H_kv, page_size, D]`` int8/fp8.
    * ``pool_k_scale`` / ``pool_v_scale``: fp32 ``[P, H_kv, page_size]``.
    * ``page_table`` / ``lengths``, ``window`` / ``sinks``, ``softcap`` /
      ``alibi_slopes``: as ``flash_attention_paged``.
    """
    w, n_sinks = window_args(window, sinks, True)
    _check(q, pool_k_q, pool_v_q, page_table, lengths, pos_div)
    check_scales(pool_k_q, pool_v_q, pool_k_scale, pool_v_scale)
    cap, slopes = check_xf(softcap, alibi_slopes, q.shape[1], q.device, pos_div)
    if sm_scale is None:
        sm_scale = default_scale(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_paged_plain(
            q, pool_k_q, pool_v_q, page_table, lengths, sm_scale=sm_scale, pos_div=pos_div,
            pool_k_scale=pool_k_scale, pool_v_scale=pool_v_scale,
            window=window if w else None, sinks=n_sinks, softcap=softcap, alibi_slopes=slopes,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_cuda_tensors(
        q, dict(pool_k_q=pool_k_q, pool_v_q=pool_v_q),
        dict(pool_k_scale=pool_k_scale, pool_v_scale=pool_v_scale, page_table=page_table,
             lengths=lengths),
    )
    return _launch_paged_quant(q, pool_k_q, pool_v_q, pool_k_scale, pool_v_scale, page_table,
                               lengths, sm_scale=sm_scale, pos_div=pos_div, window=w,
                               sinks=n_sinks, softcap=cap, slopes=slopes)


def _launch_paged_quant(q, pool_k_q, pool_v_q, pool_k_scale, pool_v_scale, page_table, lengths,
                        *, sm_scale, pos_div, window=0, sinks=0, softcap=0.0, slopes=None):
    """``fam_flash_paged_quant`` on checked tensors."""
    batch, heads, n_q, head_dim = q.shape
    n_pages, kv_heads, page_size, _ = pool_k_q.shape
    o = torch.empty_like(q)
    grid, part, tickets, stream = split_args(q, page_table.shape[1] * page_size,
                                             pos_div=pos_div)
    err = _lib().fam_flash_paged_quant(
        q.data_ptr(), pool_k_q.data_ptr(), pool_v_q.data_ptr(), pool_k_scale.data_ptr(),
        pool_v_scale.data_ptr(), page_table.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        batch, heads, kv_heads, n_q, n_pages, page_size, page_table.shape[1], head_dim,
        sm_scale, pos_div, _DTYPE_CODES[q.dtype], KV_CODES[pool_k_q.dtype],
        window, sinks, softcap, _ptr(slopes), grid.kv_chunk, _ptr(part), _ptr(tickets), stream,
    )
    if err:
        raise RuntimeError(f"flash_paged_quant kernel launch failed: cudaError_t {err}")
    flash_attention_paged_quant.launches += 1
    flash_attention_paged_quant.fold_launches += folds(q.dtype, n_q, pos_div)
    flash_attention_paged_quant.grid = grid
    return o


# Launches of each CUDA kernel since import (the CPU route does not count),
# those on the folded grid among them (flash_fwd.folds), and each one's grid
# at its last launch (flash_fwd.SplitGrid; None before one).
flash_attention_paged.launches = 0
flash_attention_paged.fold_launches = 0
flash_attention_paged.grid = None
flash_attention_paged_quant.launches = 0
flash_attention_paged_quant.fold_launches = 0
flash_attention_paged_quant.grid = None
