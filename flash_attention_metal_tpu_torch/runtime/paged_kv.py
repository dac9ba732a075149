"""Paged KV caches: pooled pages, per-slot page tables and the host
allocator.

Counterpart of ``flash_attention_metal_tpu/runtime/paged_kv.py``.  Storage
(vs the dense cache's ``[L, B, H_kv, max_len, D]``):

* ``pool_k``/``pool_v``: ``[n_layers, n_pages, H_kv, page_size, D]``, one
  physical pool shared by the slots; a page holds ``page_size`` consecutive
  tokens of the slots whose tables name it.  Every layer uses the same
  logical -> physical mapping, so one table serves them all.
* ``page_table``: int32 ``[B, max_pages]``, the physical page of each
  logical page, 0 where unallocated.
* ``lengths``: int32 ``[B]``, valid tokens per slot.

The allocator lives on the host (``PageAllocator``): pages are granted at
admission and before decode steps and released at retirement, and it
writes only the table entries that change, in place on the device, never
reading a device value back.  Page 0 is never granted: a released slot's
table row is all zeros, so the writes its still-running decode steps make
land on page 0 and never on another request's pages.

As in ``kv_cache.py``, the updates are in place; each function still
returns the cache so call sites read as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..kernels.quant import quantize_tokens
from .kv_cache import as_bytes


@dataclasses.dataclass
class PagedKVCache:
    pool_k: torch.Tensor  # [L, P, H_kv, page_size, D]
    pool_v: torch.Tensor
    page_table: torch.Tensor  # [B, max_pages] int32
    lengths: torch.Tensor  # [B] int32

    @property
    def page_size(self) -> int:
        return self.pool_k.shape[3]

    @property
    def n_pages(self) -> int:
        return self.pool_k.shape[1]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_len(self) -> int:
        # Logical capacity per slot; the pool may hold fewer tokens than
        # B * max_len (oversubscription is the point of paging).
        return self.max_pages * self.page_size


@dataclasses.dataclass
class PagedQuantKVCache:
    """8-bit paged pool: int8/fp8 pages and per-token fp32 scale pages, with
    ``PagedKVCache``'s table and lengths.  Tokens are quantized at append
    (``kv_cache.append_tokens_quant``'s arithmetic)."""

    pool_k_q: torch.Tensor  # [L, P, H_kv, page_size, D] int8/fp8
    pool_v_q: torch.Tensor
    pool_k_scale: torch.Tensor  # [L, P, H_kv, page_size] fp32
    pool_v_scale: torch.Tensor
    page_table: torch.Tensor  # [B, max_pages] int32
    lengths: torch.Tensor  # [B] int32

    @property
    def page_size(self) -> int:
        return self.pool_k_q.shape[3]

    @property
    def n_pages(self) -> int:
        return self.pool_k_q.shape[1]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_len(self) -> int:
        return self.max_pages * self.page_size


def _check_pages(page_size: int, max_len: int) -> None:
    if page_size % 128:
        raise ValueError(f"page_size={page_size} must be a multiple of 128")
    if max_len % page_size:
        raise ValueError(f"max_len={max_len} must be a multiple of page_size")


def init_paged_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    max_len: int,
    head_dim: int,
    *,
    n_pages: int,
    page_size: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[torch.device] = None,
) -> PagedKVCache:
    """``n_pages`` physical pages shared by ``batch`` slots of up to
    ``max_len`` logical tokens each."""
    _check_pages(page_size, max_len)
    shape = (n_layers, n_pages, n_kv_heads, page_size, head_dim)
    return PagedKVCache(
        pool_k=torch.zeros(shape, dtype=dtype, device=device),
        pool_v=torch.zeros(shape, dtype=dtype, device=device),
        page_table=torch.zeros((batch, max_len // page_size), dtype=torch.int32, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def init_paged_quant_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    max_len: int,
    head_dim: int,
    *,
    n_pages: int,
    page_size: int = 128,
    dtype: torch.dtype = torch.int8,
    device: Optional[torch.device] = None,
) -> PagedQuantKVCache:
    _check_pages(page_size, max_len)
    shape = (n_layers, n_pages, n_kv_heads, page_size, head_dim)
    return PagedQuantKVCache(
        pool_k_q=torch.zeros(shape, dtype=dtype, device=device),
        pool_v_q=torch.zeros(shape, dtype=dtype, device=device),
        # Scale 0 for rows never written, as in JAX (the dense 8-bit cache
        # starts at 1; either keeps stale zeros at 0).
        pool_k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        pool_v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        page_table=torch.zeros((batch, max_len // page_size), dtype=torch.int32, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


class PageAllocator:
    """Host refcounted free list over the physical pool.

    Page 0 is reserved: it is the placeholder of unallocated table entries,
    so a zeroed table row is always safe to index through.  A page may be
    named by several slots' tables (prefix sharing) and pinned by the
    engine's prefix registry; it returns to the free list when its last
    reference drops.  ``reserve`` accounts each request's worst-case page
    footprint at admission, so growth in flight never finds the pool empty.
    """

    def __init__(self, n_pages: int, batch: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(batch)]
        self._refs: List[int] = [0] * n_pages
        self._reserved: List[int] = [0] * batch
        self._committed = 0
        self._pinned = 0
        self._capacity = n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_of(self, slot: int) -> int:
        return len(self._owned[slot])

    def can_reserve(self, pages: int) -> bool:
        return self._committed + self._pinned + pages <= self._capacity

    def reserve(self, slot: int, pages: int) -> None:
        if not self.can_reserve(pages):
            raise MemoryError(
                f"cannot reserve {pages} pages "
                f"({self._capacity - self._committed - self._pinned} uncommitted)"
            )
        self._committed += pages - self._reserved[slot]
        self._reserved[slot] = pages

    def adopt(self, cache, slot: int, phys: int):
        """Install an existing (shared) physical page as ``slot``'s next
        logical page, taking a reference."""
        owned = self._owned[slot]
        if len(owned) >= cache.max_pages:
            raise ValueError(f"slot {slot} table full")
        self._refs[phys] += 1
        cache.page_table[slot, len(owned)] = phys
        owned.append(phys)
        return cache

    def pin(self, phys: int) -> None:
        """The registry's reference: keeps a prefix page resident after its
        last slot releases it (dropped by ``unpin`` under pressure)."""
        self._refs[phys] += 1
        self._pinned += 1

    def unpin(self, phys: int) -> None:
        self._refs[phys] -= 1
        self._pinned -= 1
        if self._refs[phys] == 0:
            self._free.append(phys)

    def grow(self, cache, slot: int, n_tokens: int):
        """Ensure ``slot`` owns pages for ``n_tokens`` logical tokens,
        writing each new page's id into the table."""
        need_pages = -(-n_tokens // cache.page_size)
        owned = self._owned[slot]
        if need_pages > cache.max_pages:
            raise ValueError(
                f"slot {slot} wants {need_pages} pages > max_pages {cache.max_pages}"
            )
        while len(owned) < need_pages:
            if not self._free:
                raise MemoryError(
                    f"page pool exhausted growing slot {slot} to {n_tokens} tokens "
                    f"({need_pages} pages)"
                )
            phys = self._free.pop()
            self._refs[phys] = 1
            cache.page_table[slot, len(owned)] = phys
            owned.append(phys)
        return cache

    def release(self, cache, slot: int):
        """Drop ``slot``'s page references and zero its table row and length
        (the paged ``kv_cache.reset_slot``).  Shared or pinned pages survive
        until their last reference drops."""
        for phys in reversed(self._owned[slot]):
            self._refs[phys] -= 1
            if self._refs[phys] == 0:
                self._free.append(phys)
        self._owned[slot] = []
        self._committed -= self._reserved[slot]
        self._reserved[slot] = 0
        cache.page_table[slot] = 0
        cache.lengths[slot] = 0
        return cache


def _token_slots(cache, t: int):
    """``(phys, row)``, both ``[B, T]``: where positions ``lengths[b] ..
    lengths[b] + T - 1`` live in the pool (the logical page clamped to the
    table, as JAX's ``take_along_axis`` after ``clip``)."""
    pos = cache.lengths[:, None] + torch.arange(t, device=cache.lengths.device)
    logical = (pos // cache.page_size).clamp(0, cache.max_pages - 1)
    phys = torch.gather(cache.page_table, 1, logical.long())
    return phys.long(), (pos % cache.page_size).long()


def append_tokens_paged(
    cache: PagedKVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor
) -> PagedKVCache:
    """Write ``[B, H_kv, T, D]`` keys/values at each slot's write head,
    through the table.  Requires the pages of ``lengths[b] + T`` tokens to be
    allocated (``PageAllocator.grow``).  Does NOT bump ``lengths``."""
    phys, row = _token_slots(cache, k_new.shape[2])
    # Advanced indices around a slice: the indexed view is [B, T, H, D].
    cache.pool_k[layer][phys, :, row] = k_new.transpose(1, 2).to(cache.pool_k.dtype)
    cache.pool_v[layer][phys, :, row] = v_new.transpose(1, 2).to(cache.pool_v.dtype)
    return cache


def append_tokens_paged_quant(
    cache: PagedQuantKVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor
) -> PagedQuantKVCache:
    """Quantize ``[B, H_kv, T, D]`` keys/values per token and write them and
    their scales through the table (``append_tokens_paged``'s semantics)."""
    phys, row = _token_slots(cache, k_new.shape[2])
    xq, scale = quantize_tokens(torch.stack((k_new, v_new)), cache.pool_k_q.dtype)
    pools = ((cache.pool_k_q, cache.pool_k_scale), (cache.pool_v_q, cache.pool_v_scale))
    for i, (pool, spool) in enumerate(pools):
        as_bytes(pool[layer])[phys, :, row] = as_bytes(xq[i].transpose(1, 2))
        spool[layer][phys, :, row] = scale[i].transpose(1, 2)
    return cache


def gather_slot_kv(cache: PagedKVCache, layer: int, slot: int) -> tuple:
    """One slot's KV as dense ``[H_kv, max_len, D]`` (a test helper)."""
    table = cache.page_table[slot].long()

    def dense(pool):
        x = pool[layer][table]  # [max_pages, H, ps, D]
        return x.transpose(0, 1).reshape(x.shape[1], -1, x.shape[3])

    return dense(cache.pool_k), dense(cache.pool_v)
