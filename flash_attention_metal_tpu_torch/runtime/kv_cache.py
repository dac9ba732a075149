"""Per-slot KV caches for autoregressive decode: dense bf16/fp32 and 8-bit,
and their rolling (wrapped) forms for sliding-window models.

Counterpart of the ``KVCache``, ``QuantKVCache``, ``RollingKVCache`` and
``RollingQuantKVCache`` of ``flash_attention_metal_tpu/runtime/kv_cache.py``:
``[L, B, H_kv, max_len, D]`` keys and values (8-bit ones with per-token
scales) and per-slot valid lengths.  Ragged lengths reach the kernel as its
per-batch causal offset, never as dynamic shapes.  A rolling cache holds
O(window) slots and a ``[B, capacity]`` map of the position each slot
holds; the kernels mask in position space (``kv_positions``), so eviction
is being overwritten.

The JAX functions return a new cache, and the jitted steps donate the old
one so XLA updates it in place.  Here the updates are in place outright;
each function still returns the cache so call sites read the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.quant import quantize_tokens


@dataclasses.dataclass
class KVCache:
    """k/v: ``[n_layers, B, H_kv, max_len, head_dim]``; lengths: int32 ``[B]``."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def init_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    max_len: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[torch.device] = None,
) -> KVCache:
    if max_len % 128:
        raise ValueError(f"max_len={max_len} must be a multiple of 128")
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def append_tokens(
    cache: KVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor
) -> KVCache:
    """Write ``[B, H_kv, T, D]`` keys/values at each slot's write head.

    Does NOT bump ``lengths`` (the caller bumps once after all layers).
    Like ``jax.lax.dynamic_update_slice``, the start is clamped so that
    the ``T`` rows fit: a slot at ``max_len - 1`` writes rows
    ``max_len - T .. max_len - 1``.
    """
    slots, rows = _write_rows(cache, k_new.shape[0], k_new.shape[2])
    # Advanced indices around a slice: the indexed view is [B, T, H, D].
    cache.k[layer][slots, :, rows] = k_new.transpose(1, 2).to(cache.k.dtype)
    cache.v[layer][slots, :, rows] = v_new.transpose(1, 2).to(cache.v.dtype)
    return cache


def _write_rows(cache, batch: int, t: int):
    """``(slots [B, 1], rows [B, T])``: the cache rows the next ``T``
    tokens of each slot go to, the start clamped like
    ``jax.lax.dynamic_update_slice``'s."""
    start = cache.lengths.clamp(0, cache.max_len - t)
    rows = start[:, None] + torch.arange(t, device=start.device)
    return torch.arange(batch, device=start.device)[:, None], rows


def bump_lengths(cache, n: int, mask: torch.Tensor):
    """Advance write heads by ``n`` for slots where ``mask`` is True (every
    cache kind: dense, 8-bit, paged)."""
    cache.lengths += torch.where(mask, n, 0).to(torch.int32)
    return cache


def reset_slot(cache, slot: int):
    """Free a slot of a dense, 8-bit or rolling cache for reuse: ``lengths
    = 0`` masks its stale KV, and a rolling cache's positions go back to -1
    so the next occupant cannot see the previous one's entries."""
    cache.lengths[slot] = 0
    if hasattr(cache, "positions"):
        cache.positions[slot] = -1
    return cache


@dataclasses.dataclass
class QuantKVCache:
    """8-bit per-slot KV cache with per-token absmax scales.

    ``k_q``/``v_q``: ``[n_layers, B, H_kv, max_len, head_dim]`` int8 or
    fp8; ``k_scale``/``v_scale``: fp32 ``[n_layers, B, H_kv, max_len]``;
    ``lengths``: int32 ``[B]``.  Tokens are quantized once, at append: the
    cache holds 8-bit KV, half the bytes a decode step reads from a bf16
    cache (``kernels/quant.py``).
    """

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    lengths: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k_q.shape[3]


def init_quant_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    max_len: int,
    head_dim: int,
    dtype: torch.dtype = torch.int8,
    device: Optional[torch.device] = None,
) -> QuantKVCache:
    if max_len % 128:
        raise ValueError(f"max_len={max_len} must be a multiple of 128")
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    return QuantKVCache(
        k_q=torch.zeros(shape, dtype=dtype, device=device),
        v_q=torch.zeros(shape, dtype=dtype, device=device),
        # Scale 1 for rows never written, as in JAX: stale zeros stay 0.
        k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """An 8-bit tensor viewed as uint8 (other tensors as they are): indexed
    writes of int8 and fp8 values then copy bytes, whatever the index
    kernels take."""
    return x.view(torch.uint8) if x.element_size() == 1 else x


def append_tokens_quant(
    cache: QuantKVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor
) -> QuantKVCache:
    """Quantize ``[B, H_kv, T, D]`` keys/values per token and write them,
    with their scales, at each slot's write head (start clamped as
    ``append_tokens``'s).  K and V are quantized in one call: serving is
    bound by the host's op count.  Does NOT bump ``lengths``."""
    slots, rows = _write_rows(cache, k_new.shape[0], k_new.shape[2])
    xq, scale = quantize_tokens(torch.stack((k_new, v_new)), cache.k_q.dtype)
    for i, (buf, sbuf) in enumerate(((cache.k_q, cache.k_scale), (cache.v_q, cache.v_scale))):
        as_bytes(buf[layer])[slots, :, rows] = as_bytes(xq[i].transpose(1, 2))
        sbuf[layer][slots, :, rows] = scale[i].transpose(1, 2)
    return cache


# ---------------------------------------------------------------------------
# Rolling (wrapped) KV caches for sliding-window models: O(window) memory
# ---------------------------------------------------------------------------


def rolling_slots(pos: torch.Tensor, capacity: int, sinks: int = 0) -> torch.Tensor:
    """The slot of global position ``pos`` in a rolling cache: the first
    ``sinks`` positions are pinned (attention sinks), the rest wrap around
    the other ``capacity - sinks`` slots."""
    if sinks:
        return torch.where(pos < sinks, pos, sinks + (pos - sinks) % (capacity - sinks))
    return pos % capacity


@dataclasses.dataclass
class RollingKVCache:
    """Fixed-capacity wrapped cache for sliding-window attention.

    ``k``/``v``: ``[n_layers, B, H_kv, capacity, head_dim]``; position ``p``
    lives in slot ``rolling_slots(p)``.  ``positions``: int32 ``[B,
    capacity]``, the position each slot holds (-1: never written);
    ``lengths``: int32 ``[B]``, the tokens each slot has seen; ``sinks``:
    the pinned positions.
    """

    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor
    lengths: torch.Tensor
    sinks: int = 0

    @property
    def capacity(self) -> int:
        return self.k.shape[3]


@dataclasses.dataclass
class RollingQuantKVCache:
    """8-bit rolling window cache: ``QuantKVCache``'s storage and scales
    with ``RollingKVCache``'s position map."""

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_scale: torch.Tensor  # fp32 [n_layers, B, H_kv, capacity]
    v_scale: torch.Tensor
    positions: torch.Tensor  # int32 [B, capacity]
    lengths: torch.Tensor
    sinks: int = 0

    @property
    def capacity(self) -> int:
        return self.k_q.shape[3]


def _rolling_fields(batch: int, capacity: int, device) -> dict:
    if capacity % 128:
        raise ValueError(f"capacity={capacity} must be a multiple of 128")
    return dict(
        positions=torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def init_rolling_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    capacity: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    sinks: int = 0,
    device: Optional[torch.device] = None,
) -> RollingKVCache:
    extra = _rolling_fields(batch, capacity, device)
    shape = (n_layers, batch, n_kv_heads, capacity, head_dim)
    return RollingKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        sinks=sinks, **extra,
    )


def init_rolling_quant_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    capacity: int,
    head_dim: int,
    dtype: torch.dtype = torch.int8,
    sinks: int = 0,
    device: Optional[torch.device] = None,
) -> RollingQuantKVCache:
    extra = _rolling_fields(batch, capacity, device)
    shape = (n_layers, batch, n_kv_heads, capacity, head_dim)
    return RollingQuantKVCache(
        k_q=torch.zeros(shape, dtype=dtype, device=device),
        v_q=torch.zeros(shape, dtype=dtype, device=device),
        k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        sinks=sinks, **extra,
    )


def rolling_write_slots(cache, t_new: int) -> tuple:
    """``(rows [B, 1], positions [B, T], slots [B, T])`` of the next
    ``t_new`` tokens of each slot of a rolling cache.  ``t_new`` must fit
    the wrap region (``capacity - sinks``): a larger chunk would wrap onto
    itself."""
    cap = cache.capacity
    if t_new > cap - cache.sinks:
        raise ValueError(
            f"append of {t_new} tokens exceeds rolling wrap region "
            f"{cap} - {cache.sinks} sinks (chunk the prefill)"
        )
    dev = cache.lengths.device
    pos = cache.lengths[:, None] + torch.arange(t_new, device=dev, dtype=torch.int32)
    rows = torch.arange(pos.shape[0], device=dev)[:, None]
    return rows, pos, rolling_slots(pos, cap, cache.sinks).long()


def append_tokens_rolling(
    cache: RollingKVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor
) -> RollingKVCache:
    """Write ``[B, H_kv, T, D]`` keys/values at each slot's wrapped write
    head.  A rolling prefill also needs ``capacity >= window + sinks +
    chunk`` (``runtime.decode.prefill_slot`` checks it).  Does NOT bump
    ``lengths`` or the positions (``bump_rolling_positions``)."""
    rows, _, slots = rolling_write_slots(cache, k_new.shape[2])
    cache.k[layer][rows, :, slots] = k_new.transpose(1, 2).to(cache.k.dtype)
    cache.v[layer][rows, :, slots] = v_new.transpose(1, 2).to(cache.v.dtype)
    return cache


def append_tokens_rolling_quant(
    cache: RollingQuantKVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor
) -> RollingQuantKVCache:
    """Quantize (``quantize_tokens``, as ``append_tokens_quant``) and write at
    the wrapped write head; the contract of ``append_tokens_rolling``."""
    rows, _, slots = rolling_write_slots(cache, k_new.shape[2])
    xq, scale = quantize_tokens(torch.stack((k_new, v_new)), cache.k_q.dtype)
    for i, (buf, sbuf) in enumerate(((cache.k_q, cache.k_scale), (cache.v_q, cache.v_scale))):
        as_bytes(buf[layer])[rows, :, slots] = as_bytes(xq[i].transpose(1, 2))
        sbuf[layer][rows, :, slots] = scale[i].transpose(1, 2)
    return cache


def bump_rolling_positions(cache, t_new: int, mask: torch.Tensor):
    """Record the positions of the ``t_new`` tokens just written and advance
    ``lengths``, for the slots where ``mask`` is True."""
    rows, pos, slots = rolling_write_slots(cache, t_new)
    cache.positions[rows, slots] = torch.where(mask[:, None], pos, cache.positions[rows, slots])
    return bump_lengths(cache, t_new, mask)
