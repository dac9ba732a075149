"""Dense per-slot KV caches for autoregressive decode: bf16/fp32 and 8-bit.

Counterpart of the dense ``KVCache`` and the ``QuantKVCache`` of
``flash_attention_metal_tpu/runtime/kv_cache.py``: ``[L, B, H_kv, max_len,
D]`` keys and values (8-bit ones with per-token scales) and per-slot valid
lengths.  Ragged lengths reach the kernel as its per-batch causal offset,
never as dynamic shapes.

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
    """Free a slot of a dense or 8-bit cache for reuse: ``lengths = 0``
    masks its stale KV."""
    cache.lengths[slot] = 0
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
