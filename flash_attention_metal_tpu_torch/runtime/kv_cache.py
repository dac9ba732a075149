"""Dense per-slot KV cache for autoregressive decode.

Counterpart of the dense ``KVCache`` of
``flash_attention_metal_tpu/runtime/kv_cache.py``: ``[L, B, H_kv, max_len,
D]`` keys and values with per-slot valid lengths.  Ragged lengths reach the
kernel as its per-batch causal offset, never as dynamic shapes.

The JAX functions return a new cache, and the jitted steps donate the old
one so XLA updates it in place.  Here the updates are in place outright;
each function still returns the cache so call sites read the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


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
    b, _, t, _ = k_new.shape
    start = cache.lengths.clamp(0, cache.max_len - t)
    rows = start[:, None] + torch.arange(t, device=start.device)  # [B, T]
    slots = torch.arange(b, device=start.device)[:, None]
    # Advanced indices around a slice: the indexed view is [B, T, H, D].
    cache.k[layer][slots, :, rows] = k_new.transpose(1, 2).to(cache.k.dtype)
    cache.v[layer][slots, :, rows] = v_new.transpose(1, 2).to(cache.v.dtype)
    return cache


def bump_lengths(cache: KVCache, n: int, mask: torch.Tensor) -> KVCache:
    """Advance write heads by ``n`` for slots where ``mask`` is True."""
    cache.lengths += torch.where(mask, n, 0).to(torch.int32)
    return cache


def reset_slot(cache: KVCache, slot: int) -> KVCache:
    """Free a slot for reuse: ``lengths = 0`` masks its stale KV."""
    cache.lengths[slot] = 0
    return cache
