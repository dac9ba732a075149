"""Serving runtime: dense, 8-bit and paged KV caches, decode steps, the
page allocator, continuous batching engine."""

from .decode import decode_step, prefill_chunk, prefill_slot, sample_batch
from .engine import DecodeEngine, Request
from .kv_cache import (
    KVCache,
    QuantKVCache,
    append_tokens,
    append_tokens_quant,
    bump_lengths,
    init_cache,
    init_quant_cache,
    reset_slot,
)
from .paged_kv import (
    PageAllocator,
    PagedKVCache,
    PagedQuantKVCache,
    append_tokens_paged,
    append_tokens_paged_quant,
    gather_slot_kv,
    init_paged_cache,
    init_paged_quant_cache,
)

__all__ = [
    "DecodeEngine",
    "KVCache",
    "PageAllocator",
    "PagedKVCache",
    "PagedQuantKVCache",
    "QuantKVCache",
    "Request",
    "append_tokens",
    "append_tokens_paged",
    "append_tokens_paged_quant",
    "append_tokens_quant",
    "bump_lengths",
    "decode_step",
    "gather_slot_kv",
    "init_cache",
    "init_paged_cache",
    "init_paged_quant_cache",
    "init_quant_cache",
    "prefill_chunk",
    "prefill_slot",
    "reset_slot",
    "sample_batch",
]
