"""Serving runtime: dense KV cache, decode steps, continuous batching engine."""

from .decode import decode_step, prefill_slot, sample_batch
from .engine import DecodeEngine, Request
from .kv_cache import KVCache, append_tokens, bump_lengths, init_cache, reset_slot

__all__ = [
    "DecodeEngine",
    "KVCache",
    "Request",
    "append_tokens",
    "bump_lengths",
    "decode_step",
    "init_cache",
    "prefill_slot",
    "reset_slot",
    "sample_batch",
]
