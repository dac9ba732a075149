"""Checkpointing, the training data path, the card's roofline and device
timing."""

from .checkpoint import restore_pytree, save_pytree
from .data import TokenDataset, batch_iterator, prefetch_to_device, write_token_shard
from .roofline import (
    CHIP_SPECS,
    ChipSpec,
    attention_bytes,
    attention_flops,
    detect_chip,
    kv_cache_bytes,
    roofline_fraction,
    roofline_time,
)

__all__ = [
    "CHIP_SPECS",
    "ChipSpec",
    "TokenDataset",
    "attention_bytes",
    "attention_flops",
    "batch_iterator",
    "detect_chip",
    "kv_cache_bytes",
    "prefetch_to_device",
    "restore_pytree",
    "roofline_fraction",
    "roofline_time",
    "save_pytree",
    "write_token_shard",
]
