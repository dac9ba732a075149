"""Checkpointing, the card's roofline and device timing."""

from .checkpoint import restore_pytree, save_pytree
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
    "attention_bytes",
    "attention_flops",
    "detect_chip",
    "kv_cache_bytes",
    "restore_pytree",
    "roofline_fraction",
    "roofline_time",
    "save_pytree",
]
