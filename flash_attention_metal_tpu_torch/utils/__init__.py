"""Checkpointing and the card's roofline spec."""

from .checkpoint import restore_pytree, save_pytree
from .roofline import CHIP_SPECS, ChipSpec, detect_chip

__all__ = ["CHIP_SPECS", "ChipSpec", "detect_chip", "restore_pytree", "save_pytree"]
