"""Golden-reference attention in plain PyTorch (fp32)."""

from .oracle import (
    attention_reference,
    attention_reference_bwd,
    attention_reference_with_lse,
)

__all__ = [
    "attention_reference",
    "attention_reference_bwd",
    "attention_reference_with_lse",
]
