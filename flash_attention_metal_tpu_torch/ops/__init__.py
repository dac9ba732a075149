"""Public attention ops."""

from .attention import (
    flash_attention,
    fold_gqa_rows,
    gqa_decode_attention,
    mha,
    unfold_gqa_rows,
)

__all__ = [
    "flash_attention",
    "fold_gqa_rows",
    "gqa_decode_attention",
    "mha",
    "unfold_gqa_rows",
]
