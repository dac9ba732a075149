"""Hand-written CUDA kernels, their wrappers and their plain versions."""

from .flash_bwd import flash_attention_bwd, flash_attention_bwd_plain
from .flash_fwd import flash_attention_fwd, flash_attention_fwd_plain

__all__ = [
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
]
