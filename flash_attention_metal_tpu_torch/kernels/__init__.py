"""Hand-written CUDA kernels, their wrappers, their plain versions and the
routers between them."""

from .flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_auto,
    flash_attention_bwd_plain,
)
from .flash_fwd import flash_attention_fwd, flash_attention_fwd_plain
from .flash_mxu import flash_attention_mxu
from .flash_tri import flash_attention_bwd_tri, flash_attention_tri
from .flash_v2 import flash_attention_v2
from .naive import naive_attention

__all__ = [
    "flash_attention_bwd",
    "flash_attention_bwd_auto",
    "flash_attention_bwd_plain",
    "flash_attention_bwd_tri",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "flash_attention_mxu",
    "flash_attention_tri",
    "flash_attention_v2",
    "naive_attention",
]
