"""Hand-written CUDA kernels, their wrappers, their plain versions and the
routers between them."""

from .flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_auto,
    flash_attention_bwd_fused,
    flash_attention_bwd_plain,
)
from .flash_fwd import flash_attention_fwd, flash_attention_fwd_plain
from .flash_mask import (
    BlockMask,
    block_sparse_attention,
    flash_attention_block_sparse,
    flash_attention_block_sparse_fwd,
)
from .flash_mxu import flash_attention_mxu
from .flash_tri import flash_attention_bwd_tri, flash_attention_tri
from .flash_v1 import flash_attention_v1
from .flash_v2 import flash_attention_v2
from .naive import naive_attention
from .paged import flash_attention_paged, flash_attention_paged_quant
from .quant import QuantizedKV, dequantize_kv, flash_attention_quant, quantize_kv

__all__ = [
    "BlockMask",
    "QuantizedKV",
    "block_sparse_attention",
    "dequantize_kv",
    "flash_attention_block_sparse",
    "flash_attention_block_sparse_fwd",
    "flash_attention_bwd",
    "flash_attention_bwd_auto",
    "flash_attention_bwd_fused",
    "flash_attention_bwd_plain",
    "flash_attention_bwd_tri",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "flash_attention_mxu",
    "flash_attention_paged",
    "flash_attention_paged_quant",
    "flash_attention_quant",
    "flash_attention_tri",
    "flash_attention_v1",
    "flash_attention_v2",
    "naive_attention",
    "quantize_kv",
]
