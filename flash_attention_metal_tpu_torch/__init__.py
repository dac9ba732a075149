"""PyTorch + CUDA port of the flash-attention framework, for NVIDIA Hopper.

Counterpart of ``flash_attention_metal_tpu`` (the JAX package, which stays
the reference).  Module names mirror the JAX package.  Every kernel is
hand-written CUDA C++ under ``csrc/``: the general forward over a dense,
8-bit, paged or paged 8-bit KV cache (``flash_fwd.cu``: serving, the op
and the training forward; decode on the split-KV grid of
``flash_decode.cuh``), the split backward pair
(``flash_bwd.cu``, training), and the kernel ladder the benchmark and the
verification ladder run: naive (``naive.cu``), the single-block forward
(``flash_lean.cu``) and the triangular causal forward and fused backward
(``flash_tri.cu``).  The kernels are built with ``nvcc`` at first use;
tensors on the CPU take their plain PyTorch versions.
"""

from .config import AttentionConfig, BlockSizes, SegmentIds
from .kernels.flash_bwd import flash_attention_bwd, flash_attention_bwd_auto
from .kernels.flash_mxu import flash_attention_mxu
from .kernels.flash_tri import flash_attention_bwd_tri, flash_attention_tri
from .kernels.flash_v2 import flash_attention_v2
from .kernels.naive import naive_attention
from .kernels.paged import flash_attention_paged, flash_attention_paged_quant
from .kernels.quant import flash_attention_quant, quantize_kv
from .models.trainer import Trainer, make_optimizer
from .models.transformer import ModelConfig, init_params, loss_fn
from .ops.attention import flash_attention, mha
from .runtime.engine import DecodeEngine, Request

__all__ = [
    "AttentionConfig",
    "BlockSizes",
    "DecodeEngine",
    "ModelConfig",
    "Request",
    "SegmentIds",
    "Trainer",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_auto",
    "flash_attention_bwd_tri",
    "flash_attention_mxu",
    "flash_attention_paged",
    "flash_attention_paged_quant",
    "flash_attention_quant",
    "flash_attention_tri",
    "flash_attention_v2",
    "init_params",
    "loss_fn",
    "make_optimizer",
    "mha",
    "naive_attention",
    "quantize_kv",
    "run_ladder",
]


def __getattr__(name):
    # Imported on first use, so that ``python -m
    # flash_attention_metal_tpu_torch.harness.verify`` does not find its
    # own module already imported by the package.
    if name == "run_ladder":
        from .harness.verify import run_ladder

        return run_ladder
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
