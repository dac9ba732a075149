"""PyTorch + CUDA port of the flash-attention framework, for NVIDIA Hopper.

Counterpart of ``flash_attention_metal_tpu`` (the JAX package, which stays
the reference).  Module names mirror the JAX package.  The serving path
runs on one hand-written CUDA kernel, ``csrc/flash_fwd.cu``, built with
``nvcc`` at first use; tensors on the CPU take its plain PyTorch version.
"""

from .models.transformer import ModelConfig, init_params
from .ops.attention import flash_attention
from .runtime.engine import DecodeEngine, Request

__all__ = [
    "DecodeEngine",
    "ModelConfig",
    "Request",
    "flash_attention",
    "init_params",
]
