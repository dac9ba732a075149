"""PyTorch + CUDA port of the flash-attention framework, for NVIDIA Hopper.

Counterpart of ``flash_attention_metal_tpu`` (the JAX package, which stays
the reference).  Module names mirror the JAX package.  Serving runs the
hand-written forward kernel ``csrc/flash_fwd.cu``; training adds the
backward kernels of ``csrc/flash_bwd.cu`` (dK/dV and dQ) behind a
``torch.autograd.Function``.  The kernels are built with ``nvcc`` at first
use; tensors on the CPU take their plain PyTorch versions.
"""

from .kernels.flash_bwd import flash_attention_bwd
from .models.trainer import Trainer, make_optimizer
from .models.transformer import ModelConfig, init_params, loss_fn
from .ops.attention import flash_attention
from .runtime.engine import DecodeEngine, Request

__all__ = [
    "DecodeEngine",
    "ModelConfig",
    "Request",
    "Trainer",
    "flash_attention",
    "flash_attention_bwd",
    "init_params",
    "loss_fn",
    "make_optimizer",
]
