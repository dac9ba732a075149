"""FlashLM and its parameter loader."""

from .from_jax import params_from_jax
from .transformer import ModelConfig, forward, forward_hidden, init_params

__all__ = [
    "ModelConfig",
    "forward",
    "forward_hidden",
    "init_params",
    "params_from_jax",
]
