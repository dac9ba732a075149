"""FlashLM, its loss and trainer, and its parameter loader."""

from .from_jax import params_from_jax
from .losses import blockwise_softmax_xent, loss_fn_blockwise, perplexity
from .trainer import AdamW, Trainer, make_optimizer, synthetic_batches
from .transformer import (
    ModelConfig,
    forward,
    forward_hidden,
    init_params,
    loss_fn,
    sgd_train_step,
)

__all__ = [
    "AdamW",
    "ModelConfig",
    "Trainer",
    "blockwise_softmax_xent",
    "forward",
    "forward_hidden",
    "init_params",
    "loss_fn",
    "loss_fn_blockwise",
    "make_optimizer",
    "params_from_jax",
    "perplexity",
    "sgd_train_step",
    "synthetic_batches",
]
