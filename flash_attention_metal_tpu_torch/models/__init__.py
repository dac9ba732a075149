"""FlashLM, its loss and trainer, its parameter loader, and weight-only
int8 serving trees."""

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
from .wquant import WEIGHT_QUANT_TARGETS, quantize_weight, quantize_weights, weight_bytes

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
    "quantize_weight",
    "quantize_weights",
    "sgd_train_step",
    "synthetic_batches",
    "weight_bytes",
    "WEIGHT_QUANT_TARGETS",
]
