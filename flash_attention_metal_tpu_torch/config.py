"""Configuration shared by the PyTorch port's kernels and ops.

Counterpart of ``flash_attention_metal_tpu/config.py``.  The TPU package's
block sizes must be multiples of the 128-lane vector width; a CUDA tile is
bounded instead by the 16x16 tensor-core fragment, so that is the rule here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Mask additive constant, as in the JAX package: -0.7 * float32 max rather
# than -inf, so that ``exp(mask - mask)`` never produces NaN.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# Rows (and columns) of one tensor-core fragment: every tile dimension is a
# multiple of it.
MMA_TILE = 16


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile sizes of the forward kernel.

    * ``block_q`` -- query rows per thread block (16 per warp).
    * ``block_k`` -- key/value columns per step of the block's KV loop.
    """

    block_q: int = 64
    block_k: int = 64

    def __post_init__(self):
        for name in ("block_q", "block_k"):
            v = getattr(self, name)
            if v <= 0 or v % MMA_TILE:
                raise ValueError(
                    f"{name}={v} must be a positive multiple of {MMA_TILE}"
                )


@dataclasses.dataclass
class SegmentIds:
    """Packed-sequence segment ids for Q and KV: tokens attend only within
    equal ids.  ``q``: int32 ``[B, N_q]``; ``kv``: int32 ``[B, N_kv]``.
    Composes with causal and windowed masking.  Counterpart of the JAX
    ``config.SegmentIds`` (which is also a pytree; nothing here needs it)."""

    q: torch.Tensor
    kv: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Top-level attention op configuration, as the JAX package's."""

    causal: bool = False
    sm_scale: Optional[float] = None  # default: 1/sqrt(head_dim)
    block_sizes: Optional[BlockSizes] = None
    # Softmax statistics are fp32 whatever the input dtype.
    save_lse: bool = False


def default_scale(head_dim: int) -> float:
    return float(1.0 / (head_dim**0.5))
