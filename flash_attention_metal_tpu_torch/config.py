"""Configuration shared by the PyTorch port's kernels and ops.

Counterpart of ``flash_attention_metal_tpu/config.py``.  The TPU package's
block sizes must be multiples of the 128-lane vector width; a CUDA tile is
bounded instead by the 16x16 tensor-core fragment, so that is the rule here.
"""

from __future__ import annotations

import dataclasses

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


def default_scale(head_dim: int) -> float:
    return float(1.0 / (head_dim**0.5))
