"""The fp32 rung: a thin wrapper over the forward router.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_v2.py`` (the
reference's V2 kernel's rung): fp32 in and out, no lse.  It has no kernel
of its own; ``flash_fwd.flash_attention_fwd`` routes it.  ``block_sizes``
are Mosaic tiles and are ignored.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_fwd import flash_attention_fwd


def flash_attention_v2(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    block_sizes=None,
) -> torch.Tensor:
    """fp32 flash attention over ``[B, H, N, D]`` inputs."""
    del block_sizes
    if q.dtype != torch.float32:
        raise ValueError(
            f"flash_attention_v2 is the fp32 rung (got {q.dtype}); use "
            "flash_attention_mxu for half-precision inputs"
        )
    return flash_attention_fwd(q, k, v, sm_scale=sm_scale, causal=causal)
