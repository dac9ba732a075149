"""The half-precision production rung: a thin wrapper over the forward router.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_mxu.py``, which
names the ladder's V3/V4 rungs and the benchmark's flash side.  It has no
kernel of its own: ``flash_fwd.flash_attention_fwd`` routes bf16 and fp32
calls to the triangular, lean or general kernel and runs fp16 in fp32.
``window`` and ``block_sizes`` are the JAX signature's; a window raises
``NotImplementedError`` (ROADMAP.md, Queue A item 5), block sizes are
Mosaic tiles and are ignored.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .flash_fwd import flash_attention_fwd


def flash_attention_mxu(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    window: Optional[int] = None,
    block_sizes=None,
    save_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flash attention over ``[B, H, N, D]`` inputs: ``o`` or ``(o, lse)``
    with ``lse`` fp32 ``[B, H, N_q]``."""
    del block_sizes
    return flash_attention_fwd(
        q, k, v, sm_scale=sm_scale, causal=causal, save_lse=save_lse, window=window
    )
