"""Public attention API of the PyTorch port: differentiable flash attention.

Counterpart of ``flash_attention_metal_tpu/ops/attention.py``.  Inputs and
outputs keep the JAX package's ``[B, H, N, D]`` layout.  The JAX op is a
``custom_vjp`` over the forward and backward kernels; here that is a
``torch.autograd.Function`` whose forward runs the forward kernel with the
row logsumexp and whose backward runs the backward router.  Offsets reach
the kernels as int32 ``[B]`` tensors, so the routers take the general
forward kernel and, unless the autotuner's saved decision for the shape
names the fused kernel, the split backward pair, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..config import default_scale
from ..kernels.flash_bwd import flash_attention_bwd_auto
from ..kernels.flash_fwd import _offsets, flash_attention_fwd, reject_unported
from ..reference.oracle import attention_reference, attention_reference_with_lse


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``_flash_core``: the forward always saves the
    lse (as the JAX forward rule does), and with ``save_lse`` both outputs
    are differentiable (the lse cotangent folds into the backward's delta).
    """

    @staticmethod
    def forward(ctx, q, k, v, off, off_max, sm_scale, causal, save_lse):
        o, lse = flash_attention_fwd(
            q, k, v, off, sm_scale=sm_scale, causal=causal, save_lse=True
        )
        ctx.save_for_backward(q, k, v, off, o, lse)
        ctx.off_max, ctx.sm_scale, ctx.causal = off_max, sm_scale, causal
        ctx.set_materialize_grads(False)
        if save_lse:
            return o, lse
        return o

    @staticmethod
    def backward(ctx, do, dlse=None):
        q, k, v, off, o, lse = ctx.saved_tensors
        # Cotangents arrive strided (the heads merge is a transpose): the
        # kernels take contiguous rows, so copy once here.
        do = torch.zeros_like(o) if do is None else do.contiguous()
        dq, dk, dv = flash_attention_bwd_auto(
            q, k, v, o, do, lse, off,
            None if dlse is None else dlse.contiguous(),
            sm_scale=ctx.sm_scale, causal=ctx.causal, q_offset_max=ctx.off_max,
        )
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: Union[None, int, torch.Tensor] = None,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    save_lse: bool = False,
    impl: str = "auto",
    **features,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Differentiable flash attention over ``[B, H, N, D]`` inputs.

    Args:
      q: ``[batch, q_heads, n_q, head_dim]``.
      k, v: ``[batch, kv_heads, n_kv, head_dim]``; ``kv_heads`` divides
        ``q_heads`` (GQA/MQA).
      q_offset: int or ``[B]`` int tensor: with ``causal``, row ``r`` of
        batch ``b`` sees columns ``c <= r + q_offset[b]``.  Defaults to
        ``n_kv - n_q`` (end-aligned diagonals).
      save_lse: also return the per-row logsumexp ``[B, H, N_q]`` (fp32).
        Both outputs are differentiable.
      impl: ``"auto"`` runs the kernels (their plain versions for CPU
        tensors); ``"reference"`` runs the fp32 oracle, differentiated by
        torch autograd: the counterpart of the JAX package's ``impl="xla"``.
      features: the JAX op's window/sinks/segment_ids/kv_positions/softcap/
        alibi/dropout arguments; each raises NotImplementedError if set.

    Returns ``o`` with the shape and dtype of ``q``, or ``(o, lse)``.  When
    grad is enabled and an input requires it, the backward runs the
    backward router: the dK/dV and dQ kernels, or the fused kernel where the
    autotuner's saved decision names it.
    """
    if q.ndim != 4:
        raise ValueError(f"expected [B, H, N, D] inputs, got {tuple(q.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"q heads ({q.shape[1]}) must be a multiple of kv heads ({k.shape[1]})"
        )
    reject_unported(features)
    if sm_scale is None:
        sm_scale = default_scale(q.shape[-1])
    if q_offset is None:
        q_offset = k.shape[2] - q.shape[2]
    if impl == "reference":
        ref = attention_reference_with_lse if save_lse else attention_reference
        return ref(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # The offset is always an int32 [B] tensor here, as the JAX op makes it
    # an array (ops/attention.py:392-394): the forward router then takes the
    # general kernel, and the backward the split pair, on every call.  An
    # int offset still bounds the fused backward's dQ workspace.
    off = _offsets(q_offset, q.shape[0], 0, q.device)
    off_max = None if torch.is_tensor(q_offset) else int(q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, off, off_max, sm_scale, causal, save_lse)
    return flash_attention_fwd(
        q, k, v, off, sm_scale=sm_scale, causal=causal, save_lse=save_lse
    )


def fold_gqa_rows(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """``[B, Hq, T, D] -> [B, Hkv, T*group, D]`` with row ``t*group + g``.

    Row-major grouping matches the kernel's ``h // group`` GQA convention
    (q-head ``kv*group + g``) and its ``pos_div`` masking (position
    ``row // group``)."""
    b, hq, t, d = q.shape
    group = hq // kv_heads
    return (
        q.reshape(b, kv_heads, group, t, d)
        .transpose(2, 3)
        .reshape(b, kv_heads, t * group, d)
    )


def unfold_gqa_rows(x: torch.Tensor, q_heads: int, t: int) -> torch.Tensor:
    """Inverse of ``fold_gqa_rows`` on outputs (any trailing dims)."""
    b, hkv = x.shape[:2]
    group = q_heads // hkv
    tail = tuple(x.shape[3:])
    return (
        x.reshape(b, hkv, t, group, *tail)
        .transpose(2, 3)
        .reshape(b, q_heads, t, *tail)
    )


def gqa_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    save_lse: bool = False,
    **features,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Head-folded GQA/MQA decode attention (forward only, serving path).

    ``q``: ``[B, H_q, T, D]`` new-token queries at positions
    ``q_offset[b] + t``; ``k, v``: ``[B, H_kv, N, D]`` cache.  Each KV
    head's ``group`` query heads fold into adjacent rows of one tile
    (kernel ``pos_div`` masking), so the cache streams once per KV head
    instead of once per q-head.  Returns ``o`` shaped like ``q`` (and
    ``lse [B, H_q, T]``).
    """
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads ({hq}) not a multiple of kv heads ({hkv})")
    group = hq // hkv
    out = flash_attention_fwd(
        fold_gqa_rows(q, hkv).contiguous(), k, v, q_offset, causal=True,
        sm_scale=sm_scale, save_lse=save_lse, pos_div=group, **features,
    )
    if save_lse:
        return unfold_gqa_rows(out[0], hq, t), unfold_gqa_rows(out[1], hq, t)
    return unfold_gqa_rows(out, hq, t)
