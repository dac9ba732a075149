"""Public attention API of the PyTorch port: differentiable flash attention.

Counterpart of ``flash_attention_metal_tpu/ops/attention.py``.  Inputs and
outputs keep the JAX package's ``[B, H, N, D]`` layout.  The JAX op is a
``custom_vjp`` over the forward and backward kernels; here that is a
``torch.autograd.Function`` whose forward runs the forward kernel with the
row logsumexp and whose backward runs the backward router.  Offsets reach
the kernels as int32 ``[B]`` tensors, so the routers take the general
forward kernel and, unless the autotuner's saved decision for the shape
names the fused kernel, the split backward pair, as in JAX.  The sliding
window with its sinks, packed segment ids and the softcap ride the same
Function into both routers; the ALiBi slopes are one of its tensor inputs,
whose gradient the split pair's ``d_slopes`` gives (a transformed call
takes the split pair whatever the saved decision, as JAX's dispatcher).
Attention dropout's seed is packed once per call (with its offsets, on the
device: a new seed every step costs no host sync) and saved for the
backward, which rebuilds the same keep mask; its gradient is None, and a
dropout call takes the split pair too.  A rolling cache's position map
(``kv_positions``) is forward only, as in JAX: such a call goes straight to
the forward router.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..config import SegmentIds, default_scale
from ..kernels.flash_bwd import flash_attention_bwd_auto
from ..kernels.flash_fwd import _offsets, check_dropout, flash_attention_fwd
from ..reference.oracle import attention_reference, attention_reference_with_lse


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``_flash_core``: the forward always saves the
    lse (as the JAX forward rule does), and with ``save_lse`` both outputs
    are differentiable (the lse cotangent folds into the backward's delta).
    """

    @staticmethod
    def forward(ctx, q, k, v, slopes, seed, off, off_max, sm_scale, causal, save_lse, feats):
        o, lse = flash_attention_fwd(
            q, k, v, off, sm_scale=sm_scale, causal=causal, save_lse=True, alibi_slopes=slopes,
            dropout_seed=seed, **feats
        )
        ctx.save_for_backward(q, k, v, off, o, lse, slopes, seed)
        ctx.off_max, ctx.sm_scale, ctx.causal, ctx.feats = off_max, sm_scale, causal, feats
        ctx.set_materialize_grads(False)
        if save_lse:
            return o, lse
        return o

    @staticmethod
    def backward(ctx, do, dlse=None):
        q, k, v, off, o, lse, slopes, seed = ctx.saved_tensors
        # Cotangents arrive strided (the heads merge is a transpose): the
        # kernels take contiguous rows, so copy once here.
        do = torch.zeros_like(o) if do is None else do.contiguous()
        grads = flash_attention_bwd_auto(
            q, k, v, o, do, lse, off,
            None if dlse is None else dlse.contiguous(),
            sm_scale=ctx.sm_scale, causal=ctx.causal, q_offset_max=ctx.off_max,
            alibi_slopes=slopes, dropout_seed=seed, **ctx.feats,
        )
        d_slopes = None
        if slopes is not None and ctx.needs_input_grad[3]:
            d_slopes = grads[3].to(slopes.dtype)
        # The gradients in the inputs' dtypes, as the JAX op gives them,
        # whichever kernel ran (a saved "tri" decision's dK/dV are fp32).
        return (grads[0].to(q.dtype), grads[1].to(k.dtype), grads[2].to(v.dtype), d_slopes, None,
                None, None, None, None, None, None)


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
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_offsets=None,
    dropout_heads: Optional[int] = None,
    kv_positions: Optional[torch.Tensor] = None,
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
      window: with ``causal``, row ``r`` (position ``p = r + q_offset[b]``)
        sees only its last ``window`` columns, ``c > p - window``
        (sliding-window attention); the KV tiles outside it are skipped.
      sinks: with ``window``, columns ``c < sinks`` stay visible beyond it
        (attention sinks).
      segment_ids: ``config.SegmentIds`` of packed sequences: tokens
        attend only within equal ids.  Composes with causal and window.
      softcap: the tanh logit cap (Gemma-2 style, > 0) on the scaled scores,
        ``s -> softcap * tanh(s / softcap)``; differentiable.
      alibi_slopes: ``[q_heads]`` fp32 ALiBi slopes: after the cap, each
        score gains ``slope_h * (c - p)``, ``p = r + q_offset[b]`` (also
        when not causal).  Differentiable: with ``requires_grad`` the
        backward gives their gradient (the JAX op's ``d_slopes``).
      dropout_rate: attention-probability dropout in [0, 1): the normalised
        probabilities times a keep mask ``{0, 1/(1-rate)}`` hashed from
        ``dropout_seed`` and each score's (batch, q-head, row, column)
        tensor indices (``kernels._common.keep_factors``), rebuilt bit for
        bit by the backward; the lse stays the undropped one's.  A
        training-path feature: the serving paths take none.
      dropout_seed: an int32 scalar (an int or a tensor, on the card or
        not; a new one each step costs no rebuild), or packed ``[5]``;
        required when ``dropout_rate > 0``.
      dropout_offsets: ``(row, col, batch, head)`` added to the local
        indices before hashing, so a shard of a larger call draws the
        global call's mask.
      dropout_heads: the global head count of the (batch, head) stream
        (default: ``q_heads``).
      kv_positions: a rolling (wrapped) KV cache's ``[B, N_kv]`` int32
        position map (-1: a slot never written): the causal mask, the
        window and ALiBi act on the positions the slots hold.  Forward only
        (the serving path), with ``causal``; it takes no dropout.

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
    if dropout_rate and kv_positions is not None:
        raise NotImplementedError(
            "dropout is a training-path feature; rolling-cache (kv_positions) serving does "
            "not support it"
        )
    feats = dict(window=window, sinks=sinks, segment_ids=segment_ids, softcap=softcap)
    if sm_scale is None:
        sm_scale = default_scale(q.shape[-1])
    if q_offset is None:
        q_offset = k.shape[2] - q.shape[2]
    if kv_positions is not None:
        # The rolling-cache serving path: forward only, straight to the router.
        if torch.is_grad_enabled() and any(
                torch.is_tensor(t) and t.requires_grad for t in (q, k, v, alibi_slopes)):
            raise NotImplementedError("kv_positions is forward only (the serving path)")
        return flash_attention_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), q_offset, sm_scale=sm_scale,
            causal=causal, save_lse=save_lse, alibi_slopes=alibi_slopes,
            kv_positions=kv_positions, **feats,
        )
    # The seed packed once with its offsets, on q's device: the forward and
    # the backward read it there.
    drop = check_dropout(dropout_rate, dropout_seed, dropout_offsets, dropout_heads, q.device)
    seed = None if drop is None else drop.seed
    if drop is not None:
        feats.update(dropout_rate=drop.rate, dropout_heads=drop.heads)
    if impl == "reference":
        if save_lse:
            if seed is not None:
                raise NotImplementedError("save_lse with dropout")
            return attention_reference_with_lse(q, k, v, causal=causal, sm_scale=sm_scale,
                                                q_offset=q_offset, alibi_slopes=alibi_slopes,
                                                **feats)
        return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                                   alibi_slopes=alibi_slopes, dropout_seed=seed, **feats)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # The offset is always an int32 [B] tensor here, as the JAX op makes it
    # an array (ops/attention.py:392-394): the forward router then takes the
    # general kernel, and the backward the split pair, on every call.  An
    # int offset still bounds the fused backward's dQ workspace.
    off = _offsets(q_offset, q.shape[0], 0, q.device)
    off_max = None if torch.is_tensor(q_offset) else int(q_offset)
    slopes = alibi_slopes
    if slopes is not None and not torch.is_tensor(slopes):
        slopes = torch.as_tensor(slopes, dtype=torch.float32, device=q.device)
    inputs = (q, k, v) if slopes is None else (q, k, v, slopes)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _FlashAttention.apply(q, k, v, slopes, seed, off, off_max, sm_scale, causal,
                                     save_lse, feats)
    return flash_attention_fwd(
        q, k, v, off, sm_scale=sm_scale, causal=causal, save_lse=save_lse, alibi_slopes=slopes,
        dropout_seed=seed, **feats
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
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    **features,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Head-folded GQA/MQA decode attention (forward only, serving path).

    ``q``: ``[B, H_q, T, D]`` new-token queries at positions
    ``q_offset[b] + t``; ``k, v``: ``[B, H_kv, N, D]`` cache.  Each KV
    head's ``group`` query heads fold into adjacent rows of one tile
    (kernel ``pos_div`` masking), so the cache streams once per KV head
    instead of once per q-head.  ``window``, ``sinks`` and ``softcap``: as
    ``flash_attention``'s, in each row's position.  ALiBi slopes are per
    q-head, so they take the unfolded path (``alibi_slopes`` raises
    NotImplementedError here, as in JAX), and so does dropout: a serving
    path (JAX's fold takes none).  Returns ``o`` shaped like ``q`` (and
    ``lse [B, H_q, T]``).
    """
    if features.get("dropout_rate"):
        raise NotImplementedError(
            "gqa_decode_attention is a serving path: it takes no dropout (use flash_attention)"
        )
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads ({hq}) not a multiple of kv heads ({hkv})")
    group = hq // hkv
    out = flash_attention_fwd(
        fold_gqa_rows(q, hkv).contiguous(), k, v, q_offset, causal=True,
        sm_scale=sm_scale, save_lse=save_lse, pos_div=group, window=window, sinks=sinks,
        softcap=softcap, **features,
    )
    if save_lse:
        return unfold_gqa_rows(out[0], hq, t), unfold_gqa_rows(out[1], hq, t)
    return unfold_gqa_rows(out, hq, t)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    **kwargs,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``flash_attention`` for ``[B, N, H, D]`` (sequence-major) layouts, as
    JAX ``ops/attention.py:497-513``: the inputs are transposed to ``[B, H,
    N, D]``, and ``o`` back (``lse`` stays ``[B, H, N]``).  ``kwargs``:
    ``flash_attention``'s."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kwargs)
    if isinstance(out, tuple):
        o, lse = out
        return o.transpose(1, 2), lse
    return out.transpose(1, 2)
