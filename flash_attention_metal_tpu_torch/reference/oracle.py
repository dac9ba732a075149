"""Golden-reference attention (plain PyTorch, fp32).

Counterpart of ``flash_attention_metal_tpu/reference/oracle.py``: causal
masking with a scalar or per-batch ``q_offset``, GQA, the sliding window
with attention sinks, packed segment ids, the tanh softcap, ALiBi and the
deterministic attention dropout, forward and closed-form backward.  The
whole score matrix is materialised and the softmax taken in two passes, so
the code is obviously right; every kernel of the port is held against it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..config import SegmentIds, default_scale
from ..kernels._common import keep_factors

Offset = Union[None, int, torch.Tensor]


def _offset_rows(q_offset: Offset, n_q: int, n_kv: int, device) -> torch.Tensor:
    """Each row's position ``r + q_offset[b]`` as ``[B or 1, 1, N_q, 1]``
    (default offset ``n_kv - n_q``)."""
    off = n_kv - n_q if q_offset is None else q_offset
    off = torch.as_tensor(off, dtype=torch.int64, device=device).reshape(-1, 1, 1, 1)
    return torch.arange(n_q, device=device)[:, None] + off


def visible_mask(
    n_q: int,
    n_kv: int,
    device,
    *,
    causal: bool,
    q_offset: Offset = None,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
) -> Optional[torch.Tensor]:
    """Bool ``[B or 1, 1, N_q, N_kv]`` of the (row, column) pairs the
    contract lets a row see, or None when every pair is visible.

    With ``causal`` row ``r`` sits at position ``p = r + q_offset[b]`` and
    sees ``c <= p``; with ``window`` also only ``c > p - window``, unless
    ``c < sinks``.  ``segment_ids``: only equal ids.
    """
    visible = None
    if causal:
        row = _offset_rows(q_offset, n_q, n_kv, device)
        col = torch.arange(n_kv, device=device)
        visible = col <= row
        if window is not None:
            keep = col > row - window
            if sinks:
                keep = keep | (col < sinks)
            visible = visible & keep
    if segment_ids is not None:
        seg = segment_ids.q.to(device)[:, None, :, None] == segment_ids.kv.to(device)[:, None, None, :]
        visible = seg if visible is None else visible & seg
    return visible


def _scores(q, k, sm_scale, softcap, alibi_slopes, q_offset):
    """fp32 ``(raw, transformed)`` scores ``[B, H, N_q, N_kv]``: the scaled
    products, then the softcap and the ALiBi bias."""
    h_q, h_kv = q.shape[1], k.shape[1]
    if h_q % h_kv:
        raise ValueError(f"q heads ({h_q}) must be a multiple of kv heads ({h_kv})")
    kf = k.float().repeat_interleave(h_q // h_kv, dim=1)
    raw = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    s = raw if softcap is None else softcap * torch.tanh(raw / softcap)
    if alibi_slopes is not None:
        n_q, n_kv = s.shape[-2:]
        dist = torch.arange(n_kv, device=q.device) - _offset_rows(q_offset, n_q, n_kv, q.device)
        s = s + alibi_slopes.float().reshape(1, -1, 1, 1) * dist.float()
    return raw, s


def _keep(shape, rate, seed, n_heads, device) -> torch.Tensor:
    """The kernels' dropout keep factors ``{0, 1/(1-rate)}`` over
    ``[B, H, N_q, N_kv]`` (``kernels._common.keep_factors``); ``seed`` a
    scalar or the packed ``[seed, row, col, batch, head]`` offsets."""
    return keep_factors(shape, rate, seed, n_heads, device)


def _probs(q, k, *, causal, sm_scale, q_offset, window, sinks, segment_ids, softcap,
           alibi_slopes):
    """``(raw scores, P, m, l)``: the two-pass softmax over the visible
    pairs; fully-masked rows give P = 0 (m, l of the lse formula)."""
    if sm_scale is None:
        sm_scale = default_scale(q.shape[-1])
    raw, s = _scores(q, k, sm_scale, softcap, alibi_slopes, q_offset)
    visible = visible_mask(s.shape[-2], s.shape[-1], q.device, causal=causal, q_offset=q_offset,
                           window=window, sinks=sinks, segment_ids=segment_ids)
    if visible is not None:
        s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    return raw, p, m, l


def attention_reference_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_offset: Offset = None,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` over ``[B, H, N, D]`` inputs, computed in fp32.

    ``q_offset`` (int or ``[B]``): with ``causal``, row ``r`` of batch ``b``
    sits at position ``r + q_offset[b]`` (default ``n_kv - n_q``); see
    ``visible_mask`` for the window, sinks and segment ids.  ``softcap``:
    ``s -> softcap * tanh(s / softcap)`` on the scaled scores;
    ``alibi_slopes`` ``[H]``: plus ``slope * (c - p)`` after the cap.  ``k``
    and ``v`` may have fewer heads than ``q`` (GQA: q-head ``h`` reads
    kv-head ``h // group``).  Fully-masked rows give ``o = 0`` and
    ``lse = -inf``.  ``o`` comes back in ``q``'s dtype, ``lse`` in fp32.
    """
    _, p, m, l = _probs(q, k, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                        window=window, sinks=sinks, segment_ids=segment_ids, softcap=softcap,
                        alibi_slopes=alibi_slopes)
    vf = v.float().repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    o = torch.matmul(p, vf)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l == 0.0, float("-inf"), m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_offset: Offset = None,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Union[None, int, torch.Tensor] = None,
    dropout_heads: Optional[int] = None,
) -> torch.Tensor:
    """``O = softmax(Q K^T * scale) V`` in fp32; see
    ``attention_reference_with_lse``.  ``dropout_rate``: the normalised
    probabilities times the kernels' keep mask (``_common.dropout_keep``
    of ``dropout_seed``, a scalar or packed ``[5]``; ``dropout_heads`` the
    global head count of the (b, h) hash stream)."""
    _, p, _, _ = _probs(q, k, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                        window=window, sinks=sinks, segment_ids=segment_ids, softcap=softcap,
                        alibi_slopes=alibi_slopes)
    if dropout_rate:
        p = p * _keep(p.shape, dropout_rate, dropout_seed, dropout_heads, q.device)
    vf = v.float().repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    return torch.matmul(p, vf).to(q.dtype)


def attention_reference_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_offset: Offset = None,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Union[None, int, torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form ``(dQ, dK, dV)`` of ``attention_reference``, in fp32.

    With ``K`` the keep factors (1 without dropout): dV = (P o K)^T dO;
    dP = (dO V^T) o K; dS = P o (dP - rowsum(dP o P)); through the
    softcap, dS o (1 - tanh^2(s / softcap)) (ALiBi's bias is additive and
    passes dS on); dQ = dS K * scale; dK = dS^T Q * scale, dK/dV summed
    over each KV head's group.  Gradients come back in the inputs' dtypes.
    """
    if sm_scale is None:
        sm_scale = default_scale(q.shape[-1])
    b, h_q, _, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    group = h_q // h_kv
    raw, p, _, _ = _probs(q, k, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                          window=window, sinks=sinks, segment_ids=segment_ids, softcap=softcap,
                          alibi_slopes=alibi_slopes)
    keep = _keep(p.shape, dropout_rate, dropout_seed, None, q.device) if dropout_rate else None
    dof = do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    pd = p if keep is None else p * keep
    dv = torch.matmul(pd.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    if keep is not None:
        dp = dp * keep
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if softcap is not None:
        ds = ds * (1.0 - torch.tanh(raw / softcap) ** 2)
    ds = ds * sm_scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dk = dk.reshape(b, h_kv, group, n_kv, d).sum(dim=2)
    dv = dv.reshape(b, h_kv, group, n_kv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def make_qkv(
    generator: torch.Generator,
    shape: Tuple[int, ...],
    dtype: torch.dtype = torch.float32,
    minval: float = -1.0,
    maxval: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform(minval, maxval) ``q, k, v`` of ``shape`` on the generator's
    device: the verification ladder's fixture.  Drawn in fp32, then cast to
    ``dtype``.  ``torch.Generator`` and ``jax.random`` give different
    numbers from one seed: tests hand both packages numpy inputs instead."""

    def draw():
        x = torch.rand(shape, generator=generator, device=generator.device)
        return (x * (maxval - minval) + minval).to(dtype)

    return draw(), draw(), draw()
