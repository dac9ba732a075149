"""Golden-reference attention (plain PyTorch, fp32).

Counterpart of ``flash_attention_metal_tpu/reference/oracle.py`` for the
subset the serving and training paths use: causal masking with a scalar or
per-batch ``q_offset``, and GQA, forward and closed-form backward.  The whole score matrix is materialised and the
softmax taken in two passes, so the code is obviously right; every kernel
of the port is held against it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..config import default_scale


def _scores(
    q: torch.Tensor,
    k: torch.Tensor,
    causal: bool,
    sm_scale: Optional[float],
    q_offset: Union[None, int, torch.Tensor],
) -> torch.Tensor:
    """fp32 scaled scores ``[B, H, N_q, N_kv]`` with masked entries -inf."""
    if sm_scale is None:
        sm_scale = default_scale(q.shape[-1])
    h_q, h_kv = q.shape[1], k.shape[1]
    if h_q % h_kv:
        raise ValueError(f"q heads ({h_q}) must be a multiple of kv heads ({h_kv})")
    kf = k.float().repeat_interleave(h_q // h_kv, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    if causal:
        n_q, n_kv = s.shape[-2], s.shape[-1]
        off = n_kv - n_q if q_offset is None else q_offset
        off = torch.as_tensor(off, dtype=torch.int64, device=q.device)
        row = torch.arange(n_q, device=q.device)[:, None] + off.reshape(-1, 1, 1, 1)
        col = torch.arange(n_kv, device=q.device)
        s = s.masked_fill(col > row, float("-inf"))
    return s


def attention_reference_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_offset: Union[None, int, torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` over ``[B, H, N, D]`` inputs, computed in fp32.

    ``q_offset`` (int or ``[B]``): with ``causal``, row ``r`` of batch ``b``
    sees columns ``c <= r + q_offset[b]``; default ``n_kv - n_q``.  ``k``
    and ``v`` may have fewer heads than ``q`` (GQA: q-head ``h`` reads
    kv-head ``h // group``).  Fully-masked rows give ``o = 0`` and
    ``lse = -inf``.  ``o`` comes back in ``q``'s dtype, ``lse`` in fp32.
    """
    s = _scores(q, k, causal, sm_scale, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    vf = v.float().repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    o = torch.matmul(p / l_safe, vf)
    lse = torch.where(l == 0.0, float("-inf"), m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_offset: Union[None, int, torch.Tensor] = None,
) -> torch.Tensor:
    """``O = softmax(Q K^T * scale) V`` in fp32; see ``attention_reference_with_lse``."""
    return attention_reference_with_lse(
        q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset
    )[0]


def attention_reference_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_offset: Union[None, int, torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form ``(dQ, dK, dV)`` of ``attention_reference``, in fp32.

    dV = P^T dO; dP = dO V^T; dS = P * (dP - rowsum(dP * P)) * scale;
    dQ = dS K; dK = dS^T Q, with P the oracle's softmax (no saved lse) and
    dK/dV summed over each KV head's group.  Gradients come back in the
    inputs' dtypes.
    """
    if sm_scale is None:
        sm_scale = default_scale(q.shape[-1])
    b, h_q, _, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    group = h_q // h_kv
    s = _scores(q, k, causal, sm_scale, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isneginf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    dof = do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * sm_scale
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
