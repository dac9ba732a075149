"""Context parallelism: the all-gather and lse-combine strategies.

Counterpart of ``flash_attention_metal_tpu/parallel/context.py``, two
alternatives to ring attention for a sequence-sharded K/V:

* ``allgather_attention``: gather the whole K/V on every rank and run the
  local flash op.  The most bytes on the wire, the simplest, and
  differentiable: the gather's backward is a reduce-scatter
  (``comm.gather_from``), and the op carries the flash backward.  The
  training path's context parallelism.
* ``lse_combine_attention``: each rank attends its (replicated) queries to
  its own K/V shard, and the partials merge over the axis by their
  logsumexps (``lse_psum_combine``: one all-gather, merged locally).  O(D)
  bytes per query on the wire instead of the cache; forward only, the
  decode topology.

Both take this rank's shards and a ``Mesh`` (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels._common import pack_dropout_seed
from ..kernels.flash_fwd import flash_attention_fwd
from ..ops.attention import flash_attention
from ..reference.oracle import attention_reference_with_lse
from .comm import all_gather, gather_from
from .mesh import Mesh


def allgather_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "sp",
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_heads: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable context-parallel attention by a K/V all-gather.

    ``q, k, v``: this rank's ``[B, H, n_loc, D]`` shards, the sequence
    split over ``axis``; returns the local output shard.  Local rows sit at
    global row ``rank * n_loc`` (the causal offset).  ``dropout_*``:
    attention dropout at global mask coordinates: the gathered columns are
    global already, and this shard's row origin is added to the seed's row
    offset (a seed may be packed with the caller's batch and head offsets,
    ``pack_dropout_seed``)."""
    n_loc = q.shape[2]
    my = mesh.index(axis)
    k_full = gather_from(k, mesh, axis, 2)
    v_full = gather_from(v, mesh, axis, 2)
    drop = {}
    if dropout_rate:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        sv = pack_dropout_seed(dropout_seed).to(device=q.device, dtype=torch.int32)
        row = torch.tensor([0, my * n_loc, 0, 0, 0], dtype=torch.int32, device=q.device)
        drop = dict(dropout_rate=dropout_rate, dropout_seed=sv + row,
                    dropout_heads=dropout_heads)
    return flash_attention(q, k_full, v_full, my * n_loc, causal=causal, sm_scale=sm_scale,
                           impl=impl, **drop)


def lse_psum_combine(o_l: torch.Tensor, lse_l: torch.Tensor, mesh: Mesh,
                     axis: str = "sp") -> torch.Tensor:
    """The ranks' attention partials over ``axis`` merged by their
    logsumexps: ``o_l`` ``[..., N, D]`` this rank's normalised partial,
    ``lse_l`` ``[..., N]`` (``-inf``: this shard saw no key; it weighs
    zero).  Returns the fp32 merged output ``sum_s o_s exp(lse_s - m) /
    sum_s exp(lse_s - m)``, ``m`` the largest lse (JAX's pmax / psum pair),
    in one all-gather of each rank's partial and lse, combined here in rank
    order: the same arithmetic on the same values on every rank, so the same
    result (one collective, where the pair takes two)."""
    both = torch.cat([o_l.float(), lse_l[..., None].float()], dim=-1)
    parts = all_gather(both[None], mesh, axis, 0)
    o_s, lse_s = parts[..., :-1], parts[..., -1:]
    m = lse_s.amax(dim=0)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w = torch.where(torch.isneginf(lse_s), torch.zeros_like(lse_s), torch.exp(lse_s - m_safe))
    w_sum = w.sum(dim=0)
    return (o_s * w).sum(dim=0) / torch.where(w_sum == 0.0, torch.ones_like(w_sum), w_sum)


def lse_combine_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "sp",
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Partial attention and the lse combine (forward only).

    Every rank holds the same queries (the new tokens: the last ``n_q``
    rows of the global sequence) and one K/V shard (shard ``s`` holds
    global columns ``[s * n_kv_loc, (s + 1) * n_kv_loc)``); the output is
    the combined attention, the same on every rank, in ``q``'s dtype.
    ``impl``: ``"auto"`` the forward router's kernels (the shard's offset
    is a host int), ``"reference"`` the fp32 oracle."""
    my, n = mesh.index(axis), mesh.size(axis)
    n_kv_loc, n_q = k.shape[2], q.shape[2]
    offset = (n * n_kv_loc - n_q) - my * n_kv_loc
    if impl == "reference":
        o_l, lse_l = attention_reference_with_lse(q, k, v, causal=causal, sm_scale=sm_scale,
                                                  q_offset=offset)
    elif impl == "auto":
        o_l, lse_l = flash_attention_fwd(q, k, v, offset, causal=causal, sm_scale=sm_scale,
                                         save_lse=True)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return lse_psum_combine(o_l, lse_l, mesh, axis).to(q.dtype)
