"""Ulysses sequence parallelism: sequence shards to head shards and back.

Counterpart of ``flash_attention_metal_tpu/parallel/ulysses.py``.  Instead
of rotating K/V shards (the ring), two all-to-alls re-shard the activations
from sequence-split to head-split, each rank runs the single-device flash
op over the whole sequence for its head group, and one all-to-all brings
the output back to sequence shards.  Q, K, V and O cross the wire once
each; every kernel call is the single-device one, the causal diagonal
included.  Differentiable: the all-to-all's backward is the inverse
all-to-all (``comm.all_to_all_diff``) and the op carries the flash
backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import flash_attention
from .comm import all_to_all_diff
from .mesh import Mesh


def ulysses_attention(
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
    """Ulysses attention over this rank's ``[B, H, n_loc, D]`` sequence
    shards (split over ``axis``); returns the local output shard.

    The q-head count must split over the axis.  GQA K/V heads must too,
    or, with fewer K/V heads than ranks (``axis_size % kv_heads == 0``),
    each K/V head is repeated ``axis_size // kv_heads`` times first so every
    rank lands one K/V head (more bytes on K/V only); other ratios raise
    ``ValueError``, as in JAX."""
    h_q, h_kv = q.shape[1], k.shape[1]
    n = mesh.size(axis)
    if h_q % n:
        raise ValueError(f"Ulysses requires q heads ({h_q}) divisible by the sp axis size ({n}); "
                         "use ring attention otherwise")
    if h_kv % n:
        if n % h_kv:
            raise ValueError(f"Ulysses GQA requires kv heads ({h_kv}) divisible by the sp axis "
                             f"size ({n}) or vice versa; got neither - use ring attention for "
                             "this config")
        k = k.repeat_interleave(n // h_kv, dim=1)
        v = v.repeat_interleave(n // h_kv, dim=1)

    def seq_to_heads(x):  # [B, H, n_loc, D] -> [B, H / n, N, D]
        return all_to_all_diff(x.contiguous(), mesh, axis, 1, 2)

    o_h = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=causal,
                          sm_scale=sm_scale, impl=impl)
    return all_to_all_diff(o_h, mesh, axis, 2, 1)
