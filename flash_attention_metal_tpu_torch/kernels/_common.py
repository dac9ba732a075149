"""Shared kernel helpers: the attention-dropout hash.

Counterpart of ``flash_attention_metal_tpu/kernels/_common.py:22-110``.  The
mask at score position ``(bh, row, col)`` is a pure function of an int32
seed and the absolute coordinates, so the forward and both backward
kernels, whatever their tiles, and the oracle rebuild the same mask.

The JAX helpers compute in int32 with logical right shifts and wraparound
multiplies.  Torch's ``>>`` on a signed tensor is arithmetic, so the
helpers here compute in int64 holding uint32 values (masked to 32 bits
after every multiply and add): the same bits as the JAX uint32 pattern.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch

_U32 = 0xFFFFFFFF
# Mixing constants: golden-ratio increment and murmur3 / lowbias32
# multipliers (as uint32 values).
_MIX_A = 0x9E3779B9
_MIX_B = 0x85EBCA6B
_MIX_C = 0x7FEB352D
_MIX_D = 0x846CA68B
_MASK31 = 0x7FFFFFFF

IntLike = Union[int, torch.Tensor]


def _u32(x: IntLike) -> torch.Tensor:
    """``x`` (int or integer tensor, int32 bit patterns allowed) as int64
    holding its uint32 value."""
    return torch.as_tensor(x).to(torch.int64) & _U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 avalanche finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * _MIX_C) & _U32
    x = x ^ (x >> 15)
    x = (x * _MIX_D) & _U32
    return x ^ (x >> 16)


def pack_dropout_seed(seed: IntLike, offsets: Optional[Sequence[IntLike]] = None) -> torch.Tensor:
    """int32 ``[seed, row_off, col_off, batch_off, head_off]``: the seed and
    the offsets that turn a shard's local coordinates into global ones.  A
    packed length-5 tensor passes through; ``offsets`` defaults to zeros."""
    seed = torch.as_tensor(seed).to(torch.int32).reshape(-1)
    if seed.shape[0] == 5:
        if offsets is not None:
            raise ValueError("pre-packed dropout seed with extra offsets")
        return seed
    if seed.shape[0] != 1:
        raise ValueError(f"dropout_seed must be a scalar or packed [5], got {tuple(seed.shape)}")
    if offsets is None:
        offs = torch.zeros(4, dtype=torch.int32, device=seed.device)
    else:
        if len(offsets) != 4:
            raise ValueError(
                f"dropout_offsets must be (row, col, batch, head), got {len(offsets)} entries"
            )
        offs = torch.stack([torch.as_tensor(o).to(torch.int32).reshape(()) for o in offsets])
    return torch.cat([seed, offs.to(seed.device)])


def dropout_threshold(rate: float) -> int:
    """The 31-bit keep threshold of ``rate``: a score is kept when its
    hash's low 31 bits are at least this (JAX ``_common.py:97``)."""
    return min(int(round(rate * 2.0**31)), 2**31 - 1)


def dropout_inv_keep(rate: float) -> float:
    """The fp32 keep factor ``1 / (1 - rate)`` (as a Python float)."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()


def dropout_keep(seed: IntLike, bh: IntLike, rows: IntLike, cols: IntLike,
                 rate: float) -> torch.Tensor:
    """Counter-based attention-dropout keep mask: fp32 ``{0, 1/(1-rate)}``.

    Every argument broadcasts (the oracle passes ``[B, H, 1, 1]``,
    ``[1, 1, N, 1]`` and ``[1, 1, 1, N]`` tensors).  Keep probability is
    ``1 - rate`` on a 31-bit lattice, bit for bit the JAX mask."""
    threshold = dropout_threshold(rate)
    inv_keep = dropout_inv_keep(rate)
    h = _mix32(_u32(seed) ^ ((_u32(bh) * _MIX_A) & _U32))
    h = _mix32((h + _u32(rows) * _MIX_B) & _U32)
    h = _mix32((h + _u32(cols) * _MIX_A) & _U32)
    keep = (h & _MASK31) >= threshold
    return torch.where(keep, inv_keep, 0.0).to(torch.float32)


def keep_factors(shape, rate: float, seed: IntLike, heads: Optional[int] = None,
                 device=None) -> torch.Tensor:
    """The keep factors ``{0, 1/(1-rate)}`` of a ``[B, H, N_q, N_kv]`` call,
    fp32 on ``device``: score ``(b, h, r, c)`` hashed at ``bh = (b +
    batch_off) * heads + h + head_off``, row ``r + row_off`` and column ``c
    + col_off`` (``seed`` a scalar, or packed ``[seed, row_off, col_off,
    batch_off, head_off]``; ``heads`` the stream's head count, ``H`` when
    None), as every kernel hashes it.  Computed on ``device``."""
    sv = pack_dropout_seed(seed).to(device=device, dtype=torch.int64)
    b, h, n_q, n_kv = shape
    mul = h if heads is None else heads
    ar = functools.partial(torch.arange, device=device)
    bh = (ar(b)[:, None] + sv[3]) * mul + ar(h)[None, :] + sv[4]
    rows = sv[1] + ar(n_q).reshape(1, 1, n_q, 1)
    cols = sv[2] + ar(n_kv).reshape(1, 1, 1, n_kv)
    return dropout_keep(sv[0], bh.reshape(b, h, 1, 1), rows, cols, rate)
