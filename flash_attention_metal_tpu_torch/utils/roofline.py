"""Peak rates of the card, attention's flop and byte counts, the roofline.

Counterpart of ``flash_attention_metal_tpu/utils/roofline.py``, for NVIDIA
cards.  Peaks are NVIDIA's data-sheet figures for the H100 SXM (dense, no
sparsity, at its full 700 W power limit); ``nvidia-smi`` names that part
"NVIDIA H100 80GB HBM3".

The JAX package divides its peak by ``mxu_width_factor`` (128 / D) when
reporting: a convention for the TPU's 128-wide matrix unit.  The H100's
tensor cores take a head dim of 64 at full depth, so the port does not
carry it; its bounds are the plain roofline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    # Dense tensor-core peak in bf16, FLOP/s.
    peak_bf16_flops: float
    # fp32 peak outside the tensor cores (IEEE FMA, not TF32), FLOP/s.
    peak_fp32_flops: float
    # HBM bandwidth, bytes/s.
    hbm_bw: float


CHIP_SPECS = {
    "h100-sxm": ChipSpec("H100 SXM", 989e12, 67e12, 3.35e12),
}


def detect_chip(device=None) -> ChipSpec:
    """The spec of the CUDA card ``device``; raises for any card without
    one (no default spec: a utilisation against the wrong peak is wrong)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: device peaks exist only for a card")
    name = torch.cuda.get_device_name(device)
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return CHIP_SPECS["h100-sxm"]
    raise ValueError(f"no peak figures for {name!r} (see utils/roofline.py)")


def attention_flops(
    batch: int,
    heads: int,
    n_q: int,
    n_kv: int,
    head_dim: int,
    *,
    causal: bool = False,
    backward: bool = False,
) -> float:
    """Model flop count of one attention call, as the JAX package counts it.

    Forward: QK^T and PV, 2 * N_q * N_kv * D multiply-adds each, so
    4 * N_q * N_kv * D flops per (batch, head); causal halves the score
    area; the backward's five block matmuls make it 2.5x the forward.
    """
    f = 4.0 * batch * heads * n_q * n_kv * head_dim
    if causal:
        f *= 0.5
    if backward:
        f *= 2.5
    return f


def _row_visible(p: int, n_kv: int, window: Optional[int], sinks: int) -> int:
    """Columns a row at position ``p`` sees: ``c <= p``, ``c < n_kv`` and,
    under a window, ``c > p - window`` or ``c < sinks``."""
    last = min(n_kv - 1, p)
    if last < 0:
        return 0
    if window is None:
        return last + 1
    lo = max(0, p - window + 1)
    return max(0, last - lo + 1) + max(0, min(sinks, lo, last + 1))


def visible_pairs(n_q: int, n_kv: int, q_offset: int, pos_div: int = 1,
                  window: Optional[int] = None, sinks: int = 0) -> int:
    """(row, column) pairs a causal call computes: row ``r`` at position
    ``p = r // pos_div + q_offset`` sees columns ``c <= p``, ``c < n_kv``,
    and under a sliding window only ``c > p - window``, besides the first
    ``sinks``.  ``4 * D`` flops each in the forward (per head)."""
    return sum(_row_visible(r // pos_div + q_offset, n_kv, window, sinks) for r in range(n_q))


def visible_kv_rows(n_q: int, n_kv: int, q_offset: int, pos_div: int = 1,
                    window: Optional[int] = None, sinks: int = 0) -> int:
    """KV rows any of the call's rows sees (per KV head): the least a
    causal call must read.  The rows' windows overlap, so their union is
    the sinks and the span from the first row's window to the last row's
    diagonal."""
    last = min(n_kv - 1, (n_q - 1) // pos_div + q_offset)
    if last < 0:
        return 0
    if window is None:
        return last + 1
    lo = max(0, q_offset - window + 1)
    return max(0, last - lo + 1) + max(0, min(sinks, lo, last + 1))


def block_sparse_work(batch: int, heads: int, kv_heads: int, n_q: int, n_kv: int,
                      head_dim: int, itemsize: int, visible: int, kernel: str) -> tuple:
    """``(flops, bytes)`` one block-sparse kernel must do, ``visible`` being
    the element-visible (row, column) pairs of one head's mask.

    Flops per visible pair and head dim, as the causal kernels count theirs:
    the forward 4 (QK^T, PV), dK/dV 8 (QK^T, dO V^T, P^T dO, dS^T Q), dQ 6
    (QK^T, dO V^T, dS K).  Bytes: each input read once, each output written
    once (``itemsize`` per element; lse and delta fp32 per row).
    """
    q_elems = batch * heads * n_q * head_dim
    kv_elems = batch * kv_heads * n_kv * head_dim
    rows = 4 * batch * heads * n_q
    per_pair, nbytes = {
        "fwd": (4, (2 * q_elems + 2 * kv_elems) * itemsize + rows),
        "dkv": (8, (2 * q_elems + 4 * kv_elems) * itemsize + 2 * rows),
        "dq": (6, (3 * q_elems + 2 * kv_elems) * itemsize + 2 * rows),
    }[kernel]
    return float(per_pair * head_dim * batch * heads * visible), float(nbytes)


def attention_bytes(
    batch: int,
    heads: int,
    n_q: int,
    n_kv: int,
    head_dim: int,
    itemsize: int,
) -> float:
    """Least HBM traffic of a forward: read Q, K, V once; write O once."""
    return float(batch * heads * (2 * n_q + 2 * n_kv) * head_dim * itemsize)


def kv_cache_bytes(rows: int, head_dim: int, itemsize: int, scaled: bool = False) -> float:
    """Least HBM traffic of reading ``rows`` K rows and as many V rows of a
    KV cache (``rows`` summed over slots and KV heads): ``itemsize`` bytes
    per element, plus one fp32 scale per row of an 8-bit cache."""
    return float(2 * rows * (head_dim * itemsize + (4 if scaled else 0)))


def fused_bwd_work(
    batch: int,
    heads: int,
    kv_heads: int,
    n_q: int,
    n_kv: int,
    head_dim: int,
    itemsize: int,
    *,
    causal: bool,
    q_offset: int = 0,
    window: Optional[int] = None,
    sinks: int = 0,
) -> tuple:
    """``(flops, bytes)`` the fused backward must do: five products per
    visible (row, column) pair (S, dP, dV, dK and dQ: ``10 * D`` flops;
    under a window its visible pairs only),
    and q, o, dO, k, v and the fp32 lse read once, dq, dk, dv written once
    (``itemsize`` bytes per element).  Its dQ workspace is the design's
    cost, not the function's, and is left out.  A call that sees no pair
    reads nothing: it only writes zero dq, dk and dv."""
    pairs = (visible_pairs(n_q, n_kv, q_offset, window=window, sinks=sinks) if causal
             else n_q * n_kv)
    q_elems = batch * heads * n_q * head_dim
    kv_elems = batch * kv_heads * n_kv * head_dim
    if not pairs:
        return 0.0, float((q_elems + 2 * kv_elems) * itemsize)
    nbytes = (4 * q_elems + 4 * kv_elems) * itemsize + 4 * batch * heads * n_q
    return 10.0 * head_dim * batch * heads * pairs, float(nbytes)


def roofline_time(
    flops: float,
    bytes_moved: float,
    spec: Optional[ChipSpec] = None,
    dtype_bits: int = 16,
) -> float:
    """Least seconds the card could take: the larger of flops over the peak
    for the operands' type (tensor cores for 16-bit, FMA for fp32) and
    bytes over the HBM rate."""
    if spec is None:
        spec = detect_chip()
    peak = spec.peak_bf16_flops if dtype_bits <= 16 else spec.peak_fp32_flops
    return max(flops / peak, bytes_moved / spec.hbm_bw)


def bound_by(
    flops: float,
    bytes_moved: float,
    spec: Optional[ChipSpec] = None,
    dtype_bits: int = 16,
) -> str:
    """Which term sets ``roofline_time``: ``"operations"`` or ``"bytes"``."""
    if spec is None:
        spec = detect_chip()
    peak = spec.peak_bf16_flops if dtype_bits <= 16 else spec.peak_fp32_flops
    return "operations" if flops / peak >= bytes_moved / spec.hbm_bw else "bytes"


def roofline_fraction(
    measured_s: float,
    flops: float,
    bytes_moved: float,
    spec: Optional[ChipSpec] = None,
    dtype_bits: int = 16,
) -> float:
    """Fraction of the roofline reached (1.0: at the bound)."""
    ideal = roofline_time(flops, bytes_moved, spec, dtype_bits)
    return ideal / measured_s if measured_s > 0 else 0.0
