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


def visible_pairs(n_q: int, n_kv: int, q_offset: int, pos_div: int = 1) -> int:
    """(row, column) pairs a causal call computes: row ``r`` sees columns
    ``c <= r // pos_div + q_offset``, ``c < n_kv``.  ``4 * D`` flops each
    in the forward (per head)."""
    return sum(max(0, min(n_kv, r // pos_div + q_offset + 1)) for r in range(n_q))


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
) -> tuple:
    """``(flops, bytes)`` the fused backward must do: five products per
    visible (row, column) pair (S, dP, dV, dK and dQ: ``10 * D`` flops),
    and q, o, dO, k, v and the fp32 lse read once, dq, dk, dv written once
    (``itemsize`` bytes per element).  Its dQ workspace is the design's
    cost, not the function's, and is left out."""
    pairs = visible_pairs(n_q, n_kv, q_offset) if causal else n_q * n_kv
    q_elems = batch * heads * n_q * head_dim
    kv_elems = batch * kv_heads * n_kv * head_dim
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
