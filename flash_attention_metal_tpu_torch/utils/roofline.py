"""Peak rates of the card, for model FLOPs utilisation.

Counterpart of ``flash_attention_metal_tpu/utils/roofline.py::ChipSpec``
and ``detect_chip``, for NVIDIA cards.  Peaks are NVIDIA's data-sheet
figures for the H100 SXM (dense, no sparsity, at its full 700 W power
limit); ``nvidia-smi`` names that part "NVIDIA H100 80GB HBM3".
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    # Dense tensor-core peak in bf16, FLOP/s.
    peak_bf16_flops: float
    # fp32 peak outside the tensor cores, FLOP/s.
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
