"""Weight-only int8 quantization for serving.

Counterpart of ``flash_attention_metal_tpu/models/wquant.py``.  Decode-time
matrix products at small batch are bound by the bytes of the weights, so
storing them in int8 halves what a bf16 tree holds.  Scheme: symmetric per
output channel.  Each targeted 2-D weight ``W[din, dout]`` becomes ``{"qw":
int8, "scale": fp32 [1, dout]}`` with ``scale_j = max_i |W_ij| / 127``;
``models.transformer.weight`` rebuilds ``qw * scale`` in the compute dtype
at each use, and the product is ``torch.matmul`` (the JAX package leaves
the same product to XLA, outside any Pallas kernel).  The quantized tree is
a FlashLM parameter tree for ``forward`` and the whole one-device serving
stack; training keeps full-precision masters.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .transformer import param_leaves

Params = Dict[str, Any]

# Dense per-layer matrices; norms and the embedding stay as they are.
WEIGHT_QUANT_TARGETS: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: ``w ~= qw * scale``, in the JAX
    package's fp32 arithmetic (true division, round half to even)."""
    if w.ndim != 2:
        raise ValueError(f"expected a 2-D weight, got shape {tuple(w.shape)}")
    wf = w.float()
    scale = wf.abs().amax(dim=0, keepdim=True).clamp(min=1e-8) / 127.0
    qw = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"qw": qw, "scale": scale}


def quantize_weights(params: Params, targets: Tuple[str, ...] = WEIGHT_QUANT_TARGETS,
                     lm_head: bool = True) -> Params:
    """FlashLM params -> weight-only int8 serving tree: the 2-D layer
    weights named in ``targets`` and, with ``lm_head``, the largest decode
    product; everything else is the same tensor."""
    layers = []
    for layer in params["layers"]:
        new = dict(layer)
        for name in targets:
            w = layer.get(name)
            if torch.is_tensor(w) and w.ndim == 2:
                new[name] = quantize_weight(w)
        layers.append(new)
    out = dict(params)
    out["layers"] = layers
    if lm_head and torch.is_tensor(params["lm_head"]):
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def weight_bytes(params: Params) -> int:
    """Total bytes of every tensor of the tree (before/after accounting)."""
    return sum(t.numel() * t.element_size() for t in param_leaves(params))
