"""LoRA: low-rank adapter fine-tuning for FlashLM.

Counterpart of ``flash_attention_metal_tpu/models/lora.py``: frozen base
weights plus trainable rank-``r`` factors, ``W + (alpha / r) A B``.
Adapters are a plain tree mirroring the targeted weights' names, so the
port's optimizer and checkpoint helpers apply unchanged.  The merged
weight is built in every loss call (a rank-``r`` product and an add), so
the forward stays FlashLM's own, and ``merge_lora``'s tree serves through
``DecodeEngine`` as it is.  Gradients are taken with respect to the
adapters only: the optimizer state is adapter-sized.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .trainer import AdamW, constant_adamw
from .transformer import ModelConfig, Params, loss_fn, param_leaves, value_and_grad


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Rank, scale and targets of the adapter set: ``targets`` names 2-D
    layer weights, by default the attention projections (any of ``("wq",
    "wk", "wv", "wo", "w_gate", "w_up", "w_down")``)."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


Adapters = Dict[str, Any]


def init_lora(params: Params, lcfg: LoRAConfig, generator: torch.Generator) -> Adapters:
    """fp32 adapters on ``generator``'s device: ``A ~ N(0, 1 / fan_in)``,
    ``B = 0``, so the merged model equals the base at step 0.  A target a
    layer lacks (an MLP target on an MoE layer) is skipped."""
    layers = []
    for layer in params["layers"]:
        ad = {}
        for name in lcfg.targets:
            if name not in layer:
                continue
            din, dout = layer[name].shape
            a = torch.randn((din, lcfg.rank), generator=generator, device=generator.device,
                            dtype=torch.float32) * din**-0.5
            ad[name] = {"a": a, "b": torch.zeros((lcfg.rank, dout), dtype=torch.float32,
                                                 device=generator.device)}
        layers.append(ad)
    return {"layers": layers}


def merge_lora(params: Params, adapters: Adapters, lcfg: LoRAConfig) -> Params:
    """The base tree with ``W + (alpha / r) A B`` folded in, each merged
    weight in its base weight's dtype; ``params`` is not changed.  The
    result is an ordinary FlashLM tree (training loss, serving, export)."""
    s = lcfg.scale
    layers = []
    for layer, ad in zip(params["layers"], adapters["layers"]):
        new = dict(layer)
        for name, fac in ad.items():
            w = layer[name]
            new[name] = (w + s * (fac["a"] @ fac["b"])).to(w.dtype)
        layers.append(new)
    out = dict(params)
    out["layers"] = layers
    return out


def lora_loss_fn(adapters: Adapters, params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 lcfg: LoRAConfig) -> torch.Tensor:
    """FlashLM's next-token loss as a function of the adapters."""
    return loss_fn(merge_lora(params, adapters, lcfg), tokens, cfg)


def make_lora_train_step(cfg: ModelConfig, lcfg: LoRAConfig,
                         optimizer: Optional[AdamW] = None):
    """The adapter-only optimizer step: ``(step, opt_init)`` with
    ``step(adapters, opt_state, params, tokens) -> (adapters, opt_state,
    loss)``; the adapters and the state are updated in place and the base
    ``params`` are never differentiated or written.  The default optimizer
    is AdamW at a constant 1e-3 with optax's defaults (b2 0.999, weight
    decay 1e-4, no clip), JAX's ``optax.adamw(1e-3)``."""
    opt = optimizer if optimizer is not None else constant_adamw(1e-3)

    def step(adapters: Adapters, opt_state, params: Params, tokens: torch.Tensor):
        loss, grads = value_and_grad(lora_loss_fn, adapters, params, tokens, cfg, lcfg)
        opt.update(grads, opt_state, adapters)
        return adapters, opt_state, loss

    return step, opt.init


def lora_num_params(adapters: Adapters) -> int:
    """The adapter set's trainable-parameter count."""
    return sum(t.numel() for t in param_leaves(adapters))

