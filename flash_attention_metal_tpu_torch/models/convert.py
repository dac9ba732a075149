"""Hugging Face Llama checkpoint -> FlashLM parameters.

Counterpart of ``flash_attention_metal_tpu/models/convert.py``.  Any
Llama-family checkpoint (RMSNorm, SwiGLU, RoPE, GQA, no biases) maps onto
the FlashLM tree, so the port's kernels, caches, engine and trainer run
the converted model unchanged.

The one real transform is the RoPE basis: Hugging Face rotates half-split
channel pairs ``(j, j + D/2)`` where FlashLM rotates interleaved pairs
``(2j, 2j+1)``; both are the same rotary embedding under a per-head
channel permutation, which the converter bakes into the q and k
projections' output channels.

The model is anything with a ``.config`` (a ``LlamaConfig`` or an object
with its attributes) and a ``.state_dict()`` of Hugging Face names, so
neither this module nor the card needs ``transformers``: a state dict
built from a seed converts as a checkpoint does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .transformer import ModelConfig, Params


def _interleave_rope_channels(w: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """Permute a projection's output channels from Hugging Face's half-split
    RoPE layout to FlashLM's interleaved one: ``w`` ``[d_in, n_heads *
    head_dim]`` (input-major); channel ``j`` of a head moves to ``2j`` and
    ``j + head_dim / 2`` to ``2j + 1``."""
    d_in = w.shape[0]
    half = head_dim // 2
    w = w.reshape(d_in, n_heads, head_dim)
    out = torch.empty_like(w)
    out[..., 0::2] = w[..., :half]
    out[..., 1::2] = w[..., half:]
    return out.reshape(d_in, n_heads * head_dim)


def config_from_hf_llama(hf_config, **overrides) -> ModelConfig:
    """A ``ModelConfig`` from a ``LlamaConfig`` (bf16 unless overridden)."""
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads
    )
    kw: Dict[str, Any] = dict(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        head_dim=head_dim,
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        dtype=torch.bfloat16,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def params_from_hf_llama(model, cfg: ModelConfig, device="cuda",
                         master_dtype: torch.dtype = torch.float32) -> Params:
    """FlashLM params from a Hugging Face Llama model (or anything with its
    ``state_dict()`` names), on ``device`` (the card by default; CPU runs
    pass ``device="cpu"``).  Matrices and the embedding come out
    ``master_dtype``,
    fp32 by default (FlashLM's master weights; the forward casts to
    ``cfg.dtype`` at use); norm gains stay fp32.  Without ``lm_head.weight``
    (tied embeddings) the head is the embedding's transpose."""
    sd = model.state_dict()
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def f32(name):
        return sd[name].detach().to(device=device, dtype=torch.float32)

    def w(name):  # Hugging Face's Linear stores [out, in]; FlashLM [in, out]
        return f32(name).t()

    def out(t):
        return t.to(master_dtype).contiguous()

    layers = []
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        layers.append({
            "attn_norm": f32(pre + "input_layernorm.weight"),
            "wq": out(_interleave_rope_channels(w(pre + "self_attn.q_proj.weight"), h, hd)),
            "wk": out(_interleave_rope_channels(w(pre + "self_attn.k_proj.weight"), hk, hd)),
            "wv": out(w(pre + "self_attn.v_proj.weight")),
            "wo": out(w(pre + "self_attn.o_proj.weight")),
            "mlp_norm": f32(pre + "post_attention_layernorm.weight"),
            "w_gate": out(w(pre + "mlp.gate_proj.weight")),
            "w_up": out(w(pre + "mlp.up_proj.weight")),
            "w_down": out(w(pre + "mlp.down_proj.weight")),
        })
    embed = f32("model.embed_tokens.weight")
    head = w("lm_head.weight") if "lm_head.weight" in sd else embed.t()
    return {
        "embed": out(embed),
        "layers": layers,
        "final_norm": f32("model.norm.weight"),
        "lm_head": out(head),
    }


def convert_hf_llama(model, device="cuda", master_dtype: torch.dtype = torch.float32,
                     **cfg_overrides) -> Tuple[ModelConfig, Params]:
    """``(cfg, params)`` from a Hugging Face Llama model in one call;
    ``cfg_overrides`` go to ``config_from_hf_llama`` (``dtype`` the compute
    dtype, as in JAX)."""
    cfg = config_from_hf_llama(model.config, **cfg_overrides)
    return cfg, params_from_hf_llama(model, cfg, device=device, master_dtype=master_dtype)
