"""FlashEncoder: a bidirectional transformer on the port's attention op.

Counterpart of ``flash_attention_metal_tpu/models/encoder.py``.
Bidirectional attention is the op's non-causal path; padded batches ride
segment ids (pads segment 0, real tokens 1, so a real token neither sees
nor is seen by a pad), with no ``[B, N, N]`` mask anywhere.  Heads: a
masked-LM loss and mask-aware mean pooling.  Attention dropout takes
explicit per-layer seeds, as FlashLM's ``forward_hidden`` does, where the
JAX encoder draws them from a key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import SegmentIds
from ..ops.attention import flash_attention
from .transformer import _merge_heads, _split_heads, mlp_block, rms_norm, rope, weight

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 1408
    max_seq_len: int = 512
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"
    # Attention-probability dropout (applied when the caller passes seeds).
    attn_dropout: float = 0.0

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")


def _normal(generator: torch.Generator, shape, std: float) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return x * std


def init_params(cfg: EncoderConfig, generator: torch.Generator) -> Params:
    """fp32 master weights on ``generator``'s device (the forward casts to
    ``cfg.dtype`` at use)."""
    d, h, hk, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    dev = generator.device

    def dense(fan_in, shape):
        return _normal(generator, shape, fan_in**-0.5)

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=dev)

    layers = [
        {
            "attn_norm": ones(),
            "wq": dense(d, (d, h * hd)),
            "wk": dense(d, (d, hk * hd)),
            "wv": dense(d, (d, hk * hd)),
            "wo": dense(h * hd, (h * hd, d)),
            "mlp_norm": ones(),
            "w_gate": dense(d, (d, f)),
            "w_up": dense(d, (d, f)),
            "w_down": dense(f, (f, d)),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "embed": _normal(generator, (cfg.vocab_size, d), 0.02),
        "layers": layers,
        "final_norm": ones(),
        "mlm_head": dense(d, (d, cfg.vocab_size)),
    }


def _encoder_block(layer: Params, x: torch.Tensor, cfg: EncoderConfig, positions: torch.Tensor,
                   segment_ids: SegmentIds, dropout_seed=None) -> torch.Tensor:
    dt = cfg.dtype
    h = rms_norm(x, layer["attn_norm"])
    q = _split_heads(h @ weight(layer["wq"], dt), cfg.n_heads, cfg.head_dim)
    k = _split_heads(h @ weight(layer["wk"], dt), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(h @ weight(layer["wv"], dt), cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    drop = {}
    if cfg.attn_dropout > 0.0 and dropout_seed is not None:
        drop = dict(dropout_rate=cfg.attn_dropout, dropout_seed=dropout_seed)
    o = flash_attention(q, k, v, causal=False, segment_ids=segment_ids, impl=cfg.attn_impl,
                        **drop)
    x = x + _merge_heads(o) @ weight(layer["wo"], dt)
    return mlp_block(layer, x, cfg)  # the residual included


def encode(
    params: Params,
    tokens: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    *,
    cfg: EncoderConfig,
    dropout_seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hidden states ``[B, N, d_model]`` of a padded token batch.

    ``attn_mask``: bool/int ``[B, N]``, 1 for a real token (default: all),
    taken as the segment ids (pads 0).  ``dropout_seeds``: int32
    ``[n_layers]`` enabling ``cfg.attn_dropout``, layer ``i`` taking seed
    ``i`` (the JAX encoder draws them from ``dropout_key``; a test hands
    both the same seeds).
    """
    b, n = tokens.shape
    if attn_mask is None:
        attn_mask = torch.ones((b, n), dtype=torch.int32, device=tokens.device)
    seg = attn_mask.to(torch.int32).contiguous()
    sids = SegmentIds(q=seg, kv=seg)
    positions = torch.arange(n, device=tokens.device).expand(b, n)
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
    if dropout_seeds is not None and dropout_seeds.shape != (len(params["layers"]),):
        raise ValueError(f"dropout_seeds must be [{len(params['layers'])}] (one per layer), got "
                         f"{tuple(dropout_seeds.shape)}")
    for i, layer in enumerate(params["layers"]):
        seed = None if dropout_seeds is None else dropout_seeds[i]
        x = _encoder_block(layer, x, cfg, positions, sids, seed)
    return rms_norm(x, params["final_norm"])


def mean_pool(hidden: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
    """Mask-aware mean pooling: ``[B, d_model]`` embeddings."""
    m = attn_mask.to(hidden.dtype)[..., None]
    return torch.sum(hidden * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)


def mlm_loss(
    params: Params,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    loss_mask: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    *,
    cfg: EncoderConfig,
    dropout_seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked-LM cross entropy over the positions where ``loss_mask`` is 1:
    ``tokens`` the corrupted input, ``labels`` the originals."""
    hidden = encode(params, tokens, attn_mask, cfg=cfg, dropout_seeds=dropout_seeds)
    logits = (hidden @ weight(params["mlm_head"], cfg.dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    m = loss_mask.float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
