"""FlashSeq2Seq: an encoder-decoder with cross-attention on the port's op.

Counterpart of ``flash_attention_metal_tpu/models/seq2seq.py``, a
T5-shaped encoder-decoder in which every attention call is the port's
flash attention:

* encoder self-attention: the non-causal path with pads as segment 0
  (``models/encoder.py``'s stack);
* decoder self-attention: the causal path; incremental decode reads a
  target cache padded to a multiple of 128 at ``q_offset`` = the current
  length, an int32 tensor (the general kernel, as JAX's traced offset);
* cross-attention: the non-causal path with ``n_q != n_kv`` and the
  source's pads hidden by segment ids (all ones on the target side, the
  source mask on the memory side); each layer's memory K/V are computed
  once a source and reused every decode step.

RoPE on both self-attentions; cross-attention runs without rotation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import SegmentIds
from ..ops.attention import flash_attention
from .encoder import EncoderConfig, _normal, encode
from .encoder import init_params as init_encoder_params
from .transformer import _merge_heads, _split_heads, mlp_block, rms_norm, rope, weight

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int = 32768
    d_model: int = 512
    enc_layers: int = 4
    dec_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 1408
    max_src_len: int = 512
    max_tgt_len: int = 512
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"

    @property
    def encoder_cfg(self) -> EncoderConfig:
        return EncoderConfig(
            vocab_size=self.vocab_size, d_model=self.d_model, n_layers=self.enc_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            d_ff=self.d_ff, max_seq_len=self.max_src_len, rope_theta=self.rope_theta,
            dtype=self.dtype, attn_impl=self.attn_impl,
        )


def init_params(cfg: Seq2SeqConfig, generator: torch.Generator) -> Params:
    """fp32 master weights on ``generator``'s device: the encoder's tree
    under ``"encoder"``, then decoder layers with self- and cross-attention
    projections."""
    d, h, hk, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    dev = generator.device
    encoder = init_encoder_params(cfg.encoder_cfg, generator)

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
            "cross_norm": ones(),
            "cwq": dense(d, (d, h * hd)),
            "cwk": dense(d, (d, hk * hd)),
            "cwv": dense(d, (d, hk * hd)),
            "cwo": dense(h * hd, (h * hd, d)),
            "mlp_norm": ones(),
            "w_gate": dense(d, (d, f)),
            "w_up": dense(d, (d, f)),
            "w_down": dense(f, (f, d)),
        }
        for _ in range(cfg.dec_layers)
    ]
    return {
        "encoder": encoder,
        "embed": _normal(generator, (cfg.vocab_size, d), 0.02),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense(d, (d, cfg.vocab_size)),
    }


def encode_src(params: Params, src_tokens: torch.Tensor, src_mask: Optional[torch.Tensor],
               cfg: Seq2SeqConfig) -> torch.Tensor:
    """Encoder memory ``[B, S, d]`` (pads inert through segment ids)."""
    return encode(params["encoder"], src_tokens, src_mask, cfg=cfg.encoder_cfg)


def _cross_attention(layer: Params, x: torch.Tensor,
                     memory_kv: Tuple[torch.Tensor, torch.Tensor], src_mask: torch.Tensor,
                     cfg: Seq2SeqConfig) -> torch.Tensor:
    """q from the decoder stream over the memory's precomputed K/V, with
    its residual."""
    dt = cfg.dtype
    h = rms_norm(x, layer["cross_norm"])
    q = _split_heads(h @ weight(layer["cwq"], dt), cfg.n_heads, cfg.head_dim)
    ck, cv = memory_kv
    b, t = x.shape[0], x.shape[1]
    sids = SegmentIds(q=torch.ones((b, t), dtype=torch.int32, device=x.device),
                      kv=src_mask.to(torch.int32).contiguous())
    o = flash_attention(q, ck, cv, causal=False, segment_ids=sids, impl=cfg.attn_impl)
    return x + _merge_heads(o) @ weight(layer["cwo"], dt)


def _memory_kv(layer: Params, memory: torch.Tensor, cfg: Seq2SeqConfig):
    """A layer's cross K/V of the encoder memory, ``[B, H_kv, S, D]`` each
    (computed once a source, reused every decode step)."""
    dt = cfg.dtype
    ck = _split_heads(memory @ weight(layer["cwk"], dt), cfg.n_kv_heads, cfg.head_dim)
    cv = _split_heads(memory @ weight(layer["cwv"], dt), cfg.n_kv_heads, cfg.head_dim)
    return ck.contiguous(), cv.contiguous()


def _self_qkv(layer: Params, x: torch.Tensor, positions: torch.Tensor, cfg: Seq2SeqConfig):
    dt = cfg.dtype
    h = rms_norm(x, layer["attn_norm"])
    q = _split_heads(h @ weight(layer["wq"], dt), cfg.n_heads, cfg.head_dim)
    k = _split_heads(h @ weight(layer["wk"], dt), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(h @ weight(layer["wv"], dt), cfg.n_kv_heads, cfg.head_dim)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _logits(params: Params, x: torch.Tensor, cfg: Seq2SeqConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return (x @ weight(params["lm_head"], cfg.dtype)).float()


def decoder_forward(params: Params, memory: torch.Tensor, src_mask: torch.Tensor,
                    tgt_tokens: torch.Tensor, cfg: Seq2SeqConfig) -> torch.Tensor:
    """The teacher-forced decoder: ``[B, T]`` targets -> ``[B, T, V]`` fp32
    logits."""
    b, t = tgt_tokens.shape
    positions = torch.arange(t, device=tgt_tokens.device).expand(b, t)
    x = F.embedding(tgt_tokens.long(), params["embed"]).to(cfg.dtype)
    for layer in params["layers"]:
        q, k, v = _self_qkv(layer, x, positions, cfg)
        o = flash_attention(q, k, v, causal=True, impl=cfg.attn_impl)
        x = x + _merge_heads(o) @ weight(layer["wo"], cfg.dtype)
        x = _cross_attention(layer, x, _memory_kv(layer, memory, cfg), src_mask, cfg)
        x = mlp_block(layer, x, cfg)
    return _logits(params, x, cfg)


def forward(params: Params, src_tokens: torch.Tensor, tgt_tokens: torch.Tensor,
            cfg: Seq2SeqConfig, src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Source batch and shifted targets -> ``[B, T, V]`` fp32 logits."""
    if src_mask is None:
        src_mask = torch.ones(src_tokens.shape, dtype=torch.int32, device=src_tokens.device)
    memory = encode_src(params, src_tokens, src_mask, cfg)
    return decoder_forward(params, memory, src_mask, tgt_tokens, cfg)


def loss_fn(params: Params, src_tokens: torch.Tensor, tgt_tokens: torch.Tensor,
            cfg: Seq2SeqConfig, src_mask: Optional[torch.Tensor] = None,
            tgt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy on the target side (pad-masked with
    ``tgt_mask``)."""
    logits = forward(params, src_tokens, tgt_tokens, cfg, src_mask)[:, :-1]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tgt_tokens[:, 1:].long()[..., None])[..., 0]
    if tgt_mask is not None:
        m = tgt_mask[:, 1:].to(nll.dtype)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return nll.mean()


def _source(params: Params, cfg: Seq2SeqConfig, src_tokens: List[int], device):
    """One source padded to a multiple of 128 (at least 128): its mask
    ``[1, S]`` and each decoder layer's memory K/V."""
    s_pad = max(-(-len(src_tokens) // 128) * 128, 128)
    src = torch.zeros((1, s_pad), dtype=torch.int32, device=device)
    src[0, : len(src_tokens)] = torch.tensor(src_tokens, dtype=torch.int32, device=device)
    src_mask = (torch.arange(s_pad, device=device) < len(src_tokens)).to(torch.int32)[None]
    memory = encode_src(params, src, src_mask, cfg)
    return src_mask, [_memory_kv(layer, memory, cfg) for layer in params["layers"]]


@dataclasses.dataclass
class TargetCache:
    """The decoder's self-attention K/V ``[L, B, H_kv, T_cap, D]`` and each
    beam's length ``[B]`` (``runtime.beam.reorder_beam_state`` gathers its
    tensors by parent beam)."""
    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor


def _target_cache(cfg: Seq2SeqConfig, batch: int, max_new_tokens: int, device) -> TargetCache:
    t_cap = max(-(-(max_new_tokens + 1) // 128) * 128, 128)
    shape = (cfg.dec_layers, batch, cfg.n_kv_heads, t_cap, cfg.head_dim)
    k = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return TargetCache(k, torch.zeros_like(k),
                       torch.zeros((batch,), dtype=torch.int32, device=device))


def _decode_step(params: Params, cfg: Seq2SeqConfig, cache: TargetCache, tokens: torch.Tensor,
                 mem_kv, src_mask: torch.Tensor) -> torch.Tensor:
    """One token a row (``tokens`` ``[B]``) at each row's length: its K/V
    written into the target cache in place, the self-attention over the
    cache at ``q_offset`` = the lengths, the cross-attention over the
    memory.  Returns the ``[B, V]`` fp32 logits; the lengths stay."""
    b = tokens.shape[0]
    rows = torch.arange(b, device=tokens.device)
    lengths = cache.lengths
    x = F.embedding(tokens.long()[:, None], params["embed"]).to(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        q, k, v = _self_qkv(layer, x, lengths[:, None], cfg)
        cache.k[i][rows, :, lengths.long()] = k[:, :, 0]
        cache.v[i][rows, :, lengths.long()] = v[:, :, 0]
        o = flash_attention(q, cache.k[i], cache.v[i], lengths, causal=True, impl=cfg.attn_impl)
        x = x + _merge_heads(o) @ weight(layer["wo"], cfg.dtype)
        x = _cross_attention(layer, x, mem_kv[i], src_mask, cfg)
        x = mlp_block(layer, x, cfg)
    return _logits(params, x, cfg)[:, 0]


@torch.no_grad()
def greedy_generate(params: Params, cfg: Seq2SeqConfig, src_tokens: List[int], *,
                    bos_id: int = 1, eos_id: int = -1, max_new_tokens: int = 32) -> List[int]:
    """Incremental greedy decode of one source, on the device of ``params``.

    The encoder memory and each layer's cross K/V are computed once; each
    step runs one causal self-attention over the growing target cache
    (padded to a multiple of 128, ``q_offset`` = the current length) and
    one cross-attention over the memory."""
    device = params["embed"].device
    src_mask, mem_kv = _source(params, cfg, src_tokens, device)
    cache = _target_cache(cfg, 1, max_new_tokens, device)
    tok = torch.full((1,), bos_id, dtype=torch.int32, device=device)
    out: List[int] = []
    for n in range(max_new_tokens):
        cache.lengths.fill_(n)
        logits = _decode_step(params, cfg, cache, tok, mem_kv, src_mask)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        t = int(tok[0])
        if t == eos_id:
            break
        out.append(t)
    return out


@torch.no_grad()
def beam_generate(params: Params, cfg: Seq2SeqConfig, src_tokens: List[int], *,
                  beam_width: int = 4, bos_id: int = 1, eos_id: int = -1,
                  max_new_tokens: int = 32, length_penalty: float = 0.0,
                  return_all: bool = False):
    """Beam-search decode of one source (``runtime.beam.beam_search_loop``):
    beams ride the batch axis of the target cache, the memory K/V are
    broadcast once a source, and one batched step scores every beam a
    round."""
    from ..runtime.beam import beam_search_loop

    device = params["embed"].device
    src_mask1, mem_kv1 = _source(params, cfg, src_tokens, device)
    src_mask = src_mask1.expand(beam_width, -1).contiguous()
    mem_kv = [tuple(t.expand(beam_width, -1, -1, -1).contiguous() for t in kv)
              for kv in mem_kv1]
    cache = _target_cache(cfg, beam_width, max_new_tokens, device)

    def step_fn(cache: TargetCache, tokens: torch.Tensor, finished: torch.Tensor):
        logits = _decode_step(params, cfg, cache, tokens, mem_kv, src_mask)
        cache.lengths += (~finished).to(torch.int32)
        return logits, cache

    # The BOS step over every (identical) beam gives the first expansion.
    logits0, cache = step_fn(cache, torch.full((beam_width,), bos_id, dtype=torch.int32,
                                               device=device),
                             torch.zeros((beam_width,), dtype=torch.bool, device=device))
    return beam_search_loop(step_fn, cache, logits0[0], beam_width=beam_width,
                            max_new_tokens=max_new_tokens, eos_id=eos_id,
                            length_penalty=length_penalty, return_all=return_all)
