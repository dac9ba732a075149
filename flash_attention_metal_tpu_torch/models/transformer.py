"""FlashLM: the GQA decoder-only transformer the port serves and trains.

Counterpart of ``flash_attention_metal_tpu/models/transformer.py``:
RMSNorm, SwiGLU, interleaved-pair RoPE (or ALiBi in its place) and GQA
attention through the port's flash-attention op, a per-block activation checkpoint (remat) for
training, attention dropout when the caller passes per-layer seeds, the
next-token loss and a plain SGD step.  Parameters are a plain
dict with the JAX package's keys and ``[in, out]`` layout, so the two are
compared leaf by leaf (``models/from_jax.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 1408  # ~8/3 * d_model rounded to 128
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # "auto": the flash-attention kernel; "reference": the fp32 oracle
    # (the JAX package's attn_impl="xla").
    attn_impl: str = "auto"
    # Sliding-window attention with attention sinks (the JAX config's):
    # every attention call of training and serving takes them.
    attn_window: Optional[int] = None
    attn_sinks: int = 0
    # The tanh logit cap (Gemma-2 style) and ALiBi position biases (the
    # JAX config's; ALiBi replaces RoPE): every attention call of training
    # and serving takes them.
    attn_softcap: Optional[float] = None
    attn_alibi: bool = False
    # Attention-probability dropout rate (training only: applied when the
    # caller passes per-layer seeds to forward / loss_fn; the Trainer draws
    # them every step).  In-kernel, no mask tensor.
    attn_dropout: float = 0.0

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.d_ff % 128 or self.d_model % 128:
            raise ValueError("d_model and d_ff must be multiples of 128")
        if self.attn_impl not in ("auto", "reference"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(f"attn_window must be >= 1, got {self.attn_window}")
        if self.attn_softcap is not None and not self.attn_softcap > 0:
            raise ValueError(f"attn_softcap must be > 0, got {self.attn_softcap}")
        if not 0.0 <= self.attn_dropout < 1.0:
            raise ValueError(f"attn_dropout must be in [0, 1), got {self.attn_dropout}")


Params = Dict[str, Any]


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    master_dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random FlashLM weights on ``generator``'s device.

    The JAX package keeps fp32 masters and casts them to ``cfg.dtype`` at
    every use.  Training does the same (``master_dtype=torch.float32``).
    Serving never updates the weights, so by default (``master_dtype``
    None) the matrices are stored already in ``cfg.dtype``: the values the
    matmuls see are identical.  The norm gains stay fp32, as the JAX RMSNorm
    multiplies by them in fp32.
    """
    dev = generator.device
    store = cfg.dtype if master_dtype is None else master_dtype
    d, h, hk, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (x * std).to(store)

    def dense(fan_in, shape):
        return normal(shape, fan_in**-0.5)

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
        "embed": normal((cfg.vocab_size, d), 0.02),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense(d, (d, cfg.vocab_size)),
    }


def weight(w, dt: torch.dtype) -> torch.Tensor:
    """A dense weight in compute dtype (no copy when it is stored so), or a
    weight-only int8 ``{"qw", "scale"}`` (``models/wquant.py``) dequantized
    to it, as JAX's ``qw.astype(dt) * scale.astype(dt)``."""
    if isinstance(w, dict):
        return w["qw"].to(dt) * w["scale"].to(dt)
    return w.to(dt)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over ``[B, H, N, D]`` with positions ``[B, N]``.

    Pairs are interleaved channels ``(2j, 2j+1)``, as in the JAX package,
    not the half-split pairing ``(j, j + D/2)`` of Hugging Face's Llama.
    """
    hd = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    )
    angles = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """The standard ALiBi slope schedule, fp32 ``[n_heads]``: ``2^(-8 i /
    n)`` for head ``i = 1 .. n`` (JAX ``transformer.py:141``)."""
    return torch.tensor([2.0 ** (-8.0 * (i + 1) / n_heads) for i in range(n_heads)],
                        dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _slopes_on(n_heads: int, device: torch.device) -> torch.Tensor:
    return alibi_slopes(n_heads, device)


def attn_transforms(cfg: "ModelConfig", device) -> dict:
    """The config's score transforms as ``flash_attention`` takes them (the
    slopes made once per device, not per call)."""
    slopes = _slopes_on(cfg.n_heads, torch.device(device)) if cfg.attn_alibi else None
    return dict(softcap=cfg.attn_softcap, alibi_slopes=slopes)


def _maybe_rope(x: torch.Tensor, positions: torch.Tensor, cfg: "ModelConfig") -> torch.Tensor:
    """RoPE, unless the config takes ALiBi for position (ALiBi models train
    without rotary, as in JAX)."""
    return x if cfg.attn_alibi else rope(x, positions, cfg.rope_theta)


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.reshape(b, n, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def qkv_projections(layer: Params, x: torch.Tensor, cfg: ModelConfig, positions):
    """Pre-norm Q/K/V projections with RoPE on Q and K (none under ALiBi):
    ``[B, H, N, D]``."""
    dt = cfg.dtype
    h = rms_norm(x, layer["attn_norm"])
    q = _split_heads(h @ weight(layer["wq"], dt), cfg.n_heads, cfg.head_dim)
    k = _split_heads(h @ weight(layer["wk"], dt), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(h @ weight(layer["wv"], dt), cfg.n_kv_heads, cfg.head_dim)
    return _maybe_rope(q, positions, cfg), _maybe_rope(k, positions, cfg), v


def attention_block(
    layer: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
    dropout_seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal self-attention over ``x`` with a residual connection (within
    ``cfg.attn_window`` and its sinks when set, under the config's softcap
    and ALiBi).  ``dropout_seed``: an int32 scalar enabling
    ``cfg.attn_dropout`` for this call (training passes one per layer per
    step; serving passes none)."""
    q, k, v = qkv_projections(layer, x, cfg, positions)
    drop = {}
    if cfg.attn_dropout > 0.0 and dropout_seed is not None:
        drop = dict(dropout_rate=cfg.attn_dropout, dropout_seed=dropout_seed)
    o = flash_attention(q, k, v, causal=True, impl=cfg.attn_impl, window=cfg.attn_window,
                        sinks=cfg.attn_sinks, **attn_transforms(cfg, x.device), **drop)
    return x + _merge_heads(o) @ weight(layer["wo"], cfg.dtype)


def mlp_block(layer: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "w_router" in layer:
        # An MoE layer (models/moe.py): the drop-free routed MLP, so forward,
        # prefill, decode and every cache mode serve MoE through this one
        # hook, as in JAX (transformer.py:216-222).  Late import: moe
        # imports this module.
        from .moe import moe_mlp_dense

        return moe_mlp_dense(layer, x, cfg)
    dt = cfg.dtype
    h = rms_norm(x, layer["mlp_norm"])
    gate = F.silu(h @ weight(layer["w_gate"], dt))
    up = h @ weight(layer["w_up"], dt)
    return x + (gate * up) @ weight(layer["w_down"], dt)


def forward_hidden(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    remat: bool = True,
    dropout_seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Transformer stack up to the final norm: ``[B, N, d]`` hidden.

    With ``remat`` and grad enabled each block runs under an activation
    checkpoint (the JAX ``jax.checkpoint``): its activations are recomputed
    in the backward, so the attention forward runs twice per layer, and
    draws the same dropout mask twice (the hash is stateless).

    ``dropout_seeds``: int32 ``[n_layers]`` (on the device, as the Trainer
    draws them), layer ``i``'s attention taking seed ``i`` at
    ``cfg.attn_dropout``; None (eval, serving) runs deterministically.  The
    JAX model draws its seeds from ``dropout_key`` with ``jax.random``,
    which the port cannot reproduce: a test hands both the same seeds.
    """
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(
            tokens.shape
        )
    # F.embedding, not indexing: its backward sums each row's gradient in a
    # fixed order, so a training step is deterministic.
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)

    def block(x, layer, seed):
        return mlp_block(layer, attention_block(layer, x, cfg, positions, seed), cfg)

    if dropout_seeds is not None and dropout_seeds.shape != (len(params["layers"]),):
        raise ValueError(f"dropout_seeds must be [{len(params['layers'])}] (one per layer), got "
                         f"{tuple(dropout_seeds.shape)}")
    for i, layer in enumerate(params["layers"]):
        seed = None if dropout_seeds is None else dropout_seeds[i]
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, layer, seed, use_reentrant=False)
        else:
            x = block(x, layer, seed)
    return rms_norm(x, params["final_norm"])


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    remat: bool = True,
    dropout_seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[B, N]`` tokens -> ``[B, N, V]`` fp32 logits (no cache);
    ``dropout_seeds`` as ``forward_hidden``'s."""
    x = forward_hidden(params, tokens, cfg, positions=positions, remat=remat,
                       dropout_seeds=dropout_seeds)
    return (x @ weight(params["lm_head"], cfg.dtype)).float()


def loss_fn(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            dropout_seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy over ``[B, N]`` tokens, on fp32 logits;
    ``dropout_seeds`` (the JAX loss's ``dropout_key``) as
    ``forward_hidden``'s."""
    logits = forward(params, tokens, cfg, dropout_seeds=dropout_seeds)[:, :-1]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def param_leaves(params: Params) -> list:
    """The parameter tensors in a fixed order (dict keys sorted, as JAX
    flattens a pytree)."""
    if isinstance(params, dict):
        return [leaf for key in sorted(params) for leaf in param_leaves(params[key])]
    if isinstance(params, (list, tuple)):
        return [leaf for item in params for leaf in param_leaves(item)]
    return [params]


def map_params(fn, params: Params, *rest: Params) -> Params:
    """``params`` with every tensor ``t`` replaced by ``fn(t, *others)``,
    visited in ``param_leaves`` order."""
    if isinstance(params, dict):
        return {
            k: map_params(fn, params[k], *(r[k] for r in rest)) for k in sorted(params)
        }
    if isinstance(params, (list, tuple)):
        return type(params)(map_params(fn, *items) for items in zip(params, *rest))
    return fn(params, *rest)


def value_and_grad(loss, params: Params, *args) -> Tuple[torch.Tensor, Params]:
    """``(loss(params, *args), d loss / d params)``; grads shaped like params,
    zeros for a leaf the loss does not use (as ``jax.grad`` gives; e.g. the
    encoder's ``mlm_head`` under a seq2seq loss)."""
    live = map_params(lambda p: p.detach().requires_grad_(True), params)
    value = loss(live, *args)
    grads = torch.autograd.grad(value, param_leaves(live), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return value.detach(), map_params(lambda _: next(it), live)


def sgd_train_step(
    params: Params, tokens: torch.Tensor, cfg: ModelConfig, lr: float = 1e-3
) -> Tuple[Params, torch.Tensor]:
    """One SGD step: ``(params - lr * grads, loss)`` (the trainer wraps
    AdamW around the same gradient)."""
    loss, grads = value_and_grad(loss_fn, params, tokens, cfg)
    with torch.no_grad():
        params = map_params(lambda p, g: p - lr * g, params, grads)
    return params, loss
