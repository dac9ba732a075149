"""Mixture-of-Experts FlashLM on one device.

Counterpart of the one-device parts of ``flash_attention_metal_tpu/models/
moe.py``: the GShard/Switch routed SwiGLU MLP with fp32 top-k gating (gates
renormalized over the kept k), capacity-bucketed one-hot dispatch and
combine tensors ``[T, E, C]`` built from cumsum ranks (tokens past an
expert's capacity drop from its MLP and ride the residual), the Switch
load-balance loss ``E * sum_e f_e p_e``, and the drop-free routed MLP that
serving uses (``moe_mlp_dense``, reached from ``transformer.mlp_block`` for
any layer that holds ``w_router``).

The routed products are plain einsums, which the JAX package leaves to XLA:
here they are ``torch`` matrix products, no grouped-GEMM library.  The
attention is FlashLM's, through the port's flash-attention op.  Expert
parallelism (the ``ep`` mesh axis, its all_to_all, ``moe_param_specs``)
waits for the rest of distribution (ROADMAP.md, Queue A item 7b): every
function here is the JAX package's at ``ep = tp = sp = 1``.

``torch.topk`` and ``jax.lax.top_k`` may order tied probabilities
differently, so two routers can differ on exact ties; the parity tests use
probabilities without ties.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .trainer import AdamW
from .transformer import (
    ModelConfig,
    Params,
    attention_block,
    map_params,
    rms_norm,
    value_and_grad,
    weight,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig(ModelConfig):
    n_experts: int = 8
    top_k: int = 2
    # capacity per expert = ceil(top_k * T / E * capacity_factor), rounded
    # up to a multiple of 8.
    capacity_factor: float = 1.25
    # Switch load-balance aux loss weight.
    aux_loss_weight: float = 1e-2


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    master_dtype: Optional[torch.dtype] = torch.float32) -> Params:
    """Random MoE FlashLM weights on ``generator``'s device: dense attention
    and an expert-stacked SwiGLU MLP (``w_gate``, ``w_up`` ``[E, d, f]``,
    ``w_down`` ``[E, f, d]``), the router ``w_router`` ``[d, E]`` fp32.

    The JAX package keeps fp32 masters (the default here, for training);
    serving passes ``master_dtype=None`` to store the matrices in
    ``cfg.dtype`` (the router and the norms stay fp32).
    """
    dev = generator.device
    store = cfg.dtype if master_dtype is None else master_dtype
    d, h, hk, hd, f, e = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                          cfg.n_experts)

    def dense(fan_in, shape, dtype=store):
        x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (x * fan_in**-0.5).to(dtype)

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
            "w_router": dense(d, (d, e), torch.float32),
            "w_gate": dense(d, (e, d, f)),
            "w_up": dense(d, (e, d, f)),
            "w_down": dense(f, (e, f, d)),
        }
        for _ in range(cfg.n_layers)
    ]
    embed = torch.randn((cfg.vocab_size, d), generator=generator, device=dev,
                        dtype=torch.float32) * 0.02
    return {
        "embed": embed.to(store),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense(d, (d, cfg.vocab_size)),
    }


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = -(-cfg.top_k * n_tokens * cfg.capacity_factor // cfg.n_experts)
    return int(-(-c // 8) * 8)


def _gates(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gates renormalized over the kept k, and their expert ids."""
    gate_vals, idx = torch.topk(probs, k, dim=-1)
    return gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(min=1e-9), idx


def topk_dispatch(probs: torch.Tensor, k: int, capacity: int):
    """Dense GShard dispatch from router probabilities ``[T, E]`` (fp32).

    Returns ``(dispatch, combine, (f_sum, p_sum, t))``: ``dispatch`` one-hot
    ``[T, E, C]``, ``combine`` gate-weighted; slots are given in priority
    order (every token's first choice before any second choice), each
    expert fills at most ``capacity`` of them, and an overflowing choice
    gets an all-zero row.  ``f_sum`` counts the first choices per expert,
    ``p_sum`` sums the probabilities: raw sums, as JAX returns them.
    """
    t, e = probs.shape
    gate_vals, idx = _gates(probs, k)
    dispatch = torch.zeros((t, e, capacity), dtype=probs.dtype, device=probs.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((e,), dtype=torch.int64, device=probs.device)
    for s in range(k):
        oh = F.one_hot(idx[:, s], e)  # [T, E] int64
        rank = counts[None, :] + torch.cumsum(oh, dim=0) - oh
        counts = counts + oh.sum(dim=0)
        keep = (rank < capacity) & (oh > 0)
        slot = F.one_hot(rank.clamp(0, capacity - 1), capacity).to(probs.dtype)
        slot = slot * keep[..., None].to(probs.dtype)
        dispatch = dispatch + slot
        combine = combine + slot * gate_vals[:, s, None, None]
    f_sum = F.one_hot(idx[:, 0], e).to(probs.dtype).sum(dim=0)
    p_sum = probs.sum(dim=0)
    return dispatch, combine, (f_sum, p_sum, float(t))


def _router_probs(layer: Params, h: torch.Tensor) -> torch.Tensor:
    """fp32 softmax of the router's logits over ``h`` ``[T, d]``."""
    return torch.softmax(h.float() @ layer["w_router"].float(), dim=-1)


def _experts(layer: Params, xe: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Every expert's SwiGLU over its rows: ``xe`` ``[E, R, d]`` -> ``[E, R,
    d]`` (``[T, d]`` runs every expert over all ``T`` rows)."""
    gate = F.silu(torch.matmul(xe, weight(layer["w_gate"], dt)))
    up = torch.matmul(xe, weight(layer["w_up"], dt))
    return torch.matmul(gate * up, weight(layer["w_down"], dt))


def moe_mlp_dense(layer: Params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Drop-free routed MoE MLP, the serving and teacher-forcing path, with
    its residual: exact top-k routing with no capacity buckets (every expert
    runs over every token; the combine weight zeroes the unrouted pairs), so
    decode matches the teacher-forced forward token for token.  Equal to
    ``_moe_mlp`` at a capacity that drops nothing."""
    dt = cfg.dtype
    shape = x.shape
    h = rms_norm(x, layer["mlp_norm"]).reshape(-1, shape[-1])
    gate_vals, idx = _gates(_router_probs(layer, h), cfg.top_k)
    w = torch.zeros((h.shape[0], cfg.n_experts), dtype=torch.float32, device=x.device)
    w.scatter_add_(1, idx, gate_vals)
    y = _experts(layer, h, dt)  # [E, T, d]
    out = torch.einsum("etd,te->td", y, w.to(dt))
    return x + out.reshape(shape)


def _moe_mlp(layer: Params, x: torch.Tensor, cfg: MoEConfig):
    """The capacity-bucketed routed MLP of training, with its residual, and
    the Switch statistics ``(f_sum, p_sum, t)`` (JAX's at ``ep = tp = 1``)."""
    dt = cfg.dtype
    b, n, d = x.shape
    h = rms_norm(x, layer["mlp_norm"]).reshape(b * n, d)
    probs = _router_probs(layer, h)
    dispatch, combine, stats = topk_dispatch(probs, cfg.top_k, _capacity(b * n, cfg))
    xe = torch.einsum("tec,td->ecd", dispatch.to(dt), h)
    ye = _experts(layer, xe, dt)
    out = torch.einsum("ecd,tec->td", ye, combine.to(dt))
    return x + out.reshape(b, n, d), stats


def _moe_block(layer: Params, x: torch.Tensor, cfg: MoEConfig, positions: torch.Tensor):
    x = attention_block(layer, x, cfg, positions)
    return _moe_mlp(layer, x, cfg)


def _moe_loss(params: Params, tokens: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Next-token cross entropy (the last position has no target) on fp32
    logits, plus ``aux_loss_weight`` times the Switch loss summed over the
    layers; each block under an activation checkpoint when grad is on, as
    JAX's."""
    positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in params["layers"]:
        if torch.is_grad_enabled():
            x, (f_sum, p_sum, t) = checkpoint(_moe_block, layer, x, cfg, positions,
                                              use_reentrant=False)
        else:
            x, (f_sum, p_sum, t) = _moe_block(layer, x, cfg, positions)
        aux = aux + cfg.n_experts * torch.sum((f_sum / t) * (p_sum / t))
    x = rms_norm(x, params["final_norm"])
    logits = (x @ weight(params["lm_head"], cfg.dtype)).float()[:, :-1]
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0].mean()
    return ce + cfg.aux_loss_weight * aux


def make_moe_train_step(cfg: MoEConfig, lr: float = 1e-2):
    """One-device SGD step: ``step(params, tokens) -> (params, loss)``, the
    params updated in place (JAX's ``make_moe_train_step`` on a one-device
    mesh)."""

    def step(params: Params, tokens: torch.Tensor):
        loss, grads = value_and_grad(_moe_loss, params, tokens, cfg)
        with torch.no_grad():
            map_params(lambda p, g: p.add_(g, alpha=-lr), params, grads)
        return params, loss

    return step


def make_moe_optax_step(cfg: MoEConfig, optimizer: AdamW):
    """One-device optimizer step with the port's ``AdamW`` (or anything with
    its ``init`` / ``update`` interface): ``step(params, opt_state, tokens)
    -> (params, opt_state, loss)``, params and state updated in place."""

    def step(params: Params, opt_state, tokens: torch.Tensor):
        loss, grads = value_and_grad(_moe_loss, params, tokens, cfg)
        optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


@torch.no_grad()
def moe_forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """``[B, N]`` tokens -> ``[B, N, V]`` fp32 logits through the
    capacity-bucketed MLP: the oracle the drop-free serving path equals at
    a capacity that drops nothing."""
    positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
    for layer in params["layers"]:
        x, _ = _moe_block(layer, x, cfg, positions)
    x = rms_norm(x, params["final_norm"])
    return (x @ weight(params["lm_head"], cfg.dtype)).float()
