"""Mixture-of-Experts FlashLM, on one device and with expert parallelism.

Counterpart of ``flash_attention_metal_tpu/models/moe.py``: the
GShard/Switch routed SwiGLU MLP with fp32 top-k gating (gates
renormalized over the kept k), capacity-bucketed one-hot dispatch and
combine tensors ``[T, E, C]`` built from cumsum ranks (tokens past an
expert's capacity drop from its MLP and ride the residual), the Switch
load-balance loss ``E * sum_e f_e p_e``, and the drop-free routed MLP that
serving uses (``moe_mlp_dense``, reached from ``transformer.mlp_block`` for
any layer that holds ``w_router``).

The routed products are plain einsums, which the JAX package leaves to XLA:
here they are ``torch`` matrix products, no grouped-GEMM library.  The
attention is FlashLM's, through the port's flash-attention op.

Expert parallelism runs on a ``("dp", "ep", "tp", "sp")`` mesh
(``parallel/mesh.py``): the experts split over ``ep`` and their hidden
width over ``tp`` (``moe_param_specs``); each rank dispatches its own
tokens into ``[E, C, d]`` blocks that one all-to-all each way carries to
and from the experts' ranks (``parallel/comm.py::all_to_all_diff``), and
the expert output is summed over tp.  ``ep`` is a data axis for the other
layers: the tokens split over dp x ep (and the sequence over sp), so each
shard's capacity comes from its own token count and tokens drop where
JAX's drop.  The attention is the sharded step's Megatron block
(``parallel_train._tp_attention``), the cross entropy its vocab-split one,
and the Switch loss reads raw counts summed over (dp, ep, sp).  A leaf's
gradient is summed over the data axes that hold partial contributions to
it: (dp, ep, sp) for the replicated and tp-split leaves, (dp, sp) for the
experts, whose ep group's tokens already reached them.  So the ep step
equals the one-device step; JAX's ``psum`` of gradients that autodiff has
already summed scales its update by the mesh size (ROADMAP.md, Queue C
17), which the port does not copy.  Without a mesh every function is the
one-device case of the same code.

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

from ..parallel.comm import all_reduce, all_to_all_diff, copy_to, reduce_from
from ..parallel.mesh import Mesh, shard
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

AXES = ("dp", "ep", "tp", "sp")
# The data axes: tokens split over them in every layer but the experts'.
DATA_AXES = ("dp", "ep", "sp")
# A [B, N] token batch's spec: the batch over dp x ep, the sequence over sp.
BATCH_SPEC = (("dp", "ep"), "sp")


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


def moe_param_specs(cfg: MoEConfig) -> Params:
    """Specs of the MoE tree: the Megatron tp attention, the router
    replicated, the experts split over ``ep`` and their hidden width over
    ``tp`` (``w_gate``/``w_up`` by column, ``w_down`` by row)."""
    col, row = (None, "tp"), ("tp", None)
    layer = {"attn_norm": (), "wq": col, "wk": col, "wv": col, "wo": row, "mlp_norm": (),
             "w_router": (), "w_gate": ("ep", None, "tp"), "w_up": ("ep", None, "tp"),
             "w_down": ("ep", "tp", None)}
    return {"embed": (), "layers": [dict(layer) for _ in range(cfg.n_layers)], "final_norm": (),
            "lm_head": col}


def moe_opt_state_specs(optimizer: AdamW, params: Params, cfg: MoEConfig) -> dict:
    """Specs of ``optimizer.init(shards)``: the moments with their experts."""
    return {"count": (), "mu": moe_param_specs(cfg), "nu": moe_param_specs(cfg)}


def shard_moe_params(params: Params, cfg: MoEConfig, mesh: Mesh) -> Params:
    """This rank's shards of a whole MoE tree, on ``mesh.device``."""
    return map_params(lambda p, s: shard(p, mesh, s), params, moe_param_specs(cfg))


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


def _moe_mlp(layer: Params, x: torch.Tensor, cfg: MoEConfig, mesh: Optional[Mesh] = None):
    """The capacity-bucketed routed MLP of training, with its residual, and
    the Switch statistics ``(f_sum, p_sum, t)`` of this shard's tokens (JAX
    ``:207``).  ``x``: this rank's ``[B_loc, n_loc, d]``; the capacity is
    this shard's.  With a ``mesh`` this rank holds ``E / ep`` experts: the
    dispatched ``[E, C, d]`` blocks go to their experts' ranks by an
    all-to-all over ``ep`` (``[E / ep, ep * C, d]`` there) and come back by
    the inverse one, and the tp-split expert output is summed over tp."""
    dt = cfg.dtype
    b, n, d = x.shape
    h = rms_norm(x, layer["mlp_norm"]).reshape(b * n, d)
    probs = _router_probs(layer, h)
    dispatch, combine, stats = topk_dispatch(probs, cfg.top_k, _capacity(b * n, cfg))
    xe = torch.einsum("tec,td->ecd", dispatch.to(dt), h)
    if mesh is not None:
        xe = copy_to(all_to_all_diff(xe, mesh, "ep", 0, 1), mesh, "tp")
    ye = _experts(layer, xe, dt)
    if mesh is not None:
        ye = all_to_all_diff(reduce_from(ye, mesh, "tp"), mesh, "ep", 1, 0)
    out = torch.einsum("ecd,tec->td", ye, combine.to(dt))
    return x + out.reshape(b, n, d), stats


def _moe_block(layer: Params, x: torch.Tensor, cfg: MoEConfig, positions: torch.Tensor):
    x = attention_block(layer, x, cfg, positions)
    return _moe_mlp(layer, x, cfg)


def _moe_loss(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
              mesh: Optional[Mesh] = None, sp_attn: str = "allgather") -> torch.Tensor:
    """Next-token cross entropy (the last position has no target) on fp32
    logits, plus ``aux_loss_weight`` times the Switch loss summed over the
    layers; each block under an activation checkpoint when grad is on, as
    JAX's.  With a ``mesh``: this rank's shards and token block
    (``BATCH_SPEC``), the global loss (``_moe_loss_sharded``)."""
    if mesh is not None:
        return _moe_loss_sharded(params, tokens, cfg, mesh, sp_attn)
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


def _moe_loss_sharded(params: Params, tokens: torch.Tensor, cfg: MoEConfig, mesh: Mesh,
                      sp_attn: str) -> torch.Tensor:
    """``_moe_loss`` on a ``(dp, ep, tp, sp)`` mesh (JAX ``:249``): the
    Switch loss of each layer from its statistics summed over the data axes
    (invariant to how the batch is split), the vocab-split cross entropy
    averaged over them; the same value on every rank, each rank's gradient
    its own part."""
    from .parallel_train import _tp_attention, check_config, vocab_sharded_ce

    check_config(cfg, mesh)
    n_loc = tokens.shape[1]
    positions = (mesh.index("sp") * n_loc
                 + torch.arange(n_loc, device=tokens.device)).expand(tokens.shape)
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)

    def block(x, layer):
        x = _tp_attention(layer, x, cfg, positions, mesh, sp_attn)
        return _moe_mlp(layer, x, cfg, mesh)

    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in params["layers"]:
        if torch.is_grad_enabled():
            x, (f_sum, p_sum, t) = checkpoint(block, x, layer, use_reentrant=False)
        else:
            x, (f_sum, p_sum, t) = block(x, layer)
        t_g = float(all_reduce(torch.tensor(t, device=tokens.device), mesh, DATA_AXES))
        f_e = all_reduce(f_sum.detach(), mesh, DATA_AXES) / t_g
        p_e = reduce_from(p_sum, mesh, *DATA_AXES) / t_g
        aux = aux + cfg.n_experts * torch.sum(f_e * p_e)
    x = copy_to(rms_norm(x, params["final_norm"]), mesh, "tp")
    logits = (x @ weight(params["lm_head"], cfg.dtype)).float()
    return vocab_sharded_ce(logits, tokens, mesh, reduce_axes=DATA_AXES) + \
        cfg.aux_loss_weight * aux


def _ep_sum_axes(spec) -> tuple:
    """The data axes a leaf's gradient holds partial sums along: the
    experts' (split over ep) dp and sp, every other leaf's dp, ep and sp."""
    return ("dp", "sp") if "ep" in spec else DATA_AXES


def moe_value_and_grad(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
                       mesh: Optional[Mesh] = None, sp_attn: str = "allgather"):
    """``(loss, grads)``: the loss and, with a ``mesh``, this rank's shards
    of the one-device gradient."""
    loss, grads = value_and_grad(_moe_loss, params, tokens, cfg, mesh, sp_attn)
    if mesh is not None:
        from .parallel_train import sum_partial_grads

        grads = sum_partial_grads(grads, moe_param_specs(cfg), mesh, _ep_sum_axes)
    return loss, grads


def _check_experts(cfg: MoEConfig, mesh: Optional[Mesh]) -> None:
    ep = mesh.size("ep") if mesh is not None else 1
    if cfg.n_experts % ep:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by ep={ep}")


def make_moe_train_step(mesh, cfg: Optional[MoEConfig] = None, lr: float = 1e-2,
                        sp_attn: str = "allgather"):
    """SGD step ``step(params, tokens) -> (params, loss)``, the params
    updated in place.  ``make_moe_train_step(mesh, cfg, ...)`` on a ``(dp,
    ep, tp, sp)`` mesh takes this rank's shards (``shard_moe_params``) and
    token block (``BATCH_SPEC``: ``B`` divisible by ``dp * ep``) and
    returns the global loss (JAX ``:288``); ``make_moe_train_step(cfg,
    ...)`` is the one-device step."""
    if isinstance(mesh, ModelConfig):
        mesh, cfg = None, mesh
    _check_experts(cfg, mesh)

    def step(params: Params, tokens: torch.Tensor):
        loss, grads = moe_value_and_grad(params, tokens, cfg, mesh, sp_attn)
        with torch.no_grad():
            map_params(lambda p, g: p.add_(g, alpha=-lr), params, grads)
        return params, loss

    return step


def make_moe_optax_step(mesh, cfg=None, optimizer: Optional[AdamW] = None,
                        sp_attn: str = "allgather"):
    """Optimizer step with the port's ``AdamW`` (or anything with its
    ``init`` / ``update`` interface): ``step(params, opt_state, tokens) ->
    (params, opt_state, loss)``, params and state updated in place.
    ``make_moe_optax_step(mesh, cfg, optimizer)`` on a mesh, the state
    sharded as ``moe_opt_state_specs`` and the clip on the global norm
    (JAX ``:337``); ``make_moe_optax_step(cfg, optimizer)`` on one
    device."""
    if isinstance(mesh, ModelConfig):
        mesh, cfg, optimizer = None, mesh, cfg
    _check_experts(cfg, mesh)

    def step(params: Params, opt_state, tokens: torch.Tensor):
        loss, grads = moe_value_and_grad(params, tokens, cfg, mesh, sp_attn)
        norm = None
        if mesh is not None:
            from .parallel_train import global_norm

            norm = global_norm(grads, moe_param_specs(cfg), mesh)
        optimizer.update(grads, opt_state, params, norm=norm)
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
