"""Sharded (dp x tp x sp) training step for FlashLM on ``torch.distributed``.

Counterpart of ``flash_attention_metal_tpu/models/parallel_train.py``.  The
JAX step is one ``shard_map`` over a 3-axis mesh; here every rank runs the
same program on its shards (``parallel/mesh.py``), with every collective
explicit:

* **dp** (data): the batch split; gradients summed over dp at the end.
* **tp** (tensor): heads and FFN width split in the Megatron layout:
  ``wq``/``wk``/``wv``/``w_gate``/``w_up`` and ``lm_head`` by columns,
  ``wo``/``w_down`` by rows.  A replicated activation enters each
  column-split product through ``comm.copy_to`` (identity forward, sum of
  the ranks' cotangents backward) and each row-split product leaves
  through ``comm.reduce_from`` (sum forward, identity backward).  GQA keeps
  each K/V head with its q-head group.
* **sp** (sequence): activations split on the sequence; attention runs the
  all-gather path (``parallel/context.py``) or the ring
  (``parallel/ring.py``); the next-token shift takes the right
  neighbour's first token point to point; the vocab-split cross entropy
  takes its logsumexp by a max and a sum over tp.

The loss is the global mean, and each rank's gradient is its part of the
global one: summed over dp x sp (``sharded_value_and_grad``), every leaf
equals the single-device gradient, tp-split leaves on their own shard and
replicated leaves alike.  JAX's step does not: its ``psum`` of gradients
that ``jax.grad`` of a ``psum``-reduced loss has already summed applies
updates scaled by the mesh size, and its clip reads the norm of local
shards (ROADMAP.md, Queue C).  The port does not copy either: its clip
counts each element once, tp-split leaves summed over tp and replicated
leaves once.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels._common import pack_dropout_seed
from ..parallel.comm import all_reduce, copy_to, reduce_from, shift
from ..parallel.context import allgather_attention
from ..parallel.mesh import Mesh, Sharding, shard, unshard
from ..parallel.ring import ring_flash_attention_diff
from .trainer import AdamW
from .transformer import (
    ModelConfig,
    Params,
    _merge_heads,
    _split_heads,
    map_params,
    param_leaves,
    rms_norm,
    rope,
    value_and_grad,
    weight,
)

SP_ATTN = ("allgather", "ring")


def param_specs(cfg: ModelConfig) -> Params:
    """Each parameter's spec (an axis name or None per dim; ``()``:
    replicated), in the Megatron tp layout of the JAX ``param_specs``."""
    col, row = (None, "tp"), ("tp", None)
    layer = {"attn_norm": (), "wq": col, "wk": col, "wv": col, "wo": row, "mlp_norm": (),
             "w_gate": col, "w_up": col, "w_down": row}
    return {"embed": (), "layers": [dict(layer) for _ in range(cfg.n_layers)], "final_norm": (),
            "lm_head": col}


def opt_state_specs(cfg: ModelConfig) -> dict:
    """Specs of the port's ``AdamW`` state: the moments as the parameters
    they follow, the step count replicated."""
    return {"count": (), "mu": param_specs(cfg), "nu": param_specs(cfg)}


def shard_params(params: Params, cfg: ModelConfig, mesh: Mesh) -> Params:
    """This rank's shards of a whole parameter tree (e.g. one from
    ``models/from_jax.py``), on ``mesh.device``."""
    return map_params(lambda p, s: shard(p, mesh, s), params, param_specs(cfg))


def unshard_params(params: Params, cfg: ModelConfig, mesh: Mesh) -> Params:
    """The whole tree from every rank's shards (collective)."""
    return map_params(lambda p, s: unshard(p, mesh, s), params, param_specs(cfg))


def batch_sharding(mesh: Mesh) -> Sharding:
    """A ``[B, N]`` token batch: the batch over dp, the sequence over sp."""
    return Sharding(mesh, ("dp", "sp"))


def check_config(cfg: ModelConfig, mesh: Mesh) -> None:
    """What the sharded step takes: tp dividing the q and K/V heads, and
    none of the attention features the JAX sharded step leaves out
    (window, softcap, ALiBi: its ring and all-gather calls take none)."""
    tp = mesh.size("tp")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"tp size {tp} must divide n_heads ({cfg.n_heads}) and n_kv_heads "
                         f"({cfg.n_kv_heads})")
    if cfg.attn_window is not None or cfg.attn_softcap is not None or cfg.attn_alibi:
        raise NotImplementedError("the sharded step takes no attention window, softcap or ALiBi, "
                                  "as JAX's")


def _tp_attention(layer, x, cfg: ModelConfig, positions, mesh: Mesh, sp_attn: str,
                  dropout_seed=None):
    dt, tp = cfg.dtype, mesh.size("tp")
    h_local, hk_local = cfg.n_heads // tp, cfg.n_kv_heads // tp
    h = copy_to(rms_norm(x, layer["attn_norm"]), mesh, "tp")
    q = rope(_split_heads(h @ weight(layer["wq"], dt), h_local, cfg.head_dim), positions,
             cfg.rope_theta)
    k = rope(_split_heads(h @ weight(layer["wk"], dt), hk_local, cfg.head_dim), positions,
             cfg.rope_theta)
    v = _split_heads(h @ weight(layer["wv"], dt), hk_local, cfg.head_dim)
    drop = {}
    if cfg.attn_dropout and dropout_seed is not None:
        # The mask at global (batch, head, row, column): the dp and tp
        # origins packed here, the sequence origins added by the ring or
        # the gather, so any mesh draws the single-device mask.
        seed = pack_dropout_seed(dropout_seed, (0, 0, mesh.index("dp") * x.shape[0],
                                                mesh.index("tp") * h_local))
        drop = dict(dropout_rate=cfg.attn_dropout, dropout_seed=seed, dropout_heads=cfg.n_heads)
    if sp_attn == "ring":
        o = ring_flash_attention_diff(q, k, v, mesh, "sp", causal=True, **drop)
    else:
        o = allgather_attention(q, k, v, mesh, "sp", causal=True, impl=cfg.attn_impl, **drop)
    return x + reduce_from(_merge_heads(o) @ weight(layer["wo"], dt), mesh, "tp")


def _tp_mlp(layer, x, cfg: ModelConfig, mesh: Mesh):
    dt = cfg.dtype
    h = copy_to(rms_norm(x, layer["mlp_norm"]), mesh, "tp")
    gate = F.silu(h @ weight(layer["w_gate"], dt))
    up = h @ weight(layer["w_up"], dt)
    return x + reduce_from((gate * up) @ weight(layer["w_down"], dt), mesh, "tp")


def vocab_sharded_ce(logits: torch.Tensor, tokens: torch.Tensor, mesh: Mesh,
                     reduce_axes: Tuple[str, ...] = ("dp", "sp"),
                     nll_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vocab-split (tp) and sequence-split (sp) next-token cross entropy.

    ``logits``: this rank's fp32 ``[B_loc, n_loc, V / tp]``; ``tokens`` its
    ``[B_loc, n_loc]``.  The targets are the tokens shifted left, the last
    one the right neighbour's first token (point to point over sp); the
    global last position has none.  The logsumexp takes a max and a sum over
    tp.  Returns the mean over the ranks of ``reduce_axes`` (the data
    replicas), the same on every rank; its gradient on each rank is that
    rank's part (``comm.reduce_from``).  ``nll_weight`` (a per-rank scalar,
    e.g. a pipeline stage's mask) multiplies the NLL and the token count."""
    sp, n_loc = mesh.size("sp"), tokens.shape[1]
    right_first = shift([tokens[:, :1].contiguous()], mesh, "sp", step=-1).wait()[0]
    targets = torch.cat([tokens[:, 1:], right_first], dim=1).long()
    pos = mesh.index("sp") * n_loc + torch.arange(n_loc, device=tokens.device)
    valid = (pos < sp * n_loc - 1).expand(tokens.shape)
    v_local = logits.shape[-1]
    # The pivot is gradient-free: the logsumexp does not depend on it.
    m = all_reduce(logits.detach().amax(dim=-1), mesh, ("tp",), "max")
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    lse = torch.log(reduce_from(sumexp, mesh, "tp")) + m
    local = targets - mesh.index("tp") * v_local
    in_shard = (local >= 0) & (local < v_local)
    picked = logits.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    target_logit = reduce_from(torch.where(in_shard, picked, torch.zeros_like(picked)), mesh,
                               "tp")
    nll = torch.where(valid, lse - target_logit, torch.zeros_like(lse))
    valid_f = valid.float()
    if nll_weight is not None:
        nll, valid_f = nll * nll_weight, valid_f * nll_weight
    total = reduce_from(nll.sum(), mesh, *reduce_axes)
    count = all_reduce(valid_f.sum(), mesh, reduce_axes)
    return total / count


def sharded_loss(params: Params, tokens: torch.Tensor, cfg: ModelConfig, mesh: Mesh,
                 sp_attn: str = "allgather", dropout_seeds: Optional[torch.Tensor] = None,
                 remat: bool = True) -> torch.Tensor:
    """The global next-token loss from this rank's parameter shards and
    token block (``batch_sharding``).  With ``remat`` each block runs under
    an activation checkpoint (JAX's ``jax.checkpoint``), which recomputes
    its collectives in the backward, the same on every rank.
    ``dropout_seeds``: int32 ``[n_layers]``, as ``transformer.forward_hidden``
    takes them (the same on every rank), enabling ``cfg.attn_dropout``; the
    masks hash at global coordinates, so the loss equals the single-device
    ``loss_fn`` with those seeds on any mesh."""
    if sp_attn not in SP_ATTN:
        raise ValueError(f"sp_attn must be one of {SP_ATTN}, got {sp_attn!r}")
    check_config(cfg, mesh)
    n_loc = tokens.shape[1]
    positions = (mesh.index("sp") * n_loc
                 + torch.arange(n_loc, device=tokens.device)).expand(tokens.shape)
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)

    def block(x, layer, seed):
        x = _tp_attention(layer, x, cfg, positions, mesh, sp_attn, seed)
        return _tp_mlp(layer, x, cfg, mesh)

    for i, layer in enumerate(params["layers"]):
        seed = None if dropout_seeds is None else dropout_seeds[i]
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, layer, seed, use_reentrant=False)
        else:
            x = block(x, layer, seed)
    x = copy_to(rms_norm(x, params["final_norm"]), mesh, "tp")
    logits = (x @ weight(params["lm_head"], cfg.dtype)).float()
    return vocab_sharded_ce(logits, tokens, mesh)


def _sum_over(tree: Params, mesh: Mesh, axes: Tuple[str, ...]) -> Params:
    """Every leaf of ``tree`` summed over ``axes``: one all-reduce of the
    leaves laid end to end."""
    if mesh.size(*axes) == 1:
        return tree
    leaves = param_leaves(tree)
    flat = all_reduce(torch.cat([g.reshape(-1).float() for g in leaves]), mesh, axes)
    parts = iter(flat.split([g.numel() for g in leaves]))
    return map_params(lambda g: next(parts).view(g.shape).to(g.dtype), tree)


def sum_partial_grads(grads: Params, specs: Params, mesh: Mesh,
                      axes_of: Callable[[tuple], Tuple[str, ...]]) -> Params:
    """Every leaf summed over ``axes_of(its spec)``, the axes along which its
    gradient holds partial sums (the pipeline's and the ep step's rule):
    one ``_sum_over`` for each set of axes."""
    leaves, leaf_specs = param_leaves(grads), []
    map_params(lambda _, s: leaf_specs.append(s), grads, specs)
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, s in enumerate(leaf_specs):
        groups.setdefault(tuple(axes_of(s)), []).append(i)
    out = list(leaves)
    for axes, idx in groups.items():
        for i, g in zip(idx, _sum_over([leaves[i] for i in idx], mesh, axes)):
            out[i] = g
    it = iter(out)
    return map_params(lambda _: next(it), grads)


def sharded_value_and_grad(params: Params, tokens: torch.Tensor, cfg: ModelConfig, mesh: Mesh,
                           sp_attn: str = "allgather",
                           dropout_seeds: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Params]:
    """``(loss, grads)``: the global loss and this rank's shards of the
    single-device gradient (each rank's part summed over dp x sp)."""
    loss, grads = value_and_grad(
        lambda p: sharded_loss(p, tokens, cfg, mesh, sp_attn, dropout_seeds), params)
    return loss, _sum_over(grads, mesh, ("dp", "sp"))


def global_norm(grads: Params, specs: Params, mesh: Mesh) -> torch.Tensor:
    """The global L2 norm of a gradient held as shards (``specs``): each
    leaf's squares summed over the mesh axes its spec splits it on, a
    replicated leaf counted once (one all-reduce for each set of axes)."""
    sums: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    map_params(lambda g, s: sums.setdefault(tuple(a for a in mesh.axis_names if a in s), [])
               .append(torch.sum(g.float() * g.float())), grads, specs)
    total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for axes, parts in sums.items():
        total = total + all_reduce(torch.stack(parts).sum(), mesh, axes)
    return torch.sqrt(total)


def global_grad_norm(grads: Params, cfg: ModelConfig, mesh: Mesh) -> torch.Tensor:
    """The single-device gradient's global L2 norm from this rank's shards:
    tp-split leaves summed over tp, replicated leaves once."""
    return global_norm(grads, param_specs(cfg), mesh)


def make_train_step(mesh: Mesh, cfg: ModelConfig, lr: float = 1e-2, sp_attn: str = "allgather",
                    dropout: bool = False):
    """``step(params, tokens[, dropout_seeds]) -> (params, loss)``: one SGD
    step on this rank's parameter shards (``shard_params``) and token block
    (``batch_sharding``; B divisible by dp, N by sp), returning new shards
    and the global loss.  With ``dropout`` (``cfg.attn_dropout > 0``) the
    step takes the per-layer seeds, the same on every rank."""

    def step(params: Params, tokens: torch.Tensor, dropout_seeds=None):
        if dropout and dropout_seeds is None:
            raise ValueError("a dropout step takes dropout_seeds")
        loss, grads = sharded_value_and_grad(params, tokens, cfg, mesh, sp_attn,
                                             dropout_seeds if dropout else None)
        with torch.no_grad():
            params = map_params(lambda p, g: p - lr * g, params, grads)
        return params, loss

    return step


def make_adamw_train_step(mesh: Mesh, cfg: ModelConfig, optimizer: AdamW,
                          sp_attn: str = "allgather"):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``: the
    counterpart of JAX's ``make_optax_train_step`` with the port's
    ``AdamW`` (``trainer.make_optimizer`` or ``constant_adamw``).  The state
    is sharded as the parameters it follows (``opt_state_specs``; build it
    with ``optimizer.init`` on the shards); the update runs in place, its
    clip on the global norm (``global_grad_norm``)."""

    def step(params: Params, opt_state: Dict, tokens: torch.Tensor):
        loss, grads = sharded_value_and_grad(params, tokens, cfg, mesh, sp_attn)
        optimizer.update(grads, opt_state, params, norm=global_grad_norm(grads, cfg, mesh))
        return params, opt_state, loss

    return step
