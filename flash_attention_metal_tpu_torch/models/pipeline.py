"""Pipeline-parallel (pp) FlashLM training, composed with dp / tp / sp.

Counterpart of ``flash_attention_metal_tpu/models/pipeline.py``, on a
``("dp", "pp", "tp", "sp")`` mesh (``parallel/mesh.py::make_mesh`` with
these axis names):

* **Layer placement.**  The layer stack is stacked ``[n_layers, ...]``
  (``stack_layer_params``) and split over ``pp``: ``n_layers / pp``
  consecutive layers a stage.  Within a stage the block is the sharded
  step's Megatron attention and MLP (``parallel_train._tp_attention``,
  ``_tp_mlp``) with the all-gather or ring sequence attention, each block
  under an activation checkpoint.
* **Schedule (GPipe).**  The forward runs ``n_micro + pp - 1`` ticks: at
  tick ``t`` stage ``s`` runs microbatch ``t - s`` when there is one (a
  bubble tick computes nothing) and sends its ``[mb, n_loc, d]`` output to
  stage ``s + 1``, point to point.  Stage 0 embeds its microbatch; the last
  stage banks its outputs and computes the vocab-split cross entropy over
  all of them.  The backward is written out, as JAX derives it by autodiff
  through ``ppermute``: the reverse schedule, in which each stage receives
  the gradient of its output from the next stage, runs its backward, and
  sends the gradient of its input to the previous one.  Every tick's sends
  and receives go in one ``batch_isend_irecv``, matched pair by pair, so
  gloo cannot deadlock.
* **Gradients.**  The loss is real on the last stage only; embedding
  gradients live on stage 0, head gradients on the last stage and layer
  gradients on their own stage.  A leaf's gradient is summed over the axes
  that hold partial contributions to it and nothing else: dp and sp for
  every leaf, and pp for the leaves every stage holds (embedding, final
  norm, head), where the other stages contribute zeros.  So the pp step
  equals the single-device step.  JAX's does not: it ``psum``s gradients
  that autodiff has already summed, which scales its update by the mesh
  size (ROADMAP.md, Queue C 17); the port does not copy that.

The AdamW step (``make_pp_optax_step``) uses the port's ``AdamW`` with the
clip on the global norm, each element counted once (``parallel_train.global_norm``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.comm import _staged, all_reduce, copy_to
from ..parallel.mesh import Mesh, shard
from .parallel_train import (
    SP_ATTN,
    _tp_attention,
    _tp_mlp,
    check_config,
    global_norm,
    param_specs,
    sum_partial_grads,
    vocab_sharded_ce,
)
from .trainer import AdamW
from .transformer import ModelConfig, Params, map_params, rms_norm, weight

AXES = ("dp", "pp", "tp", "sp")


def stack_layer_params(params: Params) -> Params:
    """``layers: [dict] * L`` as ``layers: {name: [L, ...]}``, the form that
    splits over ``pp`` on its leading dim."""
    layers = params["layers"]
    out = dict(params)
    out["layers"] = {name: torch.stack([layer[name] for layer in layers]) for name in layers[0]}
    return out


def unstack_layer_params(params: Params) -> Params:
    """``stack_layer_params``' inverse (for checkpoints and the one-device
    functions)."""
    stacked = params["layers"]
    n = next(iter(stacked.values())).shape[0]
    out = dict(params)
    out["layers"] = [{name: stacked[name][i] for name in stacked} for i in range(n)]
    return out


def pp_param_specs(cfg: ModelConfig) -> Params:
    """Specs of the stacked parameters: each layer leaf gains a leading
    ``pp`` dim on top of the Megatron tp layout (``param_specs``)."""
    base = param_specs(cfg)
    specs = dict(base)
    specs["layers"] = {name: ("pp", *spec) for name, spec in base["layers"][0].items()}
    return specs


def pp_opt_state_specs(optimizer: AdamW, params: Params, cfg: ModelConfig) -> dict:
    """Specs of ``optimizer.init(stacked shards)``: the moments as the
    parameters they follow, the step count replicated."""
    return {"count": (), "mu": pp_param_specs(cfg), "nu": pp_param_specs(cfg)}


def shard_pp_params(params: Params, cfg: ModelConfig, mesh: Mesh) -> Params:
    """This rank's shards of a whole stacked tree, on ``mesh.device``."""
    return map_params(lambda p, s: shard(p, mesh, s), params, pp_param_specs(cfg))


def _pp_sum_axes(spec) -> Tuple[str, ...]:
    """The axes a stacked leaf's gradient holds partial sums along: dp and
    sp always, and pp where every stage holds the leaf (no ``pp`` in its
    spec)."""
    return ("dp", "sp") if "pp" in spec else ("dp", "pp", "sp")


def _p2p(mesh: Mesh, send: Optional[Tuple[torch.Tensor, int]],
         recv: Optional[Tuple[torch.Tensor, int]]) -> Optional[torch.Tensor]:
    """One tick's point-to-point transfers over ``pp``: ``send`` ``(tensor,
    step)`` to the stage ``step`` places on, ``recv`` ``(like, step)`` a
    tensor shaped like ``like`` from the stage ``step`` places on, posted
    together and waited on.  Returns the received tensor on ``like``'s
    device (None without ``recv``)."""
    group = mesh.group("pp")
    ops, buf = [], None
    if send is not None:
        t, step = send
        ops.append(dist.P2POp(dist.isend, _staged(t, mesh), mesh.peer("pp", step), group))
    if recv is not None:
        like, step = recv
        on_host = mesh.backend == "gloo" and like.is_cuda
        buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if on_host else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, mesh.peer("pp", step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if buf is None else buf.to(recv[0].device)


def _pp_loss(params: Params, tokens: torch.Tensor, cfg: ModelConfig, mesh: Mesh,
             n_micro: int, sp_attn: str):
    """``(loss, grads)`` of this rank's stacked shards under the GPipe
    schedule (JAX ``_pp_loss`` with its backward): the global loss on every
    rank, and this rank's gradient before any sum over the mesh; under
    ``torch.no_grad`` the forward alone, and None for the gradient."""
    if sp_attn not in SP_ATTN:
        raise ValueError(f"sp_attn must be one of {SP_ATTN}, got {sp_attn!r}")
    check_config(cfg, mesh)
    pp, s = mesh.size("pp"), mesh.index("pp")
    b_loc, n_loc = tokens.shape
    if b_loc % n_micro:
        raise ValueError(f"local batch {b_loc} not divisible by n_micro={n_micro}")
    mb = b_loc // n_micro
    live = map_params(lambda p: p.detach().requires_grad_(True), params)
    n_layers = next(iter(live["layers"].values())).shape[0]
    layers = [{name: leaf[i] for name, leaf in live["layers"].items()} for i in range(n_layers)]
    positions = (mesh.index("sp") * n_loc
                 + torch.arange(n_loc, device=tokens.device)).expand(mb, n_loc)
    tokens_mb = tokens.reshape(n_micro, mb, n_loc)

    def block(x, layer):
        x = _tp_attention(layer, x, cfg, positions, mesh, sp_attn)
        return _tp_mlp(layer, x, cfg, mesh)

    def stage(x):
        for layer in layers:
            x = checkpoint(block, x, layer, use_reentrant=False)
        return x

    like = torch.empty((mb, n_loc, cfg.d_model), dtype=cfg.dtype, device=tokens.device)
    ins: Dict[int, torch.Tensor] = {}
    outs: Dict[int, torch.Tensor] = {}
    received: Optional[torch.Tensor] = None
    for t in range(n_micro + pp - 1):
        m = t - s
        if 0 <= m < n_micro:
            if s == 0:
                x = F.embedding(tokens_mb[m].long(), live["embed"]).to(cfg.dtype)
            else:
                x = ins[m] = received.requires_grad_(True)
            outs[m] = stage(x)
        # Stage s hands microbatch t - s to stage s + 1, which runs it at
        # tick t + 1.
        send = (outs[m].detach(), 1) if (0 <= m < n_micro and s < pp - 1) else None
        m_in = t - (s - 1)
        recv = (like, -1) if (s > 0 and 0 <= m_in < n_micro) else None
        received = _p2p(mesh, send, recv)

    last = s == pp - 1
    if last:
        # The cross entropy over every banked microbatch, in token order;
        # its backward runs this stage's backward for all of them.
        x = rms_norm(torch.cat([outs[m] for m in range(n_micro)]), live["final_norm"])
        logits = (copy_to(x, mesh, "tp") @ weight(live["lm_head"], cfg.dtype)).float()
        loss = vocab_sharded_ce(logits, tokens, mesh)
        if torch.is_grad_enabled():
            loss.backward()
    # The reverse schedule: at reverse tick t stage s has run the backward
    # of microbatch t - s and sends its input's gradient to stage s - 1.
    grad_out: Optional[torch.Tensor] = None
    for t in reversed(range(n_micro + pp - 1) if torch.is_grad_enabled() else ()):
        m = t - s
        active = 0 <= m < n_micro
        if active and not last:
            torch.autograd.backward([outs[m]], [grad_out])
        send = (ins[m].grad, -1) if (active and s > 0) else None
        # Stage s + 1 sends its microbatch t - (s + 1) at this tick, whose
        # backward stage s runs at tick t - 1.
        recv = (like, 1) if (not last and 0 <= t - 1 - s < n_micro) else None
        grad_out = _p2p(mesh, send, recv)
    loss_val = loss.detach() if last else torch.zeros((), dtype=torch.float32,
                                                      device=tokens.device)
    loss_val = all_reduce(loss_val, mesh, ("pp",))
    if not torch.is_grad_enabled():
        return loss_val, None
    grads = map_params(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, live)
    return loss_val, grads


def pp_value_and_grad(params: Params, tokens: torch.Tensor, cfg: ModelConfig, mesh: Mesh,
                      n_micro: int, sp_attn: str = "allgather") -> Tuple[torch.Tensor, Params]:
    """``(loss, grads)``: the global loss and this rank's shards of the
    single-device gradient (partial sums joined over dp x sp, and over pp
    for the leaves every stage holds)."""
    loss, grads = _pp_loss(params, tokens, cfg, mesh, n_micro, sp_attn)
    return loss, sum_partial_grads(grads, pp_param_specs(cfg), mesh, _pp_sum_axes)


def _check_split(cfg: ModelConfig, mesh: Mesh) -> None:
    pp = mesh.size("pp")
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")


def make_pp_train_step(mesh: Mesh, cfg: ModelConfig, n_micro: int, lr: float = 1e-2,
                       sp_attn: str = "allgather"):
    """``step(params, tokens) -> (params, loss)``: one SGD step on this
    rank's stacked shards (``shard_pp_params(stack_layer_params(...))``)
    and token block (``parallel_train.batch_sharding``: ``B`` divisible by
    ``dp * n_micro``, ``N`` by ``sp``), returning new shards and the global
    loss.  The bubble is ``(pp - 1) / (n_micro + pp - 1)`` of the ticks; any
    ``n_micro >= 1`` is correct."""
    _check_split(cfg, mesh)

    def step(params: Params, tokens: torch.Tensor):
        loss, grads = pp_value_and_grad(params, tokens, cfg, mesh, n_micro, sp_attn)
        with torch.no_grad():
            params = map_params(lambda p, g: p - lr * g, params, grads)
        return params, loss

    return step


def make_pp_optax_step(mesh: Mesh, cfg: ModelConfig, optimizer: AdamW, n_micro: int,
                       sp_attn: str = "allgather"):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)`` with
    the port's ``AdamW`` (state sharded as ``pp_opt_state_specs``; build it
    with ``optimizer.init`` on the shards), updated in place, its clip on
    the global norm."""
    _check_split(cfg, mesh)
    specs = pp_param_specs(cfg)

    def step(params: Params, opt_state: dict, tokens: torch.Tensor):
        loss, grads = pp_value_and_grad(params, tokens, cfg, mesh, n_micro, sp_attn)
        optimizer.update(grads, opt_state, params, norm=global_norm(grads, specs, mesh))
        return params, opt_state, loss

    return step
