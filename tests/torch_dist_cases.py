"""Rank-side cases of the port's distributed tests (no JAX here).

``tests/test_torch_parallel.py`` and ``tests/test_torch_parallel_train.py``
spawn one gloo group of CPU ranks (``parallel.spawn``) and each rank runs a
function of this module on numpy inputs the test made from a seed; the
test gathers the ranks' shards and holds them against the JAX package's
functions on its virtual mesh.  Spawned ranks import this module by name,
so it imports torch and the port only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flash_attention_metal_tpu_torch.harness import scaling
from flash_attention_metal_tpu_torch.parallel import (
    allgather_attention,
    lse_combine_attention,
    make_mesh,
    make_ring_attention,
    ring_flash_attention,
    ring_flash_attention_diff,
    shard,
    ulysses_attention,
)
from flash_attention_metal_tpu_torch.models.parallel_train import (
    SP_ATTN,
    batch_sharding,
    make_adamw_train_step,
    make_train_step,
    shard_params,
    sharded_loss,
    unshard_params,
    vocab_sharded_ce,
)
from flash_attention_metal_tpu_torch.models.trainer import constant_adamw
from flash_attention_metal_tpu_torch.models.transformer import ModelConfig, map_params, param_leaves

SP = (None, None, "sp", None)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _grads(fn, mesh, q, k, v, co, dtype=torch.float32):
    """``(o, dq, dk, dv)`` of this rank's shards for ``sum(fn(q, k, v) * co)``."""
    qs, ks, vs = (shard(_t(x, dtype), mesh, SP).requires_grad_(True) for x in (q, k, v))
    o = fn(qs, ks, vs)
    (o.float() * shard(_t(co), mesh, SP)).sum().backward()
    return o.detach(), qs.grad, ks.grad, vs.grad


def attention_cases(rank: int, inputs: dict) -> dict:
    """Every attention case of ``test_torch_parallel.py`` on a 1-D sp mesh
    of the group's size: this rank's output (and gradient) shards."""
    mesh = make_mesh(device="cpu")
    out = {}
    q, k, v, co = (inputs[n] for n in ("q", "k", "v", "co"))
    for causal in (False, True):
        o, lse = ring_flash_attention(*(shard(_t(x), mesh, SP) for x in (q, k, v)), mesh,
                                      causal=causal, save_lse=True)
        out[f"ring_fwd_causal{int(causal)}"] = (o, lse)
        out[f"ring_grad_causal{int(causal)}"] = _grads(
            lambda a, b, c: ring_flash_attention_diff(a, b, c, mesh, causal=causal), mesh,
            q, k, v, co)
    gq, gk, gv = (inputs[n] for n in ("gqa_q", "gqa_k", "gqa_v"))
    out["ring_gqa"] = _grads(lambda a, b, c: ring_flash_attention_diff(a, b, c, mesh, causal=True),
                             mesh, gq, gk, gv, inputs["gqa_co"])
    out["ring_dropout"] = _grads(
        lambda a, b, c: ring_flash_attention_diff(a, b, c, mesh, causal=True, dropout_rate=0.1,
                                                  dropout_seed=inputs["seed"]),
        mesh, q, k, v, co)
    ring = make_ring_attention(mesh, causal=True)
    out["ring_bf16"] = ring(*(_t(x, torch.bfloat16) for x in (q, k, v)))
    out["ring_reference"] = make_ring_attention(mesh, causal=True, impl="reference")(
        *(_t(x) for x in (q, k, v)))
    for causal in (False, True):
        out[f"allgather_causal{int(causal)}"] = _grads(
            lambda a, b, c: allgather_attention(a, b, c, mesh, causal=causal), mesh, q, k, v, co)
    out["allgather_dropout"] = _grads(
        lambda a, b, c: allgather_attention(a, b, c, mesh, causal=True, dropout_rate=0.1,
                                            dropout_seed=inputs["seed"]),
        mesh, q, k, v, co)
    dq = _t(inputs["dec_q"])
    for causal in (False, True):
        out[f"lse_causal{int(causal)}"] = lse_combine_attention(
            dq, *(shard(_t(inputs[n]), mesh, SP) for n in ("dec_k", "dec_v")), mesh,
            causal=causal)
    uq, uk, uv = (inputs[n] for n in ("uly_q", "uly_k", "uly_v"))
    out["ulysses"] = _grads(lambda a, b, c: ulysses_attention(a, b, c, mesh, causal=True), mesh,
                            uq, uk, uv, inputs["uly_co"])
    try:
        ulysses_attention(*(shard(_t(inputs[n]), mesh, SP) for n in ("uly_q", "bad_k", "bad_k")),
                          mesh, causal=True)
        out["ulysses_bad_ratio"] = None
    except ValueError as e:
        out["ulysses_bad_ratio"] = str(e)
    out["scaling"] = scaling._ring_rank(rank, dict(
        shards=mesh.size("sp"), n=256, heads=2, head_dim=64, causal=True, device="cpu", iters=1))
    return out


def _delta(new, full):
    return map_params(lambda a, b: a - b, new, full)


def train_cases_on_meshes(rank: int, specs: list) -> list:
    """``train_cases`` for each spec in turn, on one group (each spec's
    mesh spans the whole group)."""
    return [train_cases(rank, spec) for spec in specs]


def train_cases(rank: int, spec: dict) -> dict:
    """``test_torch_parallel_train.py``'s cases on a mesh of ``spec["mesh"]``:
    the shard/unshard round trip, the sharded loss with both sp
    attentions, and (``spec["steps"]``) one SGD step per sp attention and
    one AdamW step with a binding clip, whose unsharded updates rank 0
    returns, the dropout loss (``spec["dropout_seeds"]``) and
    ``vocab_sharded_ce`` on ``spec["logits"]``."""
    cfg = ModelConfig(**spec["cfg"])
    mesh = make_mesh(spec["mesh"], device="cpu")
    full = spec["params"]
    tokens = batch_sharding(mesh).shard(spec["tokens"])
    local = shard_params(full, cfg, mesh)
    back = unshard_params(local, cfg, mesh)
    out = {"round_trip": all(torch.equal(a, b) for a, b in zip(param_leaves(back),
                                                                param_leaves(full)))}
    with torch.no_grad():
        for attn in SP_ATTN:
            out[f"loss_{attn}"] = float(sharded_loss(local, tokens, cfg, mesh, attn))
    if "logits" in spec:
        logits = shard(spec["logits"], mesh, ("dp", "sp", "tp"))
        out["ce"] = float(vocab_sharded_ce(logits, tokens, mesh))
    if "dropout_seeds" in spec:
        dcfg = dataclasses.replace(cfg, attn_dropout=spec["dropout_rate"])
        with torch.no_grad():
            for attn in SP_ATTN:
                out[f"dropout_loss_{attn}"] = float(
                    sharded_loss(local, tokens, dcfg, mesh, attn, spec["dropout_seeds"]))
    if spec.get("steps"):
        lr = spec["lr"]
        for attn in SP_ATTN:
            new, loss = make_train_step(mesh, cfg, lr=lr, sp_attn=attn)(local, tokens)
            out[f"sgd_loss_{attn}"] = float(loss)
            out[f"sgd_{attn}"] = _delta(unshard_params(new, cfg, mesh), full)
        opt = constant_adamw(lr, grad_clip=spec["clip"])
        params = map_params(torch.clone, local)
        state = opt.init(params)
        step = make_adamw_train_step(mesh, cfg, opt)
        params, state, loss = step(params, state, tokens)
        out["adamw"] = _delta(unshard_params(params, cfg, mesh), full)
    if spec.get("dryrun"):
        from flash_attention_metal_tpu_torch.harness import multichip

        out["dryrun"] = multichip.sharded_train_rank(
            rank, multichip.dryrun_job(mesh.size(*mesh.axis_names), "cpu"))
    if rank:
        out = {k: v for k, v in out.items() if not isinstance(v, dict)}
    return out


def _plant(fault: str) -> None:
    """A fault planted in this rank's ring (``parallel/ring.py``), which
    the distributed checks must catch: the step offset's sign flipped, the
    merge without its rescale, or the backward's dK/dV accumulators kept
    at the rank instead of travelling with their shard."""
    from flash_attention_metal_tpu_torch.parallel import ring

    if fault == "ring_offset_sign":
        ring._step_offset = lambda my, src, n_loc: (src - my) * n_loc
    elif fault == "merge_no_rescale":
        def merge(o_a, lse_a, o_b, lse_b):
            w_a, w_b = (torch.isfinite(x).float() for x in (lse_a, lse_b))
            n = (w_a + w_b).clamp(min=1.0)
            return (o_a * w_a + o_b * w_b) / n, torch.maximum(lse_a, lse_b)
        ring.merge_partials = merge
    elif fault == "accumulators_stay":
        ring._pass_on = lambda dk, dv, mesh, axis: (dk, dv)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def planted_attention_rank(rank: int, job: dict) -> dict:
    """``harness/multichip.py::attention_rank`` with ``job["fault"]``
    planted first (``_plant``)."""
    from flash_attention_metal_tpu_torch.harness import multichip

    _plant(job["fault"])
    return multichip.attention_rank(rank, job)
