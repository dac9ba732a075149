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

        out["dryrun"] = multichip.dist_rank(
            rank, multichip.dryrun_job(mesh.size(*mesh.axis_names), "cpu"))
    if rank:
        out = {k: v for k, v in out.items() if not isinstance(v, dict)}
    return out


def _plant(fault: str) -> None:
    """A fault planted in this rank, which the distributed checks must
    catch: in the ring (``parallel/ring.py``) the step offset's sign
    flipped, the merge without its rescale, or the backward's dK/dV
    accumulators kept at the rank instead of travelling with their shard;
    in sharded serving (``runtime/sp_decode.py``) a local offset that
    ignores the shard, or an append that writes on every shard; a pipeline
    backward that sends zeros for the stage's input gradient
    (``models/pipeline.py``); an ep step that skips the return all-to-all
    (``models/moe.py``)."""
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
    elif fault == "offset_ignores_shard":
        from flash_attention_metal_tpu_torch.runtime import sp_decode

        sp_decode.local_offsets = lambda lengths, my_sp, maxloc: lengths.to(torch.int32)
    elif fault == "append_every_shard":
        from flash_attention_metal_tpu_torch.runtime import sp_decode

        put = sp_decode._put

        def every_shard(buf, new, start, owned, per_row):
            # The global position's row, clipped into every shard.
            return put(buf, new, start.clamp(0, buf.shape[2] - new.shape[2]),
                       torch.ones_like(owned), False)

        sp_decode._put = every_shard
    elif fault == "pp_zero_grad":
        from flash_attention_metal_tpu_torch.models import pipeline

        p2p = pipeline._p2p

        def zero_grads(mesh, send, recv):
            if send is not None and send[1] == -1:
                send = (torch.zeros_like(send[0]), -1)
            return p2p(mesh, send, recv)

        pipeline._p2p = zero_grads
    elif fault == "ep_no_return":
        from flash_attention_metal_tpu_torch.models import moe

        a2a = moe.all_to_all_diff

        def no_return(x, mesh, axis, split_dim, concat_dim):
            if split_dim == 1:  # the return trip: keep the rows here
                return x.reshape(-1, x.shape[1] // mesh.size(axis), x.shape[2])
            return a2a(x, mesh, axis, split_dim, concat_dim)

        moe.all_to_all_diff = no_return
    else:
        raise ValueError(f"unknown fault {fault!r}")


def planted_dist_rank(rank: int, fn_name: str, job: dict, fault=None):
    """``harness/multichip.py``'s rank function ``fn_name`` on ``job``,
    with ``fault`` planted first (``_plant``) when given."""
    from flash_attention_metal_tpu_torch.harness import multichip

    if fault is not None:
        _plant(fault)
    return getattr(multichip, fn_name)(rank, job)


def planted_attention_rank(rank: int, job: dict) -> dict:
    """``harness/multichip.py::attention_rank`` with ``job["fault"]``
    planted first (``_plant``)."""
    from flash_attention_metal_tpu_torch.harness import multichip

    _plant(job["fault"])
    return multichip.attention_rank(rank, job)


def _engine_run(params, cfg, requests, snapshot_after=None, **kw):
    """``{uid: (tokens, logprobs)}`` of ``requests`` (``(prompt, max_new)``
    pairs, greedy) through a ``DecodeEngine`` of the sp_decode tests.  With
    ``snapshot_after``: a snapshot after that many steps is restored into a
    fresh engine (another seed), which runs to the end; the result is
    ``{"went_on": ..., "restored": ...}``, each finished request's streams."""
    from flash_attention_metal_tpu_torch.runtime.engine import DecodeEngine, Request

    def engine(seed=0):
        return DecodeEngine(params, cfg, max_batch=4, max_len=512, eos_id=-1, harvest_lag=2,
                            seed=seed, **kw)

    def streams(e):
        return {u: (list(r.generated), list(r.logprobs)) for u, r in e.finished.items()}

    eng = engine()
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n, temperature=0.0)
            for i, (p, n) in enumerate(requests)]
    for r in reqs:
        eng.submit(r)
    if snapshot_after is None:
        eng.run()
        return {r.uid: (list(r.generated), list(r.logprobs)) for r in reqs}
    for _ in range(snapshot_after):
        eng.step()
    snap = eng.snapshot()
    before = streams(eng)
    eng.run()
    restored = engine(seed=77)
    restored.restore(snap)
    restored.finished = {}
    restored.run()
    return {"went_on": streams(eng), "restored": {**before, **streams(restored)}}


def sp_decode_cases(rank: int, spec: dict) -> dict:
    """``test_torch_sp_decode.py``'s sharded engines, one 8-rank group:
    each case of ``spec["cases"]`` (``name``, ``mesh`` (a shape; its axes
    ``("dp", "sp")`` for two dims, ``("dp", "tp", "sp")`` for three),
    ``cfg`` (a key of ``spec["cfgs"]``), ``engine`` (keyword arguments, a
    ``draft`` by key of ``spec["drafts"]``)) through ``DecodeEngine(mesh=)``
    on ``spec["requests"]``: ``{name: {uid: (tokens, logprobs)}}``."""
    meshes = {}
    out = {}
    for case in spec["cases"]:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            names = ("dp", "sp") if len(shape) == 2 else ("dp", "tp", "sp")
            meshes[shape] = make_mesh(shape, names, device="cpu")
        cfg_fields, params = spec["cfgs"][case["cfg"]]
        kw = dict(case["engine"])
        if "draft" in kw:
            d_fields, d_params = spec["drafts"][kw["draft"]]
            kw["draft"] = (d_params, ModelConfig(**d_fields))
        out[case["name"]] = _engine_run(params, ModelConfig(**cfg_fields), spec["requests"],
                                        mesh=meshes[shape], **kw)
    return out


def _shard_tokens(tokens, mesh, spec):
    return shard(tokens, mesh, spec)


def pp_cases(rank: int, spec: dict) -> list:
    """``test_torch_pipeline.py``'s cases, for each of ``spec["runs"]`` on a
    mesh over the group's first ranks (``mesh``, ``n_micro``, ``sp_attn``,
    and ``steps``: ``"loss"`` (the pp loss alone), ``"sgd"`` (one SGD step
    at ``spec["lr"]``) or ``"adamw"`` (one AdamW step, clip
    ``spec["clip"]``), whose unsharded updates rank 0 returns); None from a
    rank outside a run's mesh."""
    from flash_attention_metal_tpu_torch.models import pipeline as pl
    from flash_attention_metal_tpu_torch.models.trainer import constant_adamw

    cfg = ModelConfig(**spec["cfg"])
    stacked = pl.stack_layer_params(spec["params"])
    out = []
    meshes = {}
    for run in spec["runs"]:
        shape = tuple(run["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, pl.AXES, device="cpu", ranks=int(np.prod(shape)))
        mesh = meshes[shape]
        if mesh is None:
            out.append(None)
            continue
        local = pl.shard_pp_params(stacked, cfg, mesh)
        tokens = _shard_tokens(spec["tokens"], mesh, ("dp", "sp"))
        res = {}
        if run["steps"] == "loss":
            with torch.no_grad():
                res["loss"] = float(pl._pp_loss(
                    local, tokens, cfg, mesh, run["n_micro"], run["sp_attn"])[0])
        elif run["steps"] == "sgd":
            new, loss = pl.make_pp_train_step(mesh, cfg, run["n_micro"], lr=spec["lr"],
                                              sp_attn=run["sp_attn"])(local, tokens)
            res["loss"] = float(loss)
            res["delta"] = _pp_delta(new, stacked, cfg, mesh)
        else:
            opt = constant_adamw(spec["lr"], grad_clip=spec["clip"])
            params = map_params(torch.clone, local)
            state = opt.init(params)
            params, state, loss = pl.make_pp_optax_step(mesh, cfg, opt, run["n_micro"],
                                                        sp_attn=run["sp_attn"])(params, state,
                                                                                tokens)
            res["loss"] = float(loss)
            res["delta"] = _pp_delta(params, stacked, cfg, mesh)
        if rank:
            res.pop("delta", None)
        out.append(res)
    return out


def _pp_delta(new, stacked, cfg, mesh):
    from flash_attention_metal_tpu_torch.models import pipeline as pl
    from flash_attention_metal_tpu_torch.parallel.mesh import unshard

    full = map_params(lambda p, s: unshard(p, mesh, s), new, pl.pp_param_specs(cfg))
    return pl.unstack_layer_params(_delta(full, stacked))


def ep_cases(rank: int, spec: dict) -> list:
    """``test_torch_moe_ep.py``'s cases, for each of ``spec["runs"]`` on a
    mesh over the group's first ranks (None from a rank outside it): the ep
    loss at each capacity factor of
    ``capacities`` and, with ``steps``, one SGD and one AdamW step (at
    ``spec["lr"]`` / ``spec["adam_lr"]``) whose unsharded updates rank 0
    returns (AdamW with the clip ``spec["clip"]``)."""
    from flash_attention_metal_tpu_torch.models import moe
    from flash_attention_metal_tpu_torch.models.trainer import constant_adamw
    from flash_attention_metal_tpu_torch.parallel.mesh import unshard

    out = []
    meshes = {}
    for run in spec["runs"]:
        shape = tuple(run["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, moe.AXES, device="cpu", ranks=int(np.prod(shape)))
        mesh = meshes[shape]
        if mesh is None:
            out.append(None)
            continue
        tokens = _shard_tokens(spec["tokens"], mesh, moe.BATCH_SPEC)
        res = {}
        for factor in run["capacities"]:
            cfg = moe.MoEConfig(**{**spec["cfg"], "capacity_factor": factor})
            local = moe.shard_moe_params(spec["params"], cfg, mesh)
            with torch.no_grad():
                res[f"loss_{factor}"] = float(moe._moe_loss(local, tokens, cfg, mesh))
        if run.get("steps"):
            cfg = moe.MoEConfig(**spec["cfg"])
            specs = moe.moe_param_specs(cfg)

            def delta(new):
                full = map_params(lambda p, s: unshard(p, mesh, s), new, specs)
                return _delta(full, spec["params"])

            local = moe.shard_moe_params(spec["params"], cfg, mesh)
            local, loss = moe.make_moe_train_step(mesh, cfg, lr=spec["lr"])(local, tokens)
            res["sgd_loss"], res["sgd"] = float(loss), delta(local)
            opt = constant_adamw(spec["adam_lr"], grad_clip=spec["clip"])
            local = moe.shard_moe_params(spec["params"], cfg, mesh)
            state = opt.init(local)
            local, state, loss = moe.make_moe_optax_step(mesh, cfg, opt)(local, state, tokens)
            res["adamw_loss"], res["adamw"] = float(loss), delta(local)
            if rank:
                res.pop("sgd"), res.pop("adamw")
        out.append(res)
    return out
