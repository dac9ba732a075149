"""The multi-rank dry run: sharded training, serving, the pipeline and
expert parallelism on one group of ranks.

Counterpart of ``__graft_entry__.dryrun_multichip``'s five checks
(``MULTICHIP_r05.json``), on a group of ``n`` ranks (8: mesh dp 2 x tp 2 x
sp 2):

1. the sharded SGD step (``models/parallel_train.py``, all-gather sequence
   attention) lowers the loss over two steps;
2. the ring sequence attention's step gives a loss within 5e-2 of it;
3. greedy int8 decode on the dp x tp x sp mesh (``DecodeEngine(mesh=)``,
   ``runtime/sp_decode.py``) equals the one-device engine's, also with
   ``multi_step=2``, and with a 1-layer draft at ``spec_gamma=2`` on a
   dense cache;
4. the pipeline's loss (``models/pipeline.py``, mesh dp x pp x tp x sp =
   (2, 2, 2, 1), ``n_micro=2``) is finite and falls over two steps;
5. the MoE loss with expert parallelism (``models/moe.py``, mesh dp x ep x
   tp x sp = (2, 2, 2, 1), 4 experts, top-2, capacity 2.0) falls over two
   steps.

The rank side is shared with ``chip_smoke.py``'s full-width runs:
``sharded_train_rank``, ``serve_full_rank``, ``pp_full_rank`` and
``ep_full_rank``, run in turn on one group by ``dist_rank``.  Every rank
draws the same parameters and tokens from the seed, takes its shards, runs
the steps and reports its losses (or streams), times and kernel launches.
One card hosts no two NCCL ranks, so on a one-card machine the ranks share
the card over gloo (``--backend gloo``): a check of the code path, not a
scaling figure.

    python -m flash_attention_metal_tpu_torch.harness.multichip [--ranks 8] [--backend nccl|gloo] [--device cuda|cpu]

Checks 3-5 need an even number of ranks, as JAX's do.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import flash_bwd as fb
from ..kernels import flash_fwd as ff
from ..kernels import flash_tri as ft
from ..models.parallel_train import (
    batch_sharding,
    make_adamw_train_step,
    make_train_step,
    param_specs,
    shard_params,
)
from ..models.trainer import constant_adamw
from ..models.transformer import ModelConfig, init_params, map_params, param_leaves
from ..parallel.mesh import make_mesh, spawn, unshard

# The dry run's model: __graft_entry__.dryrun_multichip's FlashLM.
DRYRUN_CFG = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
                  d_ff=256, max_seq_len=512, dtype="float32")
RING_TOL = 5e-2


def mesh_shape(n: int) -> Tuple[int, int, int]:
    """``(dp, tp, sp)`` for ``n`` ranks, as ``dryrun_multichip`` factors
    it: tp 2 where it can (the model's 2 K/V heads), the rest over dp and
    sp."""
    if n % 4 == 0:
        return (n // 4, 2, 2)
    if n % 2 == 0:
        return (1, 2, n // 2)
    return (1, 1, n)


def kernel_counters() -> Dict[str, object]:
    """The wrappers of the kernels the distributed paths launch, by kernel
    name: the general forward (all-gather attention, dropout, sharded
    serving on a dense cache, the pipelined and the ep step, whose
    differentiable op passes a tensor offset), the triangular forward
    (causal ring steps), the split pair (every backward) and the 8-bit
    cache's kernel (sharded int8 serving)."""
    from ..kernels import quant as qt

    return {"flash_fwd": ff.flash_fwd_general, "flash_tri": ft.flash_attention_tri,
            "flash_bwd_dkv": fb.flash_bwd_dkv, "flash_bwd_dq": fb.flash_bwd_dq,
            "flash_quant": qt.flash_attention_quant}


# The kernels of the attention and training paths (the 8-bit cache's runs
# only in sharded int8 serving).
TRAIN_KERNELS = ("flash_fwd", "flash_tri", "flash_bwd_dkv", "flash_bwd_dq")


def _zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def _counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def _config(cfg: dict) -> ModelConfig:
    return ModelConfig(**{**cfg, "dtype": getattr(torch, cfg["dtype"])})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gathered(x: torch.Tensor, rank: int) -> Optional[torch.Tensor]:
    return x.float().cpu() if rank == 0 else None


def update_errors(delta, grads, lr: float) -> List[float]:
    """Per leaf (``param_leaves`` order), the relative L2 of a sharded SGD
    update ``delta`` (unsharded, on the CPU) against the single-device
    update ``-lr * grads``: each leaf on its own, so the large embedding
    and head leaves cannot hide an attention leaf's error."""
    errors = []
    for d, g in zip(param_leaves(delta), param_leaves(grads)):
        want = (-lr * g.float()).cpu()
        errors.append(float((d - want).norm() / want.norm()))
    return errors


def sharded_train_rank(rank: int, job: dict) -> dict:
    """One rank of a sharded training run (``job``: ``mesh``, ``cfg`` (a
    ``ModelConfig``'s fields, ``dtype`` by name), ``batch`` ``(B, N)``,
    ``seed``, ``lr``, ``device``, ``sgd_steps``, and optionally
    ``adamw_steps``, ``adamw_lr`` (default ``lr``) and ``return_delta``).  It runs ``sgd_steps`` SGD steps
    with the all-gather attention from the seeded parameters, one ring
    step from the same parameters, and ``adamw_steps`` AdamW steps from
    them.  Returns the losses, each step's wall seconds, the kernel
    launches of those steps, and on rank 0 with ``return_delta`` the
    updates of the first SGD step and of the ring step, unsharded (fp32, on
    the CPU)."""
    device = torch.device(job["device"])
    cfg = _config(job["cfg"])
    mesh = make_mesh(job["mesh"], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(job["seed"])
    full = init_params(cfg, gen, master_dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, job["batch"], generator=gen, device=device)
    params = shard_params(full, cfg, mesh)
    del full
    tokens = batch_sharding(mesh).shard(tokens)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    out = {"losses": [], "step_s": []}

    def timed(fn, *args):
        _sync(device)
        t0 = time.perf_counter()
        res = fn(*args)
        _sync(device)
        out["step_s"].append(time.perf_counter() - t0)
        return res

    def delta(new):
        # Leaf by leaf, so no rank holds the whole tree on the card.
        return map_params(lambda a, b, s: _gathered(unshard(a - b, mesh, s), rank), new, params,
                          param_specs(cfg))

    sgd = make_train_step(mesh, cfg, lr=job["lr"])
    p = params
    for i in range(job["sgd_steps"]):
        new, loss = timed(sgd, p, tokens)
        out["losses"].append(float(loss))
        if i == 0 and job.get("return_delta"):
            out["delta"] = delta(new)
        p = new
    del p
    new, loss = timed(make_train_step(mesh, cfg, lr=job["lr"], sp_attn="ring"), params, tokens)
    out["loss_ring"] = float(loss)
    if job.get("return_delta"):
        out["delta_ring"] = delta(new)
    del new
    if job.get("adamw_steps"):
        opt = constant_adamw(job.get("adamw_lr", job["lr"]))
        state = opt.init(params)
        step = make_adamw_train_step(mesh, cfg, opt)
        out["adamw_losses"] = []
        for _ in range(job["adamw_steps"]):
            params, state, loss = timed(step, params, state, tokens)
            out["adamw_losses"].append(float(loss))
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    return out


ATTENTION_METHODS = ("ring", "ring_dropout", "allgather", "ulysses")


def _uniform(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    x = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (2 * x - 1).to(dtype)


def _err(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """``(max |got - want|, max |want|)`` over the entries ``want`` holds
    finite (an lse of -inf on both sides agrees)."""
    got, want = got.detach().float(), want.detach().float()
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max()) if bool(fin.any()) else 0.0
    if not bool((torch.isfinite(got) == fin).all()) or not bool((got[~fin] == want[~fin]).all()):
        return float("inf"), scale
    return (float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0), scale


def attention_rank(rank: int, job: dict) -> dict:
    """One rank of the distributed attention check on a 1-D sp mesh of the
    group's size (``job``: ``device``, ``seed``, ``shape`` ``(B, H, H_kv,
    N, D)``, ``dtype`` by name, ``methods`` (of ``ATTENTION_METHODS``),
    ``dropout_rate``, ``dropout_seed``, ``decode_rows``, and optionally
    ``fp32_shape``).

    Every rank draws the same global inputs from the seed and computes the
    port's single-device op on the whole sequence (causal; with its lse
    and the gradients of a seeded cotangent) outside the launch counts.
    Then, counted, each method on this rank's shards: ring and ring with
    dropout (``ring_flash_attention_diff``; the lse from
    ``ring_flash_attention``), all-gather and Ulysses, each with its
    gradients, and lse-combine in the decode topology (the last
    ``decode_rows`` rows as replicated queries over the sharded K/V).
    Returns each output's and gradient's ``(max abs error, max abs
    reference)`` over this rank's shard, the launches of the counted
    calls, and with ``fp32_shape`` the fp32 ring's forward error."""
    from ..ops.attention import flash_attention
    from ..parallel.context import allgather_attention, lse_combine_attention
    from ..parallel.mesh import shard
    from ..parallel.ring import ring_flash_attention, ring_flash_attention_diff
    from ..parallel.ulysses import ulysses_attention

    device = torch.device(job["device"])
    mesh = make_mesh(device=device)
    b, h, h_kv, n, d = job["shape"]
    dtype = getattr(torch, job["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(job["seed"])
    q, co = _uniform(gen, (b, h, n, d), dtype), _uniform(gen, (b, h, n, d), dtype)
    k, v = _uniform(gen, (b, h_kv, n, d), dtype), _uniform(gen, (b, h_kv, n, d), dtype)
    seq = (None, None, "sp", None)
    drops = {"plain": {}, "dropout": dict(dropout_rate=job["dropout_rate"],
                                          dropout_seed=job["dropout_seed"])}
    refs = {}
    for key in {"dropout" if m == "ring_dropout" else "plain" for m in job["methods"]}:
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o, lse = flash_attention(*leaves, causal=True, save_lse=True, **drops[key])
        torch.autograd.backward([o], [co])
        refs[key] = {"o": o.detach(), "lse": lse.detach(),
                     **{g: x.grad for g, x in zip(("dq", "dk", "dv"), leaves)}}
    q_dec = _uniform(gen, (b, h, job["decode_rows"], d), dtype)
    from ..kernels.flash_fwd import flash_attention_fwd

    dec_ref = flash_attention_fwd(q_dec, k, v, causal=True)
    _sync(device)

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    errors = {}
    for method in job["methods"]:
        drop = drops["dropout" if method == "ring_dropout" else "plain"]
        ref = refs["dropout" if method == "ring_dropout" else "plain"]
        leaves = [shard(x, mesh, seq).requires_grad_(True) for x in (q, k, v)]
        e = {}
        if method in ("ring", "ring_dropout"):
            o = ring_flash_attention_diff(*leaves, mesh, causal=True, **drop)
            with torch.no_grad():
                _, lse = ring_flash_attention(*(x.detach() for x in leaves), mesh, causal=True,
                                              save_lse=True, **drop)
            e["lse"] = _err(lse, shard(ref["lse"], mesh, seq[:3]))
        elif method == "allgather":
            o = allgather_attention(*leaves, mesh, causal=True)
        elif method == "ulysses":
            o = ulysses_attention(*leaves, mesh, causal=True)
        else:
            raise ValueError(f"unknown method {method!r}")
        torch.autograd.backward([o], [shard(co, mesh, seq)])
        e["o"] = _err(o, shard(ref["o"], mesh, seq))
        for g, x in zip(("dq", "dk", "dv"), leaves):
            e[g] = _err(x.grad, shard(ref[g], mesh, seq))
        errors[method] = e
    k_s, v_s = (shard(x, mesh, seq) for x in (k, v))
    errors["lse_combine"] = {"o": _err(lse_combine_attention(q_dec, k_s, v_s, mesh, causal=True),
                                       dec_ref)}
    _sync(device)
    out = {"errors": errors, "seconds": time.perf_counter() - t0,
           "launches": {name: fn.launches for name, fn in counters.items()}}
    if job.get("fp32_shape"):
        b, h, h_kv, n, d = job["fp32_shape"]
        q, k, v = (_uniform(gen, (b, hh, n, d), torch.float32) for hh in (h, h_kv, h_kv))
        want = flash_attention_fwd(q, k, v, causal=True)
        got = ring_flash_attention(*(shard(x, mesh, seq) for x in (q, k, v)), mesh, causal=True)
        out["fp32_ring"] = _err(got, shard(want, mesh, seq))
    return out


def attention_errors(ranks: Sequence[dict]) -> Dict[str, Dict[str, float]]:
    """The ranks' ``attention_rank`` reports merged: each output's largest
    error (``o`` and ``lse`` absolute, gradients over the largest reference
    gradient)."""
    out: Dict[str, Dict[str, float]] = {}
    for method in ranks[0]["errors"]:
        out[method] = {}
        for key in ranks[0]["errors"][method]:
            err = max(r["errors"][method][key][0] for r in ranks)
            scale = max(r["errors"][method][key][1] for r in ranks)
            out[method][key] = err if key in ("o", "lse") else err / scale
    return out


# The dry run's serving check (check 3, JAX's): its draft (DRYRUN_CFG with
# 1 layer, 2 / 1 heads, d_ff 128), its two requests of 4 new tokens, and the
# modes: int8, int8 with multi_step=2, dense with the draft at gamma 2.
DRYRUN_DRAFT = dict(n_layers=1, d_model=128, n_heads=2, n_kv_heads=1, d_ff=128)
DRYRUN_PROMPTS = ([3, 1, 4, 1, 5], list(range(40)))
DRYRUN_SERVE_MODES = (("int8", {"kv_quant": "int8"}),
                      ("int8_multi_step_2", {"kv_quant": "int8", "multi_step": 2}),
                      ("draft", {"draft": True}))


def serving_model(job: dict, device) -> tuple:
    """``(params, cfg, draft)`` of a serving job (``cfg``: a ``ModelConfig``'s
    fields, ``dtype`` by name; ``draft``: the draft's sizes or None): the
    weights drawn from ``job["seed"]`` in ``cfg.dtype``, the draft's from
    ``seed + 1`` (``serving.draft_model``), the same in every process."""
    from .serving import draft_model

    cfg = _config(job["cfg"])
    gen = torch.Generator(device=device)
    gen.manual_seed(job["seed"])
    params = init_params(cfg, gen)
    draft = draft_model(cfg, job["draft"], job["seed"], device) if job.get("draft") else None
    return params, cfg, draft


def teacher_forced_logits(eng, prompt: Sequence[int], forced: Sequence[int],
                          slot: int) -> Optional[torch.Tensor]:
    """The fp32 logits an engine serves for ``prompt`` in its free global
    ``slot`` and then for each of ``forced`` fed in turn (its prefill's last
    row, then one decode step a token), ``[1 + len(forced), V]`` on the CPU;
    on a mesh only the ranks holding the slot return them (None elsewhere),
    and every rank must call it.  A sharded engine's steps run through
    ``SpStepFns``, a one-device engine's through ``decode_step``."""
    from ..runtime.decode import decode_step
    from ..runtime.engine import Request
    from ..runtime.kv_cache import bump_lengths

    logits = [eng.prefill_request(slot, Request(uid=-1, prompt=list(prompt)))]
    local = eng._local(slot)
    b_loc = eng._b_loc
    for tok in forced:
        toks = torch.zeros((b_loc,), dtype=torch.int32, device=eng.device)
        active = torch.zeros((b_loc,), dtype=torch.bool, device=eng.device)
        if local is not None:
            toks[local], active[local] = tok, True
        if eng._sp is not None:
            step, eng.cache = eng._sp._forward(eng.params, eng.cache, toks[:, None],
                                               eng.cache.lengths[:, None])
            step = step[:, 0]
            eng.cache = bump_lengths(eng.cache, 1, active)
        else:
            step, eng.cache = decode_step(eng.params, eng.cfg, eng.cache, toks, active)
        if local is not None:
            logits.append(step[local])
    if local is None:
        return None
    return torch.stack([x.float() for x in logits]).cpu()


def serve_engines(params, cfg, draft, job: dict, mesh=None) -> dict:
    """Every mode of ``job["modes"]`` (``(name, options)``; ``draft`` in the
    options: serve with the job's draft) through a ``DecodeEngine`` of
    ``job["max_batch"]`` x ``job["max_len"]``, sharded on ``mesh`` (dp x tp x
    sp) when given, on the greedy requests ``job["prompts"]`` x
    ``job["max_new"]``; then, in the first engine of each cache kind (its
    ``kv_quant``), each ``job["check"]`` ``(prompt, forced, slot)`` teacher
    forced (``teacher_forced_logits``) into its freed slots.  The later
    modes of a kind (``multi_step``, a draft) would repeat those logits bit
    for bit: teacher forcing runs the target's one-token steps on the same
    cache, whatever the mode dispatches.  Returns per mode the streams
    ``{uid: tokens}``, the run's wall seconds and kernel launches (counts
    set to 0 just before the run, read just after), and the teacher-forced
    logits, or for a later mode of a kind the name of the mode that holds
    them (``"logits_of"``)."""
    from ..runtime.engine import DecodeEngine, Request

    out, checked = {}, {}
    for name, options in job["modes"]:
        kw = dict(options)
        if kw.pop("draft", False):
            kw.update(draft=draft, spec_gamma=job["spec_gamma"])
        if mesh is not None:
            kw.update(mesh=mesh, seq_axis="sp", head_axis="tp")
        eng = DecodeEngine(params, cfg, max_batch=job["max_batch"], max_len=job["max_len"],
                           seed=job["seed"], **kw)
        device = eng.device
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=job["max_new"])
                for i, p in enumerate(job["prompts"])]
        for r in reqs:
            eng.submit(r)
        _sync(device)
        _zero_counts()
        t0 = time.perf_counter()
        eng.run()
        _sync(device)
        seconds, launches = time.perf_counter() - t0, _counts()
        out[name] = {"streams": {r.uid: list(r.generated) for r in reqs}, "seconds": seconds,
                     "launches": launches}
        kind = options.get("kv_quant")
        if kind in checked:
            out[name]["logits_of"] = checked[kind]
        else:
            checked[kind] = name
            out[name]["logits"] = [teacher_forced_logits(eng, prompt, forced, slot)
                                   for prompt, forced, slot in job["check"]]
        del eng
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def serve_full_rank(rank: int, job: dict) -> dict:
    """(d) on one rank: ``serve_engines`` on the ``(dp, tp, sp)`` mesh
    ``job["mesh"]`` with the seeded serving model (``serving_model``); with
    ``job["single"]`` rank 0 also serves every mode on one device (its
    report's ``"single"``)."""
    device = torch.device(job["device"])
    mesh = make_mesh(job["mesh"], ("dp", "tp", "sp"), device=device)
    params, cfg, draft = serving_model(job, device)
    out = serve_engines(params, cfg, draft, job, mesh)
    if job.get("single") and rank == 0:
        out["single"] = serve_engines(params, cfg, draft, job)
    return out


def pp_full_rank(rank: int, job: dict) -> dict:
    """(e) on one rank: ``job["steps"]`` pipelined SGD steps of the seeded
    FlashLM (``job["cfg"]``, fp32 masters) on mesh ``job["mesh"]`` ``(dp, pp,
    tp, sp)`` with ``job["n_micro"]`` microbatches: the losses, the wall
    seconds and launches of the steps, and on rank 0 the first step's
    update, unstacked and unsharded leaf by leaf (fp32, on the CPU)."""
    from ..models.pipeline import (
        AXES,
        make_pp_train_step,
        pp_param_specs,
        shard_pp_params,
        stack_layer_params,
        unstack_layer_params,
    )
    from ..parallel.mesh import shard

    device = torch.device(job["device"])
    cfg = _config(job["cfg"])
    mesh = make_mesh(job["mesh"], AXES, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(job["seed"])
    full = init_params(cfg, gen, master_dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, job["batch"], generator=gen, device=device)
    params = shard_pp_params(stack_layer_params(full), cfg, mesh)
    del full
    tokens = shard(tokens, mesh, ("dp", "sp"))
    step = make_pp_train_step(mesh, cfg, job["n_micro"], lr=job["lr"])
    out = {"losses": [], "step_s": []}
    _zero_counts()
    for i in range(job["steps"]):
        _sync(device)
        t0 = time.perf_counter()
        new, loss = step(params, tokens)
        _sync(device)
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(float(loss))
        if i == 0 and job.get("return_delta"):
            delta = map_params(lambda a, b, s: _gathered(unshard(a - b, mesh, s), rank), new,
                               params, pp_param_specs(cfg))
            out["delta"] = unstack_layer_params(delta) if rank == 0 else None
        params = new
    out["launches"] = _counts()
    return out


def ep_full_rank(rank: int, job: dict) -> dict:
    """(f) on one rank: the seeded MoE FlashLM (``job["cfg"]`` with
    ``job["moe"]``) on mesh ``job["mesh"]`` ``(dp, ep, tp, sp)``: with
    ``job["fp32_capacity"]``, the fp32 loss and gradient at that capacity
    (the loss, and on rank 0
    the SGD update ``-lr * grad`` unsharded: taken from the gradient, not
    from the parameters after the step, whose fp32 rounding near a norm
    gain's 1.0 would swamp a 1e-3 comparison), then ``job["steps"]`` SGD
    steps in ``job["dtype"]`` at the config's own capacity (their losses);
    wall seconds and launches of all of them."""
    import dataclasses

    from ..models.moe import (
        AXES,
        MoEConfig,
        init_moe_params,
        make_moe_train_step,
        BATCH_SPEC,
        moe_param_specs,
        moe_value_and_grad,
        shard_moe_params,
    )
    from ..parallel.mesh import shard

    device = torch.device(job["device"])
    base = _config(dict(job["cfg"], dtype="float32"))
    cfg32 = MoEConfig(**{f: getattr(base, f) for f in base.__dataclass_fields__},
                      **dict(job["moe"], capacity_factor=job.get("fp32_capacity") or 1.0))
    mesh = make_mesh(job["mesh"], AXES, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(job["seed"])
    full = init_moe_params(cfg32, gen)
    tokens = torch.randint(0, cfg32.vocab_size, job["batch"], generator=gen, device=device)
    tokens = shard(tokens, mesh, BATCH_SPEC)
    params = shard_moe_params(full, cfg32, mesh)
    del full
    out = {"step_s": []}
    _zero_counts()

    def timed(step, *args):
        _sync(device)
        t0 = time.perf_counter()
        res = step(*args)
        _sync(device)
        out["step_s"].append(time.perf_counter() - t0)
        return res

    if job.get("fp32_capacity") is not None:
        loss, grads = timed(moe_value_and_grad, params, tokens, cfg32, mesh)
        out["fp32_loss"] = float(loss)
        if job.get("return_delta"):
            lr = job["lr"]
            out["delta"] = map_params(lambda g, s: _gathered(unshard(-lr * g, mesh, s), rank),
                                      grads, moe_param_specs(cfg32))
        del grads
    del params
    cfg = dataclasses.replace(cfg32, dtype=getattr(torch, job["dtype"]),
                              capacity_factor=job["moe"]["capacity_factor"])
    gen.manual_seed(job["seed"])
    params = shard_moe_params(init_moe_params(cfg, gen), cfg, mesh)
    step = make_moe_train_step(mesh, cfg, lr=job["lr"])
    out["losses"] = []
    for _ in range(job["steps"]):
        params, loss = timed(step, params, tokens)
        out["losses"].append(float(loss))
    out["launches"] = _counts()
    return out


def dist_rank(rank: int, jobs: dict) -> dict:
    """The distributed parts of ``jobs`` (``attention``, ``train``,
    ``serve``, ``pp``, ``ep``, each optional) in that order on one group,
    so the ranks start and load the kernels once; the card's cached memory
    is released between parts."""
    parts = (("attention", attention_rank), ("train", sharded_train_rank),
             ("serve", serve_full_rank), ("pp", pp_full_rank), ("ep", ep_full_rank))
    out = {}
    for name, fn in parts:
        if name in jobs:
            out[name] = fn(rank, jobs[name])
            if torch.device(jobs[name]["device"]).type == "cuda":
                torch.cuda.empty_cache()
    return out


def dryrun_multichip(n_ranks: int = 8, *, backend: str = "nccl", device="cuda",
                     workdir: Optional[str] = None, log=print) -> dict:
    """The dry run's five checks of ``DRYRUN_CFG`` on ``n_ranks`` ranks, on
    the card by default (``dryrun_job``, every part in one group through
    ``dist_rank``); raises ``AssertionError`` unless every check holds
    (``check_dryrun``).  Returns rank 0's report."""
    jobs = dryrun_job(n_ranks, device)
    rep = spawn(dist_rank, n_ranks, (jobs,), backend=backend, device=device,
                workdir=workdir)[0]
    (loss, loss2), loss_ring = rep["train"]["losses"], rep["train"]["loss_ring"]
    log(f"dryrun on {n_ranks} ranks, mesh (dp, tp, sp) = {jobs['train']['mesh']}, {backend}: "
        f"losses {loss:.6f} -> {loss2:.6f}, ring-sp {loss_ring:.6f}")
    if "serve" in rep:
        serve = rep["serve"]
        equal = {name: serve[name]["streams"] == serve["single"][name]["streams"]
                 for name, _ in DRYRUN_SERVE_MODES}
        log(f"  dp x tp x sp {jobs['serve']['mesh']} decode == one device: {equal}; pp "
            f"{jobs['pp']['mesh']} losses {rep['pp']['losses']}; ep {jobs['ep']['mesh']} losses "
            f"{rep['ep']['losses']}")
    check_dryrun(rep)
    return rep


def dryrun_job(n_ranks: int, device="cuda") -> dict:
    """``dist_rank``'s jobs for the dry run on ``n_ranks``: ``train``, two
    SGD steps of ``DRYRUN_CFG`` on mesh ``mesh_shape(n_ranks)``, global batch
    ``2 dp x 128 sp``; with an even ``n_ranks``, as JAX's, ``serve`` on the
    same mesh (``max_batch 2 dp``, ``max_len 128 sp``, ``DRYRUN_SERVE_MODES``,
    the one-device engines on rank 0), and ``pp`` and ``ep``, two SGD steps
    each on ``(n / 4, 2, 2, 1)`` (or ``(n / 2, 2, 1, 1)``), batch ``4 dp x
    128``: the pipeline with 2 microbatches, the MoE with 4 experts, top-2,
    capacity 2.0."""
    shape = mesh_shape(n_ranks)
    device = str(device)
    jobs = {"train": dict(mesh=shape, cfg=DRYRUN_CFG, batch=(2 * shape[0], 128 * shape[2]),
                          seed=0, lr=1e-2, device=device, sgd_steps=2)}
    if n_ranks % 2 == 0:
        rest = n_ranks // 2
        four = (rest // 2, 2, 2, 1) if rest % 2 == 0 else (rest, 2, 1, 1)
        common = dict(cfg=DRYRUN_CFG, seed=0, lr=1e-2, device=device, batch=(4 * four[0], 128),
                      steps=2)
        jobs.update(
            serve=dict(mesh=shape, cfg=DRYRUN_CFG, seed=0, device=device, draft=DRYRUN_DRAFT,
                       max_batch=2 * shape[0], max_len=128 * shape[2], max_new=4, spec_gamma=2,
                       modes=DRYRUN_SERVE_MODES, prompts=DRYRUN_PROMPTS, check=(), single=True),
            pp=dict(common, mesh=four, n_micro=2),
            ep=dict(common, mesh=four, moe=dict(n_experts=4, top_k=2, capacity_factor=2.0),
                    dtype=DRYRUN_CFG["dtype"], fp32_capacity=None))
    return jobs


def check_dryrun(rep: dict) -> None:
    """The dry run's checks on rank 0's report (``AssertionError``)."""
    train = rep["train"]
    (loss, loss2), loss_ring = train["losses"], train["loss_ring"]
    finite = torch.isfinite(torch.tensor([loss, loss2, loss_ring])).all()
    assert finite, (loss, loss2, loss_ring)
    assert loss2 < loss + 1e-3, f"loss did not improve: {loss} -> {loss2}"
    assert abs(loss_ring - loss) < RING_TOL, (
        f"ring-sp loss diverges from allgather-sp: {loss_ring} vs {loss}")
    if "serve" not in rep:
        return
    serve = rep["serve"]
    for name, _ in DRYRUN_SERVE_MODES:
        assert serve[name]["streams"] == serve["single"][name]["streams"], (
            name, serve["single"][name]["streams"], serve[name]["streams"])
    for part in ("pp", "ep"):
        losses = rep[part]["losses"]
        assert torch.isfinite(torch.tensor(losses)).all(), (part, losses)
        assert losses[1] < losses[0], f"{part} loss did not improve: {losses}"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    try:
        rep = dryrun_multichip(args.ranks, backend=args.backend, device=args.device)
    except AssertionError as e:
        print(f"dryrun failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({part: {k: rep[part][k] for k in ("losses", "loss_ring", "launches")
                             if k in rep[part]} for part in ("train", "pp", "ep") if part in rep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
