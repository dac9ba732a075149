"""The multi-rank dry run: the sharded training step on a dp x tp x sp group.

Counterpart of ``__graft_entry__.dryrun_multichip``'s first two checks
(``MULTICHIP_r05.json``): on a group of ``n`` ranks (8: mesh dp 2 x tp 2 x
sp 2) the sharded SGD step (``models/parallel_train.py``, all-gather
sequence attention) lowers the loss over two steps, and the ring sequence
attention's step gives a loss within 5e-2 of it.  The other three checks
(sharded int8 decode, the pipeline's loss, expert parallelism) wait for
ROADMAP.md, Queue A item 7b.

``sharded_train_rank`` is the rank side, shared with ``chip_smoke.py``'s
full-width run: every rank draws the same parameters and tokens from the
seed, takes its shards, runs the steps and reports its losses, step
times and kernel launches.  One card hosts no two NCCL ranks, so on a
one-card machine the ranks share the card over gloo
(``--backend gloo``): a check of the code path, not a scaling figure.

    python -m flash_attention_metal_tpu_torch.harness.multichip [--ranks 8] [--backend nccl|gloo] [--device cuda|cpu]
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
    """The wrappers of the kernels the sharded step launches, by kernel
    name: the general forward (all-gather attention, dropout), the
    triangular forward (causal ring steps) and the split pair (every
    backward)."""
    return {"flash_fwd": ff.flash_fwd_general, "flash_tri": ft.flash_attention_tri,
            "flash_bwd_dkv": fb.flash_bwd_dkv, "flash_bwd_dq": fb.flash_bwd_dq}


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


def attention_then_train_rank(rank: int, attention_job: dict, train_job: dict) -> dict:
    """``attention_rank`` then ``sharded_train_rank`` in one group, so the
    second run finds the ranks started and their kernels loaded:
    ``{"attention": ..., "train": ...}``."""
    return {"attention": attention_rank(rank, attention_job),
            "train": sharded_train_rank(rank, train_job)}


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


def dryrun_multichip(n_ranks: int = 8, *, backend: str = "nccl", device="cuda",
                     workdir: Optional[str] = None, log=print) -> dict:
    """Two sharded SGD steps and one ring step of ``DRYRUN_CFG`` on
    ``n_ranks`` ranks (mesh ``mesh_shape(n_ranks)``, global batch ``2 dp x
    128 sp``), on the card by default; raises ``AssertionError`` unless the
    losses are finite, the second is below the first (by 1e-3 at most
    above it, as the JAX check allows), and the ring loss is within
    ``RING_TOL`` of the all-gather loss.  Returns rank 0's report."""
    job = dryrun_job(n_ranks, device)
    rep = spawn(sharded_train_rank, n_ranks, (job,), backend=backend, device=device,
                workdir=workdir)[0]
    (loss, loss2), loss_ring = rep["losses"], rep["loss_ring"]
    log(f"dryrun on {n_ranks} ranks, mesh (dp, tp, sp) = {job['mesh']}, {backend}: losses "
        f"{loss:.6f} -> {loss2:.6f}, ring-sp {loss_ring:.6f}")
    check_dryrun(rep)
    return rep


def dryrun_job(n_ranks: int, device="cuda") -> dict:
    """``sharded_train_rank``'s job for the dry run on ``n_ranks``: two SGD
    steps of ``DRYRUN_CFG`` on mesh ``mesh_shape(n_ranks)``, global batch
    ``2 dp x 128 sp``."""
    shape = mesh_shape(n_ranks)
    return dict(mesh=shape, cfg=DRYRUN_CFG, batch=(2 * shape[0], 128 * shape[2]), seed=0,
                lr=1e-2, device=str(device), sgd_steps=2)


def check_dryrun(rep: dict) -> None:
    """The dry run's checks on rank 0's report (``AssertionError``)."""
    (loss, loss2), loss_ring = rep["losses"], rep["loss_ring"]
    finite = torch.isfinite(torch.tensor([loss, loss2, loss_ring])).all()
    assert finite, (loss, loss2, loss_ring)
    assert loss2 < loss + 1e-3, f"loss did not improve: {loss} -> {loss2}"
    assert abs(loss_ring - loss) < RING_TOL, (
        f"ring-sp loss diverges from allgather-sp: {loss_ring} vs {loss}")


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
    print(json.dumps({k: rep[k] for k in ("losses", "loss_ring", "launches")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
