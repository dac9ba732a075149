#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``flash_attention_metal_tpu_torch/csrc``
(one ``nvcc`` per source, in parallel) and drives its three paths: serving
and training at the widest FlashLM width the repo records
(``train_bench.json``: d_model 2048, 8 layers, 16/8 heads, d_ff 4096,
vocab 32768) with seeded random weights, and the kernel ladder:

* serving: the forward kernel against its plain version at the serving
  shapes, 16 requests through ``DecodeEngine``, served logits against a
  plain fp32 forward, kernel/prefill/decode times;
* the 8-bit and paged KV caches: the quant, paged and paged-quant kernels
  (``csrc/flash_fwd.cu``) against their plain versions at the serving
  shapes (int8 and e4m3, bf16 pools, fp32 q at one shape; shuffled page
  tables), then 16 requests through one engine per mode (``kv_quant``
  int8 and fp8, ``paged``, ``paged`` with ``prefix_share`` on prompts
  sharing their first half, ``paged`` int8), each with its kernel launched
  in prefill and decode and the dense kernel never, and its served logits
  within the mode's bound;
* training: the dK/dV and dQ kernels against their plain versions at the
  training shape, each parameter's gradient at depth 2 against the fp32
  oracle attention, 6 ``Trainer`` steps at batch 4, seq 2048 with the
  kernels' launch counts, step time, tokens/s and MFU;
* the kernel ladder: the naive, lean and triangular forward kernels and
  the triangular backward against their plain versions at the benchmark's
  and the verification ladder's shapes, the port's verification ladder at
  n = 1024 (every ported rung must pass) and a short benchmark (N = 128,
  1024, 4096 and the high-occupancy phase), with each kernel's launches
  over these two runs.  The full sweep is its own command:
  ``python -m flash_attention_metal_tpu_torch.bench``;
* the tuned backward: the fused backward kernel against its plain version
  at the training and high-occupancy shapes, the autotuner's race of the
  split pair, the fused and the triangular kernel at both, then the
  depth-2 gradient check and 2 ``Trainer`` steps under a saved decision
  naming the fused kernel (launched there, the split pair never);
* the reference benchmark's CSV sweep: both V1 kernels (streaming and
  folded) against their plain version in fp32, and ``run_sweep`` at N =
  128 and 1024, each point launching its V1 kernel.

Every phase but the tuned one runs with the backward router's cache
pointed at an empty temporary directory (the untuned rule).

Each phase prints its lines; any failure exits non-zero before the result
lines.  The last three lines are the card (``nvidia-smi``'s name and power
limit), the kernels' JSON record (each kernel's errors, launches, device
time, plain version's time, roofline bound and the library call's time)
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

MAX_BATCH, MAX_LEN = 8, 2048
N_REQUESTS, PROMPT_LENS, MAX_NEW = 16, (64, 1000), 64
SEED = 0
# Training: full width; the gradient check at depth 2, batch 1.
TRAIN_STEPS, GRAD_CHECK_LAYERS = 6, 2
# Largest relative L2 error of one parameter's gradient with the kernels'
# attention against the fp32 oracle attention (bf16 compute both ways).
GRAD_REL_L2_TOL = 5e-2
# Prompts of the served-logits check: a short pair (one KV tile; a cache
# position too few or too many moves these logits most) and a long pair
# (multi-tile prefill with padded rows, decode past 64 columns).
CHECK_PROMPTS = (5, 11, 300, 900)
# The benchmark's sweep, cut to three points here (the full sweep is its
# own command), and the verification ladder's length.
SHORT_SWEEP, LADDER_N = (128, 1024, 4096), 1024
# The 8-bit and paged KV caches: the serving modes, one engine each, in
# order; the prefix-shared mode's traffic (1024-token prompts whose first
# half is common, the JAX serving bench's shared_prefix = prompt_len // 2)
# and its served-logits prompts (the common 512 tokens and tails).
KV_MODES = ("int8", "fp8", "paged", "paged_prefix_shared", "paged_int8")
PREFIX_PROMPT, PREFIX_SHARED = 1024, 512
PREFIX_CHECK_PROMPTS = (600, 700, 1000, 1024)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def leaf_names(tree, prefix="") -> list:
    """Names of a parameter tree's leaves, in ``param_leaves`` order."""
    if isinstance(tree, dict):
        return [n for key in sorted(tree) for n in leaf_names(tree[key], f"{prefix}{key}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, item in enumerate(tree) for n in leaf_names(item, f"{prefix}{i}.")]
    return [prefix[:-1]]


def kv_cache_phase(gen: torch.Generator, stamp: str, spec) -> dict:
    """The 8-bit and paged KV caches' path: the quant, paged and paged-quant
    kernels of ``csrc/flash_fwd.cu`` against their plain versions at the
    serving path's shapes; 16 requests through one engine per mode of
    ``KV_MODES`` with each mode's kernel launched in prefill and decode and
    the dense kernel never; each mode's served logits against the plain
    fp32 forward; the kernels' times and bounds.  Returns the three kernel
    records and each mode's serving numbers."""
    from flash_attention_metal_tpu_torch.harness import onchip, serving
    from flash_attention_metal_tpu_torch.kernels import paged as pg
    from flash_attention_metal_tpu_torch.kernels import quant as qt
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import flash_fwd_general
    from flash_attention_metal_tpu_torch.utils import roofline

    # Kernels against their plain versions on the same 8-bit or paged data.
    cases = onchip.kv_cases(gen)
    errors = {}
    for name, (kernel, args, pos_div) in cases.items():
        err, lse_err = onchip.kv_kernel_error(kernel, args, pos_div)
        tol = onchip.TOL[args[0].dtype]
        errors[name] = (kernel, args[0].dtype, err)
        check(err <= tol and lse_err <= tol,
              f"{name}: max abs err {err:.3e}, lse {lse_err:.3e} > {tol}")
        print(f"[kv-kernel] {name} ({kernel}) q {tuple(args[0].shape)} pos_div {pos_div}: "
              f"max_abs_err {err:.3e} lse_err {lse_err:.3e} (tol {tol})")

    counters = {"flash_quant": qt.flash_attention_quant, "flash_paged": pg.flash_attention_paged,
                "flash_paged_quant": pg.flash_attention_paged_quant}
    mode_kernel = {"int8": "flash_quant", "fp8": "flash_quant", "paged": "flash_paged",
                   "paged_prefix_shared": "flash_paged", "paged_int8": "flash_paged_quant"}
    launches = dict.fromkeys(counters, 0)
    serving_out = {}
    vocab = serving.FLASHLM_D2048["vocab"]
    prng = np.random.default_rng(SEED + 1)
    check_prompts = [prng.integers(1, vocab, n).tolist() for n in CHECK_PROMPTS]
    common = prng.integers(1, vocab, PREFIX_SHARED).tolist()
    prefix_prompts = [common + prng.integers(1, vocab, n - PREFIX_SHARED).tolist()
                      for n in PREFIX_CHECK_PROMPTS]
    for mode in KV_MODES:
        options, tol = serving.SERVING_MODES[mode]
        eng, cfg = serving.build_engine(
            **serving.FLASHLM_D2048, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=SEED,
            device="cuda", **options,
        )
        eng.submit(serving.Request(uid=-1, prompt=list(range(1, 101)), max_new_tokens=4))
        eng.run()
        counter = counters[mode_kernel[mode]]
        in_prefill = [0]
        prefill = eng.prefill_request

        def counted_prefill(*args):
            before = counter.launches
            out = prefill(*args)
            in_prefill[0] += counter.launches - before
            return out

        eng.prefill_request = counted_prefill
        if mode == "paged_prefix_shared":
            requests = serving.make_requests(N_REQUESTS, cfg.vocab_size, (PREFIX_PROMPT,) * 2,
                                             MAX_NEW, SEED, shared_prefix=PREFIX_SHARED)
        else:
            requests = serving.make_requests(N_REQUESTS, cfg.vocab_size, PROMPT_LENS, MAX_NEW, SEED)
        for fn in (*counters.values(), flash_fwd_general):
            fn.launches = 0
        bench = serving.run_serving_bench(eng, requests, mode=mode, log=lambda s: None)
        total = counter.launches
        dense = flash_fwd_general.launches
        in_decode = total - in_prefill[0]
        adopted = bench["pages_adopted"]
        launches[mode_kernel[mode]] += total
        check(all(r.done and len(r.generated) == MAX_NEW for r in requests),
              f"{mode}: every request finishes with max_new tokens")
        check(all(0 <= t < cfg.vocab_size for r in requests for t in r.generated),
              f"{mode}: tokens in vocabulary")
        check(all(np.isfinite(lp) and lp <= 0 for r in requests for lp in r.logprobs),
              f"{mode}: log-probabilities finite and <= 0")
        check(in_prefill[0] > 0 and in_decode > 0 and dense == 0,
              f"{mode}: {mode_kernel[mode]} launched in prefill ({in_prefill[0]}) and decode "
              f"({in_decode}), the dense kernel never ({dense})")
        if mode == "paged_prefix_shared":
            check(adopted > 0, f"{mode}: shared pages adopted ({adopted})")
        prompts = prefix_prompts if mode == "paged_prefix_shared" else check_prompts
        rel = serving.teacher_forced_errors(eng.params, cfg, prompts, 16, MAX_LEN, seed=SEED,
                                            mode=mode)
        worst = float(np.max(rel))
        check(worst <= tol, f"{mode}: served logits rel L2 {worst:.3e} > {tol}")
        serving_out[mode] = {
            "tokens_per_s": bench["tokens_per_s"], "ms_per_step": bench["ms_per_step"],
            "decode_steps": bench["decode_steps"], "kernel": mode_kernel[mode],
            "launches_prefill": in_prefill[0], "launches_decode": in_decode,
            "pages_adopted": adopted, "served_logits_rel_l2_max": worst,
            "served_logits_tol": tol,
        }
        print(f"[kv-serve] {mode}: {N_REQUESTS} requests x {MAX_NEW} tokens, prompts "
              f"{min(len(r.prompt) for r in requests)}-{max(len(r.prompt) for r in requests)}: "
              f"{bench['tokens_per_s']:.1f} tok/s, {bench['ms_per_step']:.3f} ms/step over "
              f"{bench['decode_steps']} steps; {mode_kernel[mode]} launches prefill "
              f"{in_prefill[0]} decode {in_decode}, dense kernel {dense}, pages adopted "
              f"{adopted}; served logits rel L2 max {worst:.3e} (tol {tol}) {stamp}")
        del eng, requests
        torch.cuda.empty_cache()

    # Times at the decode case (most of the path's launches) and the prefill
    # case, each beside its plain version and its roofline bound.  No PyTorch
    # call attends over an 8-bit or paged cache; SDPA on a dense bf16 cache
    # of the same shape (a different function) is timed beside them.
    def timed(case):
        kernel, args, pos_div = cases[case]
        wrapper, plain = onchip.KV_KERNELS[kernel]
        flops, nbytes = onchip.kv_work(kernel, args, pos_div)
        bits = 32 if args[0].dtype == torch.float32 else 16
        return {
            "ms": onchip.device_ms(lambda: wrapper(*args, pos_div)),
            "plain_ms": onchip.device_ms(lambda: plain(*args, pos_div), iters=5),
            "bound_ms": roofline.roofline_time(flops, nbytes, spec, bits) * 1e3,
            "bound_by": roofline.bound_by(flops, nbytes, spec, bits),
        }

    lengths = torch.from_numpy(onchip.decode_lengths()).to("cuda")
    qd, kd, vd = onchip.ladder_inputs((8, 16, 1, 64), onchip.DECODE_KV, torch.bfloat16, gen)
    cols = torch.arange(onchip.DECODE_KV[2], device="cuda")
    sdpa_decode = onchip.sdpa_ms(qd, kd, vd, mask=(cols <= lengths[:, None])[:, None, None, :])
    qp, kp, vp = onchip.ladder_inputs(onchip.PREFILL_Q, onchip.PREFILL_KV, torch.bfloat16, gen)
    n_qp, n_kvp = onchip.PREFILL_Q[2], onchip.PREFILL_KV[2]
    sdpa_prefill = onchip.sdpa_ms(qp, kp, vp, mask=(
        torch.arange(n_kvp, device="cuda")[None, :] <= torch.arange(n_qp, device="cuda")[:, None] + 512))
    del qd, kd, vd, qp, kp, vp
    records = []
    for kernel, tag, line in (
        ("flash_quant", "quant_{}", "quant.py:119"),
        ("flash_paged", "paged", "paged.py:70"),
        ("flash_paged_quant", "paged_quant_{}", "paged.py:224"),
    ):
        main = tag.format("int8")
        rec = {
            "name": kernel,
            "route": "cuda",
            "source": "flash_attention_metal_tpu_torch/csrc/flash_fwd.cu",
            "replaces": f"flash_attention_metal_tpu/kernels/{line}",
            "launches": launches[kernel],
            "max_abs_err": max(e for k_, d_, e in errors.values()
                               if k_ == kernel and d_ == torch.bfloat16),
            "max_abs_err_fp32": max(e for k_, d_, e in errors.values()
                                    if k_ == kernel and d_ == torch.float32),
            **timed(f"{main}_decode_bf16"),
            "library_ms": None,
            "library_note": "no PyTorch call attends over an 8-bit or paged cache",
            "sdpa_dense_bf16_ms": sdpa_decode[0],
            "sdpa_dense_bf16_backend": sdpa_decode[1] + " (dense bf16 cache, another function)",
            "shape": "decode q [8,8,2,64] pos_div 2 over [8,8,2048,64] at onchip.decode_lengths()"
                     + ("" if kernel == "flash_paged" else ", int8"),
        }
        rec.update({f"prefill_{key}": val
                    for key, val in timed(f"{main}_prefill_bf16").items()})
        rec["prefill_sdpa_dense_bf16_ms"] = sdpa_prefill[0]
        if kernel != "flash_paged":
            rec["ms_e4m3"] = timed(f"{tag.format('e4m3')}_decode_bf16")["ms"]
        records.append(rec)
        print(f"[time] kernel {kernel} at {rec['shape']}: device {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
              f"SDPA on a dense bf16 cache {rec['sdpa_dense_bf16_ms']:.4f} ms; prefill q "
              f"[1,16,512,64] offset 512: device {rec['prefill_ms']:.4f} ms, plain "
              f"{rec['prefill_plain_ms']:.4f} ms, bound {rec['prefill_bound_ms']:.4f} ms "
              f"({rec['prefill_bound_by']}), SDPA dense {sdpa_prefill[0]:.4f} ms {stamp}")
    del cases
    torch.cuda.empty_cache()
    return {"records": records, "serving": serving_out, "sdpa_decode": sdpa_decode}


def grad_check(gen: torch.Generator) -> dict:
    """Every parameter's gradient at full width, depth 2, batch 1, seq
    2048, with the kernels' attention against the fp32 oracle attention
    (bf16 compute both ways); fails above ``GRAD_REL_L2_TOL``."""
    from flash_attention_metal_tpu_torch.harness import train_bench
    from flash_attention_metal_tpu_torch.models import transformer as tf

    gcfg = train_bench.flashlm_config(n_layers=GRAD_CHECK_LAYERS)
    gen.manual_seed(SEED)
    gparams = tf.init_params(gcfg, gen, master_dtype=torch.float32)
    gtokens = train_bench.fixed_batch(gcfg, 1, 2048, SEED + 2)
    loss_k, grads_k = tf.value_and_grad(tf.loss_fn, gparams, gtokens, gcfg)
    loss_r, grads_r = tf.value_and_grad(
        tf.loss_fn, gparams, gtokens, dataclasses.replace(gcfg, attn_impl="reference"))
    names = leaf_names(gparams)
    rels = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
            for a, b in zip(tf.param_leaves(grads_k), tf.param_leaves(grads_r))]
    worst_i = int(np.argmax(rels))
    check(all(np.isfinite(rels)) and rels[worst_i] <= GRAD_REL_L2_TOL,
          f"gradient {names[worst_i]} rel L2 {rels[worst_i]:.3e} > {GRAD_REL_L2_TOL}")
    return {"loss": float(loss_k), "loss_ref": float(loss_r), "n": len(rels),
            "worst": rels[worst_i], "worst_name": names[worst_i],
            "median": float(np.median(rels))}


def grad_line(g: dict) -> str:
    return (f"L{GRAD_CHECK_LAYERS} d2048 b1 s2048: loss {g['loss']:.5f} vs {g['loss_ref']:.5f}; "
            f"{g['n']} gradients, rel L2 max {g['worst']:.3e} ({g['worst_name']}), median "
            f"{g['median']:.3e} (tol {GRAD_REL_L2_TOL})")


def timed_record(kernel_fn, plain_fn, library, flops, nbytes, bits, shape, spec) -> dict:
    """A kernel's device ms beside its plain version's, the library call's
    (``(ms, backend)``) and its roofline bound at one shape of its path."""
    from flash_attention_metal_tpu_torch.harness import onchip
    from flash_attention_metal_tpu_torch.utils import roofline

    return {
        "ms": onchip.device_ms(kernel_fn),
        "plain_ms": onchip.device_ms(plain_fn, iters=5),
        "library_ms": library[0],
        "library_backend": library[1],
        "bound_ms": roofline.roofline_time(flops, nbytes, spec, bits) * 1e3,
        "bound_by": roofline.bound_by(flops, nbytes, spec, bits),
        "shape": shape,
    }


def v1_phase(gen: torch.Generator, stamp: str, spec, kernels: dict) -> list:
    """FlashAttention V1 (``csrc/flash_v1.cu``) and the reference benchmark's
    sweep: both kernels against their plain version in fp32 (ladder, peaked
    and spike fixtures; ``onchip.v1_cases``); ``run_sweep`` at N = 128 (the
    folded kernel) and 1024 (the streaming one), one point at a time with
    every count reset before it and read after it; each kernel's times.
    Returns the two kernel records."""
    from flash_attention_metal_tpu_torch.harness import benchmark, onchip
    from flash_attention_metal_tpu_torch.kernels import flash_v1 as fv

    tol = onchip.TOL[torch.float32]
    errors = {}
    for name, (kernel, qkv, causal) in onchip.v1_cases(gen).items():
        err = onchip.v1_error(qkv, causal)
        errors[name] = (kernel, err)
        check(err <= tol, f"{name}: max abs err {err:.3e} > {tol}")
        print(f"[v1-kernel] {name} ({kernel}) q {tuple(qkv[0].shape)} causal {causal}: "
              f"max_abs_err {err:.3e} (tol {tol})")

    print(f"[sweep] {benchmark.CSV_HEADER}")
    sweep_launches = dict.fromkeys(kernels, 0)
    for n, ran, idle in ((128, "flash_v1_folded", "flash_v1"), (1024, "flash_v1", "flash_v1_folded")):
        for fn in kernels.values():
            fn.launches = 0
        (row,) = benchmark.run_sweep((n,), iters=5, repeats=2,
                                     log=lambda line: print(f"[sweep] {line}"))
        counts = {name: fn.launches for name, fn in kernels.items()}
        check(counts[ran] > 0 and counts[idle] == 0,
              f"sweep N={n}: {ran} launched ({counts[ran]}), {idle} not ({counts[idle]})")
        check(all(x is not None and np.isfinite(x) and x > 0 for x in (
            row.naive_ms, row.v1_ms, row.v2_ms, row.mxu_ms, row.mxu_causal_ms,
            row.speedup_v1, row.speedup_v2, row.speedup_mxu)),
            f"sweep N={n}: every time and speedup measured: {row.csv()}")
        print(f"[sweep] N={n} B={row.b}: launches {counts} {stamp}")
        for name in kernels:
            sweep_launches[name] += counts[name]

    records = []
    for name, shape, line in (("flash_v1", onchip.SWEEP_1024, 40),
                              ("flash_v1_folded", onchip.SWEEP_128, 136)):
        q, k, v = onchip.ladder_inputs(shape, shape, torch.float32, gen)
        check(onchip.v1_kernel(shape) == name, f"{name} takes the sweep's shape {shape}")
        b, h, n, d = shape
        rec = {
            "name": name,
            "route": "cuda",
            "source": "flash_attention_metal_tpu_torch/csrc/flash_v1.cu",
            "replaces": f"flash_attention_metal_tpu/kernels/flash_v1.py:{line}",
            "launches": sweep_launches[name],
            "max_abs_err": max(e for k_, e in errors.values() if k_ == name),
            **timed_record(
                lambda: fv.flash_attention_v1(q, k, v),
                lambda: fv.flash_attention_v1_plain(q, k, v, sm_scale=0.125, causal=False),
                onchip.sdpa_ms(q, k, v), 4.0 * d * b * h * n * n, 4.0 * q.numel() * 4, 32,
                f"sweep N={n} B={b} H=1 fp32 non-causal", spec),
        }
        records.append(rec)
        print(f"[time] kernel {name} at {rec['shape']}: device {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms "
              f"({rec['library_backend']}), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
              f"launches over the sweep {rec['launches']} {stamp}")
        del q, k, v
    torch.cuda.empty_cache()
    return records


def fused_phase(gen: torch.Generator, stamp: str, spec, tmp: str) -> dict:
    """The tuned backward: the fused kernel (``csrc/flash_bwd.cu``,
    ``fam_flash_bwd_fused``) against its plain version at the training
    shape (bf16 ladder and peaked fixtures, fp32 at N = 512) and at high
    occupancy; ``autotune_bwd`` racing split, fused and tri at both shapes
    into a cache under ``tmp``; then a cache naming "fused" for the
    training shapes, under which the depth-2 gradient check and 2
    full-width ``Trainer`` steps run with the fused kernel launched and the
    split pair never.  Returns the kernel record and the tuned run's
    numbers."""
    from flash_attention_metal_tpu_torch.harness import autotune, onchip, train_bench
    from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
    from flash_attention_metal_tpu_torch.utils import roofline

    errors = {}
    cases = onchip.train_cases(gen)
    inputs = {name: onchip.bwd_inputs(case) for name, case in cases.items()}
    del cases
    inputs["high_occupancy_bf16"] = onchip.high_occupancy_bwd_inputs(gen)
    for name, args in inputs.items():
        errs = onchip.bwd_kernel_errors(args, fused=True)
        tol = onchip.BWD_TOL[args[0].dtype]
        errors[name] = errs
        worst_rel = max(rel for _, rel in errs.values())
        check(worst_rel <= tol, f"fused {name}: backward normalised error {worst_rel:.3e} > {tol}")
        print(f"[fused-kernel] {name} q {tuple(args[0].shape)} kv {tuple(args[1].shape)}: "
              + ", ".join(f"{g} max_abs {a:.3e} rel {r:.3e}" for g, (a, r) in errs.items())
              + f" (tol rel {tol})")
    del inputs["high_occupancy_bf16"], inputs["train_bf16_peaked"], inputs["train_fp32_n512"]
    torch.cuda.empty_cache()

    # The autotuner's race at the high-occupancy and the training shape.
    race_path = os.path.join(tmp, "race.json")
    raced = {}
    for shape in autotune.TRAIN_SHAPES:
        impl, blocks = autotune.autotune_bwd(
            shape, cache_path=race_path, iters=5, log=lambda s: print(f"[autotune] {s} {stamp}"))
        raced[str(shape)] = {"impl": impl, "blocks": blocks}
        print(f"[autotune] {shape} bf16 causal: {impl} {blocks} wins {stamp}")

    # The training run under a cache naming "fused" for its two attention
    # shapes (the gradient check's batch 1, the Trainer's batch 4).
    tuned = os.path.join(tmp, "fused.json")
    b_, h_, n_, d_ = onchip.TRAIN_Q
    h_kv = onchip.TRAIN_KV[1]
    for batch in (1, b_):
        autotune.record_bwd((batch, h_, h_kv, n_, d_), "fused", {}, cache_path=tuned)
    default_cache = autotune.DEFAULT_CACHE
    autotune.DEFAULT_CACHE = tuned
    autotune.reset_memo()
    counters = {"fused": fb.flash_bwd_fused, "dkv": fb.flash_bwd_dkv, "dq": fb.flash_bwd_dq}
    for fn in counters.values():
        fn.launches = 0
    g = grad_check(gen)
    train = train_bench.run_train_bench(steps=2, log=lambda s: None)
    launches = {name: fn.launches for name, fn in counters.items()}
    autotune.DEFAULT_CACHE = default_cache
    autotune.reset_memo()
    layers = train["model"]["n_layers"]
    want = {"fused": GRAD_CHECK_LAYERS + 2 * layers, "dkv": 0, "dq": 0}
    check(all(np.isfinite(train["losses"])), f"tuned training losses finite: {train['losses']}")
    check(launches == want, f"tuned backward launches {launches} == {want}")
    print(f"[grad-check] fused backward: {grad_line(g)}")
    print(f"[train-fused] 2 Trainer steps, L{layers} d2048 b4 s2048 under a cache naming "
          f"\"fused\": losses " + ", ".join(f"{x:.4f}" for x in train["losses"])
          + f"; launches fused {launches['fused']}, dK/dV {launches['dkv']}, dQ {launches['dq']} "
          f"(grad check and steps); step {train['step_ms']:.2f} ms {stamp}")

    # Device time and the dQ workspace at the training shape, as the op
    # calls the kernel there (its int offset 0 bounds the workspace).
    q, k, v, o, do, lse, off = inputs["train_bf16"]
    batch, heads, n_q, head_dim = q.shape
    flops, nbytes = roofline.fused_bwd_work(batch, heads, k.shape[1], n_q, k.shape[2], head_dim,
                                            2, causal=True)
    ws_alloc, ws_written = onchip.fused_workspace_bytes(inputs["train_bf16"], 0)
    check(ws_alloc == ws_written > 0,
          f"fused dQ workspace: {ws_alloc} bytes allocated, {ws_written} written: the packed "
          "layout holds exactly the visible pairs")
    kw = dict(sm_scale=0.125, causal=True)
    rec = {
        "name": "flash_bwd_fused",
        "route": "cuda",
        "source": "flash_attention_metal_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "flash_attention_metal_tpu/kernels/flash_bwd.py:520",
        "launches": launches["fused"],
        "max_abs_err": max(e[gr][0] for n, e in errors.items() if "bf16" in n for gr in e),
        "max_rel_err": max(e[gr][1] for n, e in errors.items() if "bf16" in n for gr in e),
        "max_rel_err_fp32": max(r for _, r in errors["train_fp32_n512"].values()),
        **timed_record(
            lambda: fb.flash_attention_bwd_fused(q, k, v, o, do, lse, off, q_offset_max=0,
                                                 **kw),
            lambda: fb.flash_attention_bwd_fused_plain(q, k, v, o, do, lse, off, **kw),
            onchip.sdpa_ms(q, k, v, causal=True, backward_of=do), flops, nbytes, 16,
            "training q [4,16,2048,64] kv [4,8,2048,64] bf16 causal", spec),
        "workspace_bytes_allocated": ws_alloc,
        "workspace_bytes_written": ws_written,
        "race": raced,
    }
    rec["library_backend"] += " backward (dQ, dK, dV together)"
    print(f"[time] kernel flash_bwd_fused at {rec['shape']}: device {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms "
          f"({rec['library_backend']}), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
          f"dQ workspace {ws_alloc} bytes allocated, {ws_written} bytes of slots written "
          f"(allocator peak; NaN-filled slots overwritten) {stamp}")
    del inputs, q, k, v, o, do, lse
    torch.cuda.empty_cache()
    return {"record": rec, "grad_rel_l2_max": g["worst"], "losses": train["losses"],
            "step_ms": train["step_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from flash_attention_metal_tpu_torch import bench as bench_mod
    from flash_attention_metal_tpu_torch.harness import autotune, onchip, serving, train_bench
    from flash_attention_metal_tpu_torch.harness.verify import RUNGS_2_8_9_12_18, run_ladder
    from flash_attention_metal_tpu_torch.kernels import _build
    from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
    from flash_attention_metal_tpu_torch.kernels import flash_tri as ft
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import (
        flash_attention_fwd,
        flash_attention_fwd_plain,
        flash_fwd_general,
        flash_fwd_lean,
        flash_fwd_lean_plain,
    )
    from flash_attention_metal_tpu_torch.kernels.naive import (
        naive_attention,
        naive_attention_plain,
    )
    from flash_attention_metal_tpu_torch.runtime import engine as engine_mod
    from flash_attention_metal_tpu_torch.utils import roofline

    # 1. Device.  The references run in true fp32, never TF32.
    smi = serving.nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    print(smi)

    # 2. Build.
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")
    spec = roofline.detect_chip()
    # The backward router reads the autotuner's saved decisions from
    # autotune.DEFAULT_CACHE when that file exists.  Point it at an empty
    # scratch directory, so every phase but the tuned one runs the untuned
    # rule whatever the working directory holds.
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    autotune.DEFAULT_CACHE = os.path.join(tmp, "autotune_cache_torch.json")
    autotune.reset_memo()

    # 3. Kernel against its plain version at the path's shapes.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = onchip.path_cases(gen)
    errors = {}
    for name, case in cases.items():
        err, lse_err = onchip.kernel_error(case)
        tol = onchip.TOL[case[0].dtype]
        errors[name] = err
        check(err <= tol and lse_err <= tol,
              f"{name}: max abs err {err:.3e}, lse {lse_err:.3e} > {tol}")
        print(f"[kernel] {name}: max_abs_err {err:.3e} lse_err {lse_err:.3e} (tol {tol})")

    # 4. Serve.  Warm up with one request, then count launches over the
    # main run only, and those inside prefill separately.
    eng, cfg = serving.build_engine(
        **serving.FLASHLM_D2048, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=SEED,
        device="cuda",
    )
    eng.submit(serving.Request(uid=-1, prompt=list(range(1, 101)), max_new_tokens=4))
    eng.run()
    prefill_launches = [0]
    prefill_slot = engine_mod.prefill_slot

    def counted_prefill(*args, **kwargs):
        before = flash_fwd_general.launches
        out = prefill_slot(*args, **kwargs)
        prefill_launches[0] += flash_fwd_general.launches - before
        return out

    engine_mod.prefill_slot = counted_prefill
    requests = serving.make_requests(N_REQUESTS, cfg.vocab_size, PROMPT_LENS, MAX_NEW, SEED)
    flash_fwd_general.launches = 0
    bench = serving.run_serving_bench(eng, requests, log=lambda s: None)
    launches = flash_fwd_general.launches
    engine_mod.prefill_slot = prefill_slot
    decode_launches = launches - prefill_launches[0]
    check(all(r.done and len(r.generated) == MAX_NEW for r in requests),
          "every request finishes with max_new tokens")
    check(all(0 <= t < cfg.vocab_size for r in requests for t in r.generated),
          "tokens in vocabulary")
    check(all(np.isfinite(lp) and lp <= 0 for r in requests for lp in r.logprobs),
          "log-probabilities finite and <= 0")
    check(prefill_launches[0] > 0 and decode_launches > 0,
          f"kernel launched in prefill ({prefill_launches[0]}) and decode ({decode_launches})")
    print(f"[serve] {N_REQUESTS} requests x {MAX_NEW} tokens, prompts "
          f"{min(len(r.prompt) for r in requests)}-{max(len(r.prompt) for r in requests)}: "
          f"{bench['tokens_per_s']:.1f} tok/s, {bench['ms_per_step']:.3f} ms/step over "
          f"{bench['decode_steps']} steps; kernel launches prefill {prefill_launches[0]} "
          f"decode {decode_launches}")

    # 5. Served path against the plain fp32 forward, teacher-forced.
    prng = np.random.default_rng(SEED + 1)
    prompts = [prng.integers(1, cfg.vocab_size, n).tolist() for n in CHECK_PROMPTS]
    n_decode = 16
    rel = serving.teacher_forced_errors(eng.params, cfg, prompts, n_decode, MAX_LEN, seed=SEED)
    per_prompt = np.asarray(rel).reshape(len(prompts), n_decode + 1).max(axis=1)
    worst = float(per_prompt.max())
    check(worst <= serving.LOGITS_REL_L2_TOL,
          f"served logits rel L2 {worst:.3e} > {serving.LOGITS_REL_L2_TOL}")
    print(f"[served-logits] {len(rel)} steps, rel L2 max {worst:.3e} median "
          f"{float(np.median(rel)):.3e}; max by prompt length "
          + ", ".join(f"{n}: {e:.3e}" for n, e in zip(CHECK_PROMPTS, per_prompt))
          + f" (tol {serving.LOGITS_REL_L2_TOL})")

    # 6. Timing, every line stamped with the card.
    stamp = f"({smi})"
    timings = {}
    for name in ("prefill_bf16_off512", "decode_bf16"):
        q, k, v, off, pos_div = cases[name]
        ms = onchip.device_ms(
            lambda: flash_attention_fwd(q, k, v, off, causal=True, pos_div=pos_div))
        plain_ms = onchip.device_ms(lambda: flash_attention_fwd_plain(
            q, k, v, off, sm_scale=0.125, causal=True, pos_div=pos_div))
        timings[name] = (ms, plain_ms)
        print(f"[time] kernel {name} {tuple(q.shape)} x kv {tuple(k.shape)}: device "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms {stamp}")

    prefill_ms = onchip.wall_ms(onchip.prefill_request(eng, 512), iters=5)
    print(f"[time] prefill of a 512-token prompt: {prefill_ms:.3f} ms/request (wall) {stamp}")

    # Steady decode with all slots busy at the decode case's lengths.
    step_ms = onchip.wall_ms(onchip.steady_decode(eng, cases["decode_bf16"][3]))
    attn_share = cfg.n_layers * timings["decode_bf16"][0] / step_ms
    print(f"[time] decode step, batch {MAX_BATCH}: {step_ms:.3f} ms/step (wall), "
          f"{MAX_BATCH * 1e3 / step_ms:.1f} tok/s; {cfg.n_layers} x the decode kernel's "
          f"device time is {attn_share:.1%} of it {stamp}")

    # 6b. The 8-bit and paged KV caches: their three kernels, five engines.
    del eng
    torch.cuda.empty_cache()
    kv = kv_cache_phase(gen, stamp, spec)

    # 7. Backward kernels against their plain versions at the training
    # shape (bf16 ladder and peaked fixtures, fp32 at N = 512).
    train_cases = onchip.train_cases(gen)
    bwd_errors = {}
    for name, case in train_cases.items():
        errs = onchip.bwd_kernel_errors(onchip.bwd_inputs(case))
        tol = onchip.BWD_TOL[case[0].dtype]
        bwd_errors[name] = errs
        worst_rel = max(rel for _, rel in errs.values())
        check(worst_rel <= tol, f"{name}: backward normalised error {worst_rel:.3e} > {tol}")
        print(f"[bwd-kernel] {name} q {tuple(case[0].shape)} kv {tuple(case[1].shape)}: "
              + ", ".join(f"{g} max_abs {a:.3e} rel {r:.3e}" for g, (a, r) in errs.items())
              + f" (tol rel {tol})")

    # 8. Gradients at full width, depth 2, batch 1: kernel attention
    # against the fp32 oracle attention, every parameter.
    grads = grad_check(gen)
    print(f"[grad-check] {grad_line(grads)}")

    # 9. Train: Trainer.step at the full width, counts over these steps only.
    flash_fwd_general.launches = fb.flash_bwd_dkv.launches = fb.flash_bwd_dq.launches = 0
    train = train_bench.run_train_bench(steps=TRAIN_STEPS, log=lambda s: None)
    train_launches = {
        "fwd": flash_fwd_general.launches,
        "dkv": fb.flash_bwd_dkv.launches,
        "dq": fb.flash_bwd_dq.launches,
    }
    layers = train["model"]["n_layers"]
    losses = train["losses"]
    check(all(np.isfinite(losses)), f"training losses finite: {losses}")
    check(losses[-1] < losses[1], f"last loss {losses[-1]} below the second {losses[1]}")
    want = {"fwd": 2 * layers * TRAIN_STEPS, "dkv": layers * TRAIN_STEPS, "dq": layers * TRAIN_STEPS}
    check(train_launches == want, f"launches {train_launches} == {want} (fwd 2L, dK/dV L, dQ L per step)")
    print(f"[train] {TRAIN_STEPS} Trainer steps, L{layers} d2048 b4 s2048, AdamW warmup 2: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; launches fwd {train_launches['fwd']} dK/dV {train_launches['dkv']} dQ "
          f"{train_launches['dq']}")
    print(f"[time] train step: {train['step_ms']:.2f} ms (median of {TRAIN_STEPS - 1} after "
          f"warm-up), {train['tokens_per_s']:.0f} tokens/s, {train['model_tflops']:.2f} model "
          f"TF/s, MFU {train['mfu']:.2%} of {train['peak']} 989 TF/s {stamp}")

    # 10. Kernel device times at the training shape.
    q, k, v, o, do, lse, off = onchip.bwd_inputs(train_cases["train_bf16"])
    delta = fb.bwd_delta(o, do, None)
    kw = dict(sm_scale=0.125, causal=True)
    train_times = {
        "flash_fwd": (
            onchip.device_ms(lambda: flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)),
            onchip.device_ms(lambda: flash_attention_fwd_plain(q, k, v, off, save_lse=True, **kw)),
        ),
        "flash_bwd_dkv": (
            onchip.device_ms(lambda: fb.flash_bwd_dkv(q, k, v, do, lse, delta, off, **kw)),
            onchip.device_ms(lambda: fb.flash_bwd_dkv_plain(q, k, v, do, lse, delta, off, **kw)),
        ),
        "flash_bwd_dq": (
            onchip.device_ms(lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, off, **kw)),
            onchip.device_ms(lambda: fb.flash_bwd_dq_plain(q, k, v, do, lse, delta, off, **kw)),
        ),
    }
    for name, (ms, plain_ms) in train_times.items():
        print(f"[time] kernel {name} at the training shape q {tuple(q.shape)} kv "
              f"{tuple(k.shape)}: device {ms:.4f} ms, plain {plain_ms:.4f} ms {stamp}")
    # The forward kernel's bound and library call at its decode and
    # training shapes (row 1's prefill figures come in step 13).
    fwd_extra = {}
    for tag, (qx, kx, offx, pos_div, save_lse), lib in (
        ("decode", (*cases["decode_bf16"][0:2], cases["decode_bf16"][3], 2, False),
         kv["sdpa_decode"]),
        ("train", (q, k, off, 1, True), onchip.sdpa_ms(q, k, v, causal=True)),
    ):
        flops, nbytes = onchip.fwd_work(qx, kx, offx, pos_div, save_lse)
        fwd_extra.update({
            f"{tag}_bound_ms": roofline.roofline_time(flops, nbytes, spec, 16) * 1e3,
            f"{tag}_bound_by": roofline.bound_by(flops, nbytes, spec, 16),
            f"{tag}_library_ms": lib[0],
            f"{tag}_library_backend": lib[1],
        })
        print(f"[time] kernel flash_fwd, {tag}: bound {fwd_extra[f'{tag}_bound_ms']:.4f} ms "
              f"({fwd_extra[f'{tag}_bound_by']}), library {lib[0]:.4f} ms ({lib[1]}) {stamp}")

    # 10b. The tuned backward: the fused kernel, the autotuner's race, and
    # training under a decision naming the fused kernel.
    fused = fused_phase(gen, stamp, spec, tmp)

    # 11. The kernel ladder's kernels against their plain versions at the
    # benchmark's and the verification ladder's shapes: bf16 on the ladder,
    # peaked and spike fixtures, fp32 (tolerances as for the serving kernel).
    del train_cases
    torch.cuda.empty_cache()
    ladder_errors = {}
    for name, (kernel, qkv, kw) in onchip.ladder_fwd_cases(gen).items():
        err, lse_err = onchip.ladder_fwd_error(kernel, qkv, kw)
        tol = onchip.TOL[qkv[0].dtype]
        ladder_errors[name] = (kernel, qkv[0].dtype, err)
        check(err <= tol and lse_err <= tol,
              f"{name}: max abs err {err:.3e}, lse {lse_err:.3e} > {tol}")
        print(f"[ladder-kernel] {name} ({kernel}) q {tuple(qkv[0].shape)} kv {tuple(qkv[1].shape)} "
              f"{kw}: max_abs_err {err:.3e} lse_err {lse_err:.3e} (tol {tol})")
    tri_bwd_errors = {}
    for name, inputs in onchip.tri_bwd_cases(gen).items():
        errs = onchip.tri_bwd_errors(inputs)
        tol = onchip.BWD_TOL[inputs[0].dtype]
        tri_bwd_errors[name] = errs
        worst_rel = max(rel for _, rel in errs.values())
        check(worst_rel <= tol, f"{name}: backward normalised error {worst_rel:.3e} > {tol}")
        print(f"[ladder-kernel] {name} (flash_tri_bwd) q {tuple(inputs[0].shape)} kv "
              f"{tuple(inputs[1].shape)} offset {inputs[6]}: "
              + ", ".join(f"{g} max_abs {a:.3e} rel {r:.3e}" for g, (a, r) in errs.items())
              + f" (tol rel {tol})")
    torch.cuda.empty_cache()

    # 12. The slice's path: the verification ladder, then a short benchmark,
    # with every kernel's launches counted over the two.
    for fn in bench_mod.KERNELS.values():
        fn.launches = 0
    rungs = run_ladder(LADDER_N, device="cuda", log=lambda line: print(f"[ladder] {line}"))
    failed = [r.name for r in rungs if not r.passed]
    check(not failed, f"every ported ladder rung passes; failed: {failed}")
    missing = sorted(set(RUNGS_2_8_9_12_18) - {r.name for r in rungs})
    check(not missing, f"rungs 2, 8, 9, 12 and 18 run; missing: {missing}")
    detail = bench_mod.run_bench(SHORT_SWEEP, spec=spec, log=lambda m: print(f"[bench] {m} {stamp}"))
    slice_launches = bench_mod.kernel_launches()
    occ = detail["high_occupancy"]
    check(occ["bwd_spot_verify_pass"],
          f"bench backward spot check {occ['bwd_spot_verify_max_diff']:.3e} < {bench_mod.SPOT_CHECK_TOL}")
    # The folded V1 kernel runs on the sweep (step 14), the fused backward
    # under a tuned decision (step 10b): both have their own counted runs.
    unlaunched = [name for name, n in slice_launches.items()
                  if n == 0 and name not in ("flash_v1_folded", "flash_bwd_fused")]
    check(not unlaunched, f"every kernel launched on the ladder and bench path; not: {unlaunched}")
    print(f"[bench] short sweep {SHORT_SWEEP}: geomean speedup vs naive non-causal "
          f"{detail['geomean_speedup']:.3f}x, causal {detail['geomean_speedup_causal']:.3f}x; "
          f"{len(rungs)} ladder rungs passed; launches over the ladder and bench "
          f"{slice_launches} {stamp}")

    # 13. Each kernel's time at one shape of its path, beside its plain
    # version's, the library call's and the roofline bound (bytes: each
    # input read once, each output written once; operations: the visible
    # score pairs, 4 flops per pair and head dim per forward matmul pair).
    def nb(*tensors):
        return float(sum(t.numel() * t.element_size() for t in tensors))

    scale = 0.125
    rec = {}
    gen.manual_seed(SEED + 3)
    shp = onchip.SWEEP_1024
    qn, kn, vn = onchip.ladder_inputs(shp, shp, torch.float32, gen)
    qh, kh, vh = (x.bfloat16() for x in (qn, kn, vn))
    pairs_full = shp[0] * shp[1] * shp[2] * shp[2]
    rec["naive"] = timed_record(
        lambda: naive_attention(qn, kn, vn),
        lambda: naive_attention_plain(qn, kn, vn, sm_scale=scale, causal=False),
        onchip.sdpa_ms(qn, kn, vn), 4 * 64 * pairs_full, 2 * nb(qn, kn), 32,
        "sweep N=1024 B=8 H=1 fp32 non-causal", spec)
    rec["flash_lean"] = timed_record(
        lambda: flash_fwd_lean(qh, kh, vh),
        lambda: flash_fwd_lean_plain(qh, kh, vh, 0, sm_scale=scale, causal=False),
        onchip.sdpa_ms(qh, kh, vh), 4 * 64 * pairs_full, 2 * nb(qh, kh), 16,
        "sweep N=1024 B=8 H=1 bf16 non-causal", spec)
    shp = onchip.SWEEP_128
    qs, ks, vs = onchip.ladder_inputs(shp, shp, torch.bfloat16, gen)
    lean_128 = timed_record(
        lambda: flash_fwd_lean(qs, ks, vs),
        lambda: flash_fwd_lean_plain(qs, ks, vs, 0, sm_scale=scale, causal=False),
        onchip.sdpa_ms(qs, ks, vs), 4 * 64 * shp[0] * shp[2] * shp[2], 2 * nb(qs, ks), 16,
        "sweep N=128 B=512 H=1 bf16 non-causal", spec)
    del qn, kn, vn, qh, kh, vh, qs, ks, vs

    b_, h_, n_, d_ = onchip.HIGH_OCC
    qo, ko, vo = onchip.ladder_inputs(onchip.HIGH_OCC, onchip.HIGH_OCC, torch.bfloat16, gen)
    doo = qo * 0.01
    oo, lseo = ft.flash_attention_tri(qo, ko, vo, save_lse=True)
    tri_pairs = b_ * h_ * roofline.visible_pairs(n_, n_, 0)
    rec["flash_tri"] = timed_record(
        lambda: ft.flash_attention_tri(qo, ko, vo, save_lse=True),
        lambda: ft.flash_attention_tri_plain(qo, ko, vo, 0, sm_scale=scale, save_lse=True),
        onchip.sdpa_ms(qo, ko, vo, causal=True), 4 * d_ * tri_pairs,
        2 * nb(qo, ko) + nb(lseo), 16, "high occupancy B16 H8 N2048 bf16 causal, lse", spec)
    rec["flash_tri_bwd"] = timed_record(
        lambda: ft.flash_attention_bwd_tri(qo, ko, vo, oo, doo, lseo),
        lambda: ft.flash_attention_bwd_tri_plain(qo, ko, vo, oo, doo, lseo, 0, sm_scale=scale),
        onchip.sdpa_ms(qo, ko, vo, causal=True, backward_of=doo), 10 * d_ * tri_pairs,
        5 * nb(qo) + nb(lseo) + nb(qo) + 4 * qo.numel() * 2, 16,
        "high occupancy B16 H8 N2048 bf16 causal", spec)
    del qo, ko, vo, doo, oo, lseo
    torch.cuda.empty_cache()

    # The serving kernel at the prefill case (its library call needs an
    # explicit mask: the diagonal sits at offset 512, not top-left), the
    # split pair at the training shape (the library's backward computes dQ,
    # dK and dV together: the yardstick of both).
    qp, kp, vp, offp, _ = cases["prefill_bf16_off512"]
    n_qp, n_kvp = qp.shape[2], kp.shape[2]
    mask = (torch.arange(n_kvp, device="cuda")[None, :]
            <= torch.arange(n_qp, device="cuda")[:, None] + 512)
    fwd_pairs = qp.shape[1] * roofline.visible_pairs(n_qp, n_kvp, 512)
    rec["flash_fwd"] = {
        "ms": timings["prefill_bf16_off512"][0],
        "plain_ms": timings["prefill_bf16_off512"][1],
    }
    lib = onchip.sdpa_ms(qp, kp, vp, mask=mask)
    flops, nbytes = 4 * 64 * fwd_pairs, 2 * nb(qp, kp)
    rec["flash_fwd"].update(
        library_ms=lib[0], library_backend=lib[1],
        bound_ms=roofline.roofline_time(flops, nbytes, spec, 16) * 1e3,
        bound_by=roofline.bound_by(flops, nbytes, spec, 16),
        shape="prefill q [1,16,512,64] kv [1,8,2048,64] offset 512 bf16")
    train_pairs = q.shape[0] * q.shape[1] * roofline.visible_pairs(q.shape[2], k.shape[2], 0)
    lib = onchip.sdpa_ms(q, k, v, causal=True, backward_of=do)
    rows = nb(lse, delta)
    for name, flops, nbytes in (
        ("flash_bwd_dkv", 8 * 64 * train_pairs, nb(q, do, k, v, k, v) + rows),
        ("flash_bwd_dq", 6 * 64 * train_pairs, nb(q, do, k, v, q) + rows),
    ):
        rec[name] = {
            "ms": train_times[name][0],
            "plain_ms": train_times[name][1],
            "library_ms": lib[0],
            "library_backend": lib[1] + " backward (dQ, dK, dV together)",
            "bound_ms": roofline.roofline_time(flops, nbytes, spec, 16) * 1e3,
            "bound_by": roofline.bound_by(flops, nbytes, spec, 16),
            "shape": "training q [4,16,2048,64] kv [4,8,2048,64] bf16 causal",
        }
    for name, r in list(rec.items()) + [("flash_lean (N=128)", lean_128)]:
        print(f"[time] kernel {name} at {r['shape']}: device {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
              f"({r['library_backend']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}) {stamp}")

    # 14. The reference benchmark's sweep and its V1 kernels.
    v1_records = v1_phase(gen, stamp, spec, bench_mod.KERNELS)

    bf16_bwd = [errs for name, errs in bwd_errors.items() if "bf16" in name]
    bf16_tri_bwd = [errs for name, errs in tri_bwd_errors.items() if "bf16" in name]

    def ladder_err(kernel, dtype):
        return max(e for k_, d_, e in ladder_errors.values() if k_ == kernel and d_ == dtype)

    def times_of(name):
        return {key: rec[name][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_backend", "shape")}

    def bwd_record(name, line, grads):
        return {
            "name": name,
            "route": "cuda",
            "source": "flash_attention_metal_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"flash_attention_metal_tpu/kernels/flash_bwd.py:{line}",
            "launches": train_launches["dkv" if name.endswith("dkv") else "dq"],
            "launches_ladder_bench": slice_launches[name],
            "max_abs_err": max(e[g][0] for e in bf16_bwd for g in grads),
            "max_rel_err": max(e[g][1] for e in bf16_bwd for g in grads),
            "max_rel_err_fp32": max(bwd_errors["train_fp32_n512"][g][1] for g in grads),
            **times_of(name),
        }

    def ladder_record(name, source, line, kernel):
        return {
            "name": name,
            "route": "cuda",
            "source": f"flash_attention_metal_tpu_torch/csrc/{source}",
            "replaces": line,
            "launches": slice_launches[name],
            "max_abs_err": ladder_err(kernel, torch.bfloat16 if kernel != "naive" else torch.float32),
            **times_of(name),
        }

    lean_rec = ladder_record("flash_lean", "flash_lean.cu",
                             "flash_attention_metal_tpu/kernels/flash_fwd.py:429", "flash_lean")
    lean_rec.update({"max_abs_err_fp32": ladder_err("flash_lean", torch.float32),
                     **{f"{key}_n128": lean_128[key] for key in (
                         "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
    tri_rec = ladder_record("flash_tri", "flash_tri.cu",
                            "flash_attention_metal_tpu/kernels/flash_tri.py:50", "flash_tri")
    tri_rec["max_abs_err_fp32"] = ladder_err("flash_tri", torch.float32)
    record = {
        "kernels": [{
            "name": "flash_fwd",
            "route": "cuda",
            "source": "flash_attention_metal_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "flash_attention_metal_tpu/kernels/flash_fwd.py:84",
            "launches": launches + train_launches["fwd"],
            "max_abs_err": max(errors[n] for n in errors if "bf16" in n),
            "max_abs_err_fp32": errors["prefill_fp32_off512"],
            **times_of("flash_fwd"),
            "decode_ms": timings["decode_bf16"][0],
            "decode_plain_ms": timings["decode_bf16"][1],
            "launches_prefill": prefill_launches[0],
            "launches_decode": decode_launches,
            "launches_train": train_launches["fwd"],
            "launches_ladder_bench": slice_launches["flash_fwd"],
            "train_ms": train_times["flash_fwd"][0],
            "train_plain_ms": train_times["flash_fwd"][1],
            **fwd_extra,
        },
            bwd_record("flash_bwd_dkv", 79, ("dk", "dv")),
            bwd_record("flash_bwd_dq", 268, ("dq",)),
            ladder_record("naive", "naive.cu", "flash_attention_metal_tpu/kernels/naive.py:31",
                          "naive"),
            lean_rec,
            tri_rec,
            {
                "name": "flash_tri_bwd",
                "route": "cuda",
                "source": "flash_attention_metal_tpu_torch/csrc/flash_tri.cu",
                "replaces": "flash_attention_metal_tpu/kernels/flash_tri.py:431",
                "launches": slice_launches["flash_tri_bwd"],
                "max_abs_err": max(e[g][0] for e in bf16_tri_bwd for g in e),
                "max_rel_err": max(e[g][1] for e in bf16_tri_bwd for g in e),
                "max_rel_err_fp32": max(r for _, r in tri_bwd_errors["tri_bwd_fp32_n1024"].values()),
                **times_of("flash_tri_bwd"),
            },
            *kv["records"],
            fused["record"],
            *v1_records,
        ],
        "serving": {
            "tokens_per_s": bench["tokens_per_s"],
            "ms_per_step": bench["ms_per_step"],
            "decode_step_ms": step_ms,
            "prefill_ms_512": prefill_ms,
            "served_logits_rel_l2_max": worst,
        },
        "serving_kv_caches": kv["serving"],
        "training": {
            "step_ms": train["step_ms"],
            "tokens_per_s": train["tokens_per_s"],
            "model_tflops": train["model_tflops"],
            "mfu": train["mfu"],
            "losses": losses,
            "grad_rel_l2_max": grads["worst"],
        },
        "training_fused_backward": {
            "step_ms": fused["step_ms"],
            "losses": fused["losses"],
            "grad_rel_l2_max": fused["grad_rel_l2_max"],
        },
        "bench_short": {
            "sweep": SHORT_SWEEP,
            "geomean_speedup": detail["geomean_speedup"],
            "geomean_speedup_causal": detail["geomean_speedup_causal"],
            "points": [{"n": p["n"], "causal": c, "speedup": p["speedup"],
                        "flash_tflops": p["flash_tflops"]}
                       for c, key in ((False, "sweep"), (True, "sweep_causal"))
                       for p in detail[key]],
            "high_occupancy": occ,
        },
        "card": smi,
    }
    tmp_dir.cleanup()
    print(smi)
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
