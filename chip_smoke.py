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
  (``csrc/flash_fwd.cu``; decode on the split-KV grid of
  ``csrc/flash_decode.cuh``) against their plain versions at the serving
  shapes and the split's edges (int8 and e4m3, bf16 pools, fp32 q at one
  shape; shuffled page tables), each kernel's time with its split count
  and blocks, then 16 requests through one engine per mode (``kv_quant``
  int8 and fp8, ``paged``, ``paged`` with ``prefix_share`` on prompts
  sharing their first half, ``paged`` int8), each with its kernel launched
  in prefill and decode and the dense kernel never, and its served logits
  within the mode's bound;
* training: the dK/dV and dQ kernels against their plain versions at the
  training shape, each parameter's gradient at depth 2 against the fp32
  oracle attention, 6 ``Trainer`` steps at batch 4, seq 2048 with the
  kernels' launch counts, step time, tokens/s and MFU, and the forward
  kernel against its plain version at the training shape (ladder, peaked
  and spike fixtures, head dim 64 and 128);
* the kernel ladder: the naive, lean and triangular forward kernels and
  the triangular backward against their plain versions at the benchmark's
  and the verification ladder's shapes (the triangular backward also
  bit-identical over repeated runs, and its dQ workspace the fused
  kernel's O(B H N D) one), the port's verification ladder at
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
  folded, ``csrc/flash_v1.cu`` on the fp32 tiles it shares with naive)
  against their plain version in fp32, and ``run_sweep`` at N = 128 and
  1024, each point launching its V1 kernel; each kernel's time, bound and
  SDPA's at the sweep's shape, with the Q-tile height and block count it
  took;
* block-sparse attention under ladder rung 11's mask (each kernel's
  grid, read from its wrapper after the timed launches: the forward's and
  dQ's one block per Q tile, the dK/dV plan's chunk cap, chunks and
  blocks), then head dim 128:
  every kernel against its plain version at its path's shape with D = 128,
  with its device, plain, bound and library times (the general forward
  also at the training shape and folded decode, lean also at N = 128);
* sliding-window attention with sinks (W 512, 4 sinks) and segment ids:
  the windowed and segmented forward, split pair, fused backward and cache
  kernels against their plain versions (D 64 and 128, bf16 and fp32),
  the windowed FlashLM's gradient check, ``Trainer`` steps (split pair,
  then the fused backward under a saved decision) and 16 requests through
  ``DecodeEngine`` on the dense and the paged int8 cache, with launches
  counted over each run; each windowed kernel's time beside its
  unwindowed time, its bound over the window's visible pairs and SDPA's
  with a boolean window mask (the records' ``window_*`` keys);
* the score transforms (the tanh softcap and ALiBi with the slopes'
  gradient): the transformed forward, split pair and cache kernels against
  their plain versions (D 64 and 128, bf16 and fp32), the capped ALiBi
  FlashLM's gradient check, ``Trainer`` steps (the split pair, and under a
  saved "fused" decision, which the transforms decline) and 16 requests on
  the dense and the paged int8 cache; each kernel's time under the softcap,
  ALiBi and both beside its untransformed time, its bound and SDPA's with
  the ALiBi bias as a float mask (the records' ``xf_*`` keys);
* attention dropout (GPT-2's attn_pdrop 0.1): the forward kernel's keep
  mask equal to the plain one bit for bit, the dropout forward and split
  pair against their plain versions (D 64 and 128, bf16 and fp32, alone
  and with the window, sinks, softcap and ALiBi), the gradient check with
  the same seeds both ways, the dropout FlashLM trained through
  ``Trainer.train`` from token shards (``utils/data.py``) beside the same
  model without dropout, and served without seeds, equal to the model
  without dropout; each kernel's time with dropout beside its time without,
  its bound and SDPA's with ``dropout_p`` (the records' ``drop_*`` keys).

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
import threading
import time

import numpy as np
import torch

MAX_BATCH, MAX_LEN = 8, 2048
N_REQUESTS, PROMPT_LENS, MAX_NEW = 16, (64, 1000), 64
SEED = 0
# Training: full width; the gradient check at depth 2, batch 1.
TRAIN_STEPS, GRAD_CHECK_LAYERS = 6, 2
# The windowed FlashLM's training run (W = 512, 4 sinks).
WINDOW_TRAIN_STEPS = 4
# The capped ALiBi FlashLM's training run (softcap 30, ALiBi in place of RoPE).
XF_TRAIN_STEPS = 4
# The dropout FlashLM's training runs (attn_dropout 0.1, and 0 beside it),
# each fed from token shards: the first step warms up, the rest are timed.
DROP_TRAIN_STEPS = 4
# MUFU (special-function unit) ops per visible pair under each transform in
# the timed bf16 kernels: the softmax's exp2 (one; the backward rebuilds P
# with one), and the softcap's tanh one more (tanh.approx.f32, csrc/xf.cuh);
# ALiBi adds none (an FMA on a distance that the unrolled loop keeps in
# floats).
XF_MUFU = {name: {"none": 1, "softcap": 2, "alibi": 1, "both": 2}
           for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_quant",
                        "flash_paged", "flash_paged_quant")}
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
# Ladder rung 11's name at LADDER_N (JAX's, with its mask's block density).
RUNG_11 = "flash block-sparse mask (density 0.44) vs oracle"
# The 8-bit and paged KV caches: the serving modes, one engine each, in
# order; the prefix-shared mode's traffic (1024-token prompts whose first
# half is common, the JAX serving bench's shared_prefix = prompt_len // 2)
# and its served-logits prompts (the common 512 tokens and tails).
KV_MODES = ("int8", "fp8", "paged", "paged_prefix_shared", "paged_int8")
PREFIX_PROMPT, PREFIX_SHARED = 1024, 512
PREFIX_CHECK_PROMPTS = (600, 700, 1000, 1024)
# The rest of one-device serving (serve_phase): the rolling caches'
# requests (64 to 3000 tokens, most past the 768-slot cache) and their
# engines' length, and the teacher-forced prompts past the capacity; the
# near-tie margin under which two engines' greedy streams may part;
# multi-step dispatch, speculative proposals, the beam, the snapshot's step.
ROLL_PROMPT_LENS, ROLL_MAX_LEN = (64, 3000), 4096
ROLL_CHECK_PROMPTS = (5, 700, 1000, 2900)
NEAR_TIE = 0.1
MULTI_STEP, SPEC_GAMMA = 4, 4
BEAM_WIDTH, BEAM_PROMPT, BEAM_NEW, BEAM_REL_TOL = 4, 512, 32, 1e-2
SNAPSHOT_STEPS = 20
# The one-device model families (family_phase): Mixtral's routing on the
# serving FlashLM; the MoE training depth; the steps, batch, depth and
# AdamW rate of the families' training runs; seq2seq's target length,
# decoded source and tokens; TinyLlama-1.1B's published widths (its
# config.json) and the converted model's depth.
MOE = dict(n_experts=8, top_k=2, capacity_factor=1.25)
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 4
# Served MoE logits (fp32 on both sides, moe_served_errors): a row whose
# plain forward holds, in some layer, a gap under this between the router's
# k-th and (k+1)-th probability may route a token elsewhere and exceed the
# logits bound (moe_router_gaps; fp32 rounding moves them by ~1e-6).
MOE_NEAR_TIE = 1e-4
FAMILY_STEPS, FAMILY_BATCH, FAMILY_LAYERS, FAMILY_LR = 4, 8, 2, 1e-3
S2S_TGT, S2S_SOURCE, S2S_NEW = 128, 100, 32
LLAMA = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
             num_attention_heads=32, num_key_value_heads=4)
LLAMA_LAYERS = 4


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
    # case, each beside its plain version and its roofline bound, and the
    # grid the timed launches took (the wrapper's ``.grid``).  No PyTorch
    # call attends over an 8-bit or paged cache; SDPA on a dense bf16 cache
    # of the same shape (a different function) is timed beside them.
    def timed(case):
        kernel, args, pos_div = cases[case]
        wrapper, plain = onchip.KV_KERNELS[kernel]
        flops, nbytes = onchip.kv_work(kernel, args, pos_div)
        bits = 32 if args[0].dtype == torch.float32 else 16
        ms = onchip.device_ms(lambda: wrapper(*args, pos_div))
        return {
            "ms": ms,
            **counters[kernel].grid._asdict(),
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
            "source": "flash_attention_metal_tpu_torch/csrc/flash_decode.cuh",
            "entry": "flash_attention_metal_tpu_torch/csrc/flash_fwd.cu",
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
        print(f"[time] kernel {kernel} at {rec['shape']}, split-KV grid {rec['kv_splits']} "
              f"splits of {rec['kv_chunk']} columns, {rec['blocks']} blocks: device "
              f"{rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
              f"SDPA on a dense bf16 cache {rec['sdpa_dense_bf16_ms']:.4f} ms; prefill q "
              f"[1,16,512,64] offset 512 ({rec['prefill_blocks']} blocks, unsplit): device "
              f"{rec['prefill_ms']:.4f} ms, plain "
              f"{rec['prefill_plain_ms']:.4f} ms, bound {rec['prefill_bound_ms']:.4f} ms "
              f"({rec['prefill_bound_by']}), SDPA dense {sdpa_prefill[0]:.4f} ms {stamp}")
    del cases
    torch.cuda.empty_cache()
    return {"records": records, "serving": serving_out, "sdpa_decode": sdpa_decode}


def grad_check(gen: torch.Generator, head_dim: int = 64, dropout_seeds=None, **window) -> dict:
    """Every parameter's gradient at full width, depth 2, batch 1, seq
    2048, with the kernels' attention against the fp32 oracle attention
    (bf16 compute both ways); fails above ``GRAD_REL_L2_TOL``.  ``window``:
    the model's sliding window and sinks (and its other attention options:
    ``train_bench.flashlm_config``'s keywords); ``dropout_seeds``: the
    layers' dropout seeds, the same both ways."""
    from flash_attention_metal_tpu_torch.harness import train_bench
    from flash_attention_metal_tpu_torch.models import transformer as tf

    gcfg = dataclasses.replace(train_bench.flashlm_config(n_layers=GRAD_CHECK_LAYERS, **window),
                               head_dim=head_dim)
    gen.manual_seed(SEED)
    gparams = tf.init_params(gcfg, gen, master_dtype=torch.float32)
    gtokens = train_bench.fixed_batch(gcfg, 1, 2048, SEED + 2)
    seeds = () if dropout_seeds is None else (dropout_seeds,)
    loss_k, grads_k = tf.value_and_grad(tf.loss_fn, gparams, gtokens, gcfg, *seeds)
    loss_r, grads_r = tf.value_and_grad(
        tf.loss_fn, gparams, gtokens, dataclasses.replace(gcfg, attn_impl="reference"), *seeds)
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
        route = "folded" if name == "flash_v1_folded" else "stream"
        rows = fv.v1_tile_rows(route, b, h, n, n, d)
        print(f"[time] kernel {name} at {rec['shape']}: device {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms "
              f"({rec['library_backend']}), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
              f"{rows}-row Q tiles, {b * h * -(-n // rows)} blocks; launches over the sweep "
              f"{rec['launches']} {stamp}")
        del q, k, v
    torch.cuda.empty_cache()
    return records


def fused_phase(gen: torch.Generator, stamp: str, spec, tmp: str) -> dict:
    """The tuned backward: the fused kernel (``csrc/flash_bwd.cu``,
    ``fam_flash_bwd_fused``) against its plain version at the training
    shape (bf16 ladder and peaked fixtures, fp32 at N = 512) and at high
    occupancy, and bit-identical over repeated runs; ``autotune_bwd`` racing split, fused and tri at both shapes
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
    # Deterministic: the KV tiles add to each dQ row in KV-tile order, so
    # repeated runs give the same bits (GQA, a different offset per batch).
    q, k, v, _, do, _, _ = inputs["train_bf16_peaked"]
    off = torch.tensor([0, 64, 100, 1000], dtype=torch.int32, device="cuda")
    varied = onchip.bwd_inputs((q, k, v, do, off))
    runs = [fb.flash_attention_bwd_fused(*varied, causal=True, q_offset_max=1000)
            for _ in range(3)]
    same = all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))
    check(same, "fused backward: repeated runs differ")
    print(f"[fused-kernel] train_bf16_peaked at offsets {off.tolist()}: 3 runs bit-identical")
    del varied, runs, q, k, v, do
    for name in ("high_occupancy_bf16", "train_bf16_peaked", "train_bf16_spike", "train_fp32_n512"):
        del inputs[name]
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
    # calls the kernel there (its int offset 0).  The workspace is the fp32
    # accumulator and its counters, O(B H N D): nothing grows with N^2.
    q, k, v, o, do, lse, off = inputs["train_bf16"]
    batch, heads, n_q, head_dim = q.shape
    flops, nbytes = roofline.fused_bwd_work(batch, heads, k.shape[1], n_q, k.shape[2], head_dim,
                                            2, causal=True)
    ws_alloc, ws_written = onchip.fused_workspace_bytes(inputs["train_bf16"], 0)
    ws_need = fb.fused_workspace_bytes(q)
    check(0 <= ws_alloc - ws_need < 512 and 0 < ws_written <= 4 * q.numel(),
          f"fused dQ workspace: {ws_alloc} bytes allocated (accumulator and counters: "
          f"{ws_need}), {ws_written} bytes of the accumulator written")
    kw = dict(sm_scale=0.125, causal=True)
    rec = {
        "name": "flash_bwd_fused",
        "route": "cuda",
        "source": "flash_attention_metal_tpu_torch/csrc/flash_bwd_fused_sm90.cuh",
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
          f"dQ workspace {ws_alloc} bytes allocated, {ws_written} bytes of the accumulator "
          f"written (allocator peak; NaN-filled accumulator overwritten) {stamp}")
    del inputs, q, k, v, o, do, lse
    torch.cuda.empty_cache()
    return {"record": rec, "grad_rel_l2_max": g["worst"], "losses": train["losses"],
            "step_ms": train["step_ms"]}


def window_phase(gen: torch.Generator, stamp: str, spec, tmp: str) -> dict:
    """Sliding-window attention with sinks (the windowed FlashLM's W = 512,
    4 sinks) and segment ids.  Every windowed and segmented kernel (rows
    1, 5, 6, 7, 11, 12 and 13: the wgmma forward, the fp32 template and the
    decode grid; the split pair and the fused backward; the quant, paged
    and paged-quant kernels) against its plain version
    (``onchip.WINDOW_*_CASES``: D 64 and 128, bf16 and fp32, ladder, peaked,
    spike and negative-score fixtures, windows ending mid-tile, sink tiles
    far left of the window, decode splits wholly outside it).  Then the
    main path: the depth-2 gradient check, ``Trainer`` steps at full width,
    the same under a saved decision naming the fused backward, and 16
    requests through ``DecodeEngine`` on the dense and the paged int8 cache,
    each with its kernels' launches counted over that run only.  Then each
    kernel's time at its path's shape, D 64 and 128, beside its unwindowed
    time in the same call, its bound over the visible pairs of the window,
    and SDPA's with an explicit boolean window mask.  Returns each record's
    ``window_*`` keys by kernel name, and the runs' numbers."""
    from flash_attention_metal_tpu_torch.harness import autotune, onchip, serving, train_bench
    from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
    from flash_attention_metal_tpu_torch.kernels import paged as pg
    from flash_attention_metal_tpu_torch.kernels import quant as qt
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import flash_attention_fwd, flash_fwd_general
    from flash_attention_metal_tpu_torch.utils import roofline

    w, s = onchip.WINDOW, onchip.SINKS
    win = dict(window=w, sinks=s)
    errs = {}  # (kernel, tag) -> worst error, tag: bf16 / d128 / fp32

    def keep(kernel, tag, err):
        errs[(kernel, tag)] = max(err, errs.get((kernel, tag), 0.0))

    def tag_of(q):
        return "fp32" if q.dtype == torch.float32 else "d128" if q.shape[-1] == 128 else "bf16"

    # 1. Each windowed and segmented kernel against its plain version.
    fwd_cases = onchip.window_fwd_cases(gen)
    for name, case in fwd_cases.items():
        err, lse_err = onchip.window_fwd_error(case)
        tol = onchip.TOL[case[0].dtype]
        check(err <= tol and lse_err <= tol,
              f"window {name}: max abs err {err:.3e}, lse {lse_err:.3e} > {tol}")
        keep("flash_fwd", tag_of(case[0]), err)
        feats = {k: v for k, v in case[5].items() if k != "segment_ids"}
        print(f"[window-kernel] flash_fwd {name} q {tuple(case[0].shape)} kv "
              f"{tuple(case[1].shape)} {feats}{' segment ids' if 'segment_ids' in case[5] else ''}"
              f": max_abs_err {err:.3e} lse_err {lse_err:.3e} (tol {tol})")
    for name, with_fused in onchip.WINDOW_BWD_CASES:
        inputs = onchip.window_bwd_inputs(fwd_cases[name], gen)
        tol = onchip.BWD_TOL[inputs[0].dtype]
        for fused in (False, True) if with_fused else (False,):
            e = onchip.window_bwd_errors(inputs, fused=fused)
            worst = max(rel for _, rel in e.values())
            check(worst <= tol, f"window {name} {'fused' if fused else 'split'}: backward "
                  f"normalised error {worst:.3e} > {tol}")
            if fused:
                keep("flash_bwd_fused", tag_of(inputs[0]), worst)
            else:
                keep("flash_bwd_dkv", tag_of(inputs[0]), max(e["dk"][1], e["dv"][1]))
                keep("flash_bwd_dq", tag_of(inputs[0]), e["dq"][1])
            print(f"[window-kernel] {'flash_bwd_fused' if fused else 'split pair'} {name}: "
                  + ", ".join(f"{g} rel {r:.3e}" for g, (_, r) in e.items()) + f" (tol rel {tol})")
        del inputs
    del fwd_cases
    torch.cuda.empty_cache()
    kv_cases = {**onchip.kv_cases(gen), **onchip.kv_d128_cases(gen)}
    for name, kw_w, kw_s in onchip.WINDOW_KV_CASES:
        kernel, args, pos_div = kv_cases[name]
        err, lse_err = onchip.kv_kernel_error(kernel, args, pos_div, window=kw_w, sinks=kw_s)
        tol = onchip.TOL[args[0].dtype]
        check(err <= tol and lse_err <= tol,
              f"window {name} W {kw_w} S {kw_s}: max abs err {err:.3e}, lse {lse_err:.3e}")
        keep(kernel, tag_of(args[0]), err)
        print(f"[window-kernel] {kernel} {name} W {kw_w} sinks {kw_s}: max_abs_err {err:.3e} "
              f"lse_err {lse_err:.3e} (tol {tol})")
    del kv_cases
    torch.cuda.empty_cache()

    # 2. The main path: training (split pair, then the fused backward under
    # a saved decision) and serving, every count reset just before its run.
    g = grad_check(gen, **win)
    print(f"[window-grad-check] W {w} sinks {s}: {grad_line(g)}")
    counters = {"fwd": flash_fwd_general, "dkv": fb.flash_bwd_dkv, "dq": fb.flash_bwd_dq,
                "fused": fb.flash_bwd_fused}
    for fn in counters.values():
        fn.launches = 0
    train = train_bench.run_train_bench(steps=WINDOW_TRAIN_STEPS, log=lambda m: None, **win)
    train_launches = {name: fn.launches for name, fn in counters.items()}
    layers = train["model"]["n_layers"]
    want = {"fwd": 2 * layers * WINDOW_TRAIN_STEPS, "dkv": layers * WINDOW_TRAIN_STEPS,
            "dq": layers * WINDOW_TRAIN_STEPS, "fused": 0}
    losses = train["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[1],
          f"windowed training losses finite and falling: {losses}")
    check(train_launches == want, f"windowed training launches {train_launches} == {want}")
    print(f"[window-train] {WINDOW_TRAIN_STEPS} Trainer steps, L{layers} d2048 b4 s2048 W {w} "
          f"sinks {s}: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; launches {train_launches}; step {train['step_ms']:.2f} ms, "
          f"{train['tokens_per_s']:.0f} tokens/s, MFU {train['mfu']:.2%} {stamp}")
    tuned = os.path.join(tmp, "window_fused.json")
    b_, h_, n_, d_ = onchip.TRAIN_Q
    autotune.record_bwd((b_, h_, onchip.TRAIN_KV[1], n_, d_), "fused", {}, cache_path=tuned)
    default_cache = autotune.DEFAULT_CACHE
    autotune.DEFAULT_CACHE = tuned
    autotune.reset_memo()
    for fn in counters.values():
        fn.launches = 0
    train_f = train_bench.run_train_bench(steps=2, log=lambda m: None, **win)
    fused_launches = {name: fn.launches for name, fn in counters.items()}
    autotune.DEFAULT_CACHE = default_cache
    autotune.reset_memo()
    want = {"fwd": 4 * layers, "dkv": 0, "dq": 0, "fused": 2 * layers}
    check(all(np.isfinite(train_f["losses"])) and fused_launches == want,
          f"windowed training under a saved \"fused\" decision: launches {fused_launches} == "
          f"{want}, losses {train_f['losses']}")
    print(f"[window-train-fused] 2 Trainer steps W {w} sinks {s} under a cache naming "
          f"\"fused\": losses " + ", ".join(f"{x:.4f}" for x in train_f["losses"])
          + f"; launches {fused_launches}; step {train_f['step_ms']:.2f} ms {stamp}")
    serving_out = {}
    prng = np.random.default_rng(SEED + 5)
    for mode, counted in (("dense", flash_fwd_general), ("paged_int8", pg.flash_attention_paged_quant)):
        opts, bound = serving.SERVING_MODES[mode]
        eng, cfg = serving.build_engine(
            **serving.FLASHLM_D2048, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=SEED,
            device="cuda", **win, **opts)
        eng.submit(serving.Request(uid=-1, prompt=list(range(1, 101)), max_new_tokens=4))
        eng.run()
        requests = serving.make_requests(N_REQUESTS, cfg.vocab_size, PROMPT_LENS, MAX_NEW, SEED)
        others = [fn for fn in (flash_fwd_general, qt.flash_attention_quant,
                                pg.flash_attention_paged, pg.flash_attention_paged_quant)
                  if fn is not counted]
        for fn in (counted, *others):
            fn.launches = 0
        bench = serving.run_serving_bench(eng, requests, log=lambda m: None)
        n_launch, n_other = counted.launches, sum(fn.launches for fn in others)
        check(all(r.done and len(r.generated) == MAX_NEW for r in requests)
              and all(np.isfinite(lp) and lp <= 0 for r in requests for lp in r.logprobs),
              f"windowed {mode} serving: every request finishes, log-probabilities finite")
        check(n_launch > 0 and n_other == 0,
              f"windowed {mode} serving launches its kernel ({n_launch}) and no other ({n_other})")
        crossing = sum(len(r.prompt) + MAX_NEW > w for r in requests)
        prompts = [prng.integers(1, cfg.vocab_size, n).tolist() for n in CHECK_PROMPTS]
        rel = serving.teacher_forced_errors(eng.params, cfg, prompts, 16, MAX_LEN, seed=SEED,
                                            mode=mode)
        worst = float(np.max(rel))
        check(worst <= bound, f"windowed {mode} served logits rel L2 {worst:.3e} > {bound}")
        serving_out[mode] = {"tokens_per_s": bench["tokens_per_s"],
                             "ms_per_step": bench["ms_per_step"], "launches": n_launch,
                             "served_logits_rel_l2_max": worst, "requests_crossing": crossing}
        print(f"[window-serve] {mode}: {N_REQUESTS} requests x {MAX_NEW} tokens, prompts "
              f"{min(len(r.prompt) for r in requests)}-{max(len(r.prompt) for r in requests)} "
              f"({crossing} cross the window of {w}): {bench['tokens_per_s']:.1f} tok/s, "
              f"{bench['ms_per_step']:.3f} ms/step; its kernel launched {n_launch} times, the "
              f"others 0; served logits rel L2 max {worst:.3e} (tol {bound}) {stamp}")
        del eng
        torch.cuda.empty_cache()

    # 3. Times at the path's shapes, D 64 and 128: windowed, unwindowed in
    # the same call, the bound over the window's visible pairs, SDPA with
    # the window as a boolean mask.
    out = {name: {} for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_fused",
                                 "flash_quant", "flash_paged", "flash_paged_quant")}

    def put(name, suffix, ms, unwindowed_ms, flops, nbytes, library, shape):
        out[name].update({
            f"window_ms{suffix}": ms, f"window_unwindowed_ms{suffix}": unwindowed_ms,
            f"window_bound_ms{suffix}": roofline.roofline_time(flops, nbytes, spec, 16) * 1e3,
            f"window_bound_by{suffix}": roofline.bound_by(flops, nbytes, spec, 16),
            f"window_library_ms{suffix}": library[0],
            f"window_library_backend{suffix}": library[1] + " (explicit boolean window mask)",
            f"window_shape{suffix}": shape})
        r = out[name]
        print(f"[window-time] {name} at {shape}: W {w} {ms:.4f} ms, unwindowed {unwindowed_ms:.4f}"
              f" ms, bound {r[f'window_bound_ms{suffix}']:.4f} ms "
              f"({r[f'window_bound_by{suffix}']}), SDPA with the window mask "
              f"{library[0]:.4f} ms {stamp}")

    for suffix, (shape_q, shape_kv) in (("", (onchip.TRAIN_Q, onchip.TRAIN_KV)),
                                        ("_d128", (onchip.TRAIN_D128_Q, onchip.TRAIN_D128_KV))):
        q, k, v = onchip.ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)
        do = onchip.ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)[0]
        off = torch.zeros(shape_q[0], dtype=torch.int32, device="cuda")
        batch, heads, n, d = shape_q
        mask = onchip.window_mask(n, n, off[:1], w, s)
        shape = f"training q {list(shape_q)} kv {list(shape_kv)} bf16 causal W {w} sinks {s}"
        kw = dict(sm_scale=d ** -0.5, causal=True)
        o, lse = flash_attention_fwd(q, k, v, off, causal=True, save_lse=True, **win)
        o_u, lse_u = flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)
        flops, nbytes = onchip.fwd_work(q, k, off.tolist(), 1, True, **win)
        put("flash_fwd", suffix,
            onchip.device_ms(lambda: flash_attention_fwd(q, k, v, off, causal=True, save_lse=True,
                                                         **win)),
            onchip.device_ms(lambda: flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)),
            flops, nbytes, onchip.sdpa_ms(q, k, v, mask=mask), shape)
        delta, delta_u = fb.bwd_delta(o, do, None), fb.bwd_delta(o_u, do, None)
        pairs = roofline.visible_pairs(n, n, 0, **win)
        lib_bwd = onchip.sdpa_ms(q, k, v, mask=mask, backward_of=do)
        for name, fn in (("flash_bwd_dkv", fb.flash_bwd_dkv), ("flash_bwd_dq", fb.flash_bwd_dq)):
            flops, nbytes = roofline.block_sparse_work(batch, heads, k.shape[1], n, n, d, 2, pairs,
                                                       name[-3:].lstrip("_"))
            put(name, suffix,
                onchip.device_ms(lambda: fn(q, k, v, do, lse, delta, off, window=w, sinks=s, **kw)),
                onchip.device_ms(lambda: fn(q, k, v, do, lse_u, delta_u, off, **kw)),
                flops, nbytes, lib_bwd, shape)
        flops, nbytes = roofline.fused_bwd_work(batch, heads, k.shape[1], n, n, d, 2, causal=True,
                                                **win)
        put("flash_bwd_fused", suffix,
            onchip.device_ms(lambda: fb.flash_attention_bwd_fused(
                q, k, v, o, do, lse, off, q_offset_max=0, **kw, **win)),
            onchip.device_ms(lambda: fb.flash_attention_bwd_fused(
                q, k, v, o_u, do, lse_u, off, q_offset_max=0, **kw)),
            flops, nbytes, lib_bwd, shape)
        del q, k, v, do, o, lse, o_u, lse_u, delta, delta_u, mask
        torch.cuda.empty_cache()
    # Folded decode: the forward's decode grid and the cache kernels.
    lengths = torch.from_numpy(onchip.decode_lengths()).to("cuda")
    for suffix, (shape_q, shape_kv) in (("", (onchip.DECODE_Q, onchip.DECODE_KV)),
                                        ("_d128", (onchip.DECODE_D128_Q, onchip.DECODE_D128_KV))):
        q, k, v = onchip.ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)
        b, h_kv, n_kv, d = shape_kv
        qd = onchip.ladder_inputs((b, 2 * h_kv, 1, d), shape_kv, torch.bfloat16, gen)[0]
        lib = onchip.sdpa_ms(qd, k, v, mask=onchip.window_mask(1, n_kv, lengths, w, s))
        shape = (f"folded decode q {list(shape_q)} over a cache {list(shape_kv)} at the decode "
                 f"lengths, W {w} sinks {s}")
        flops, nbytes = onchip.fwd_work(q, k, lengths.tolist(), 2, False, **win)
        put("flash_fwd", f"_decode{suffix}",
            onchip.device_ms(lambda: flash_attention_fwd(q, k, v, lengths, causal=True, pos_div=2,
                                                         **win)),
            onchip.device_ms(lambda: flash_attention_fwd(q, k, v, lengths, causal=True, pos_div=2)),
            flops, nbytes, lib, shape)
        gen_kv = torch.Generator(device="cuda")
        gen_kv.manual_seed(SEED)
        cases = onchip.kv_d128_cases(gen_kv) if suffix else onchip.kv_cases(gen_kv)
        for name, kernel in (("quant_int8_decode_bf16", "flash_quant"),
                             ("paged_decode_bf16", "flash_paged"),
                             ("paged_quant_int8_decode_bf16", "flash_paged_quant")):
            kernel_, args, pos_div = cases[name + suffix]
            wrapper = onchip.KV_KERNELS[kernel][0]
            flops, nbytes = onchip.kv_work(kernel, args, pos_div, **win)
            put(kernel, suffix, onchip.device_ms(lambda: wrapper(*args, pos_div, **win)),
                onchip.device_ms(lambda: wrapper(*args, pos_div)), flops, nbytes, lib, shape)
        del q, k, v, qd, cases
        torch.cuda.empty_cache()

    # Launches on the main path: the forward in training and dense serving,
    # the split pair in training, the fused kernel under its decision, the
    # paged-quant kernel in paged int8 serving; the quant and paged kernels
    # are checked at kernel level only.
    launches = {"flash_fwd": train_launches["fwd"] + serving_out["dense"]["launches"],
                "flash_bwd_dkv": train_launches["dkv"], "flash_bwd_dq": train_launches["dq"],
                "flash_bwd_fused": fused_launches["fused"], "flash_quant": 0, "flash_paged": 0,
                "flash_paged_quant": serving_out["paged_int8"]["launches"]}
    for name in out:
        out[name]["window_launches"] = launches[name]
        out[name]["window_max_err"] = errs.get((name, "bf16"), errs.get((name, "fp32")))
        for tag in ("d128", "fp32"):
            if (name, tag) in errs:
                out[name][f"window_max_err_{tag}"] = errs[(name, tag)]
    unlaunched = [n for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_fused",
                              "flash_paged_quant") if launches[n] == 0]
    check(not unlaunched, f"every windowed kernel of the main path launched: not {unlaunched}")
    return {"records": out, "grad_rel_l2_max": g["worst"], "train": {
        "losses": losses, "step_ms": train["step_ms"], "tokens_per_s": train["tokens_per_s"],
        "mfu": train["mfu"], "launches": train_launches, "fused_losses": train_f["losses"],
        "fused_step_ms": train_f["step_ms"], "fused_launches": fused_launches},
        "serving": serving_out}


def xf_phase(gen: torch.Generator, stamp: str, spec, tmp: str) -> dict:
    """The score transforms, the tanh softcap and ALiBi with the slopes'
    gradient (the capped ALiBi FlashLM's cap 30 and standard slopes).  Every
    transformed kernel (rows 1, 5, 6, 11, 12 and 13: the wgmma forward, the
    fp32 template and the decode grid; the split pair with d_slopes; the
    quant, paged and paged-quant kernels) against its plain version
    (``onchip.XF_*_CASES``: D 64 and 128, bf16 and fp32, ladder, peaked and
    spike fixtures, caps 0.5 to 30, standard, large and small slopes,
    composed with the window and segment ids, offsets, not causal; and
    ``onchip.XF_FAR_FP32``, fp32 rows far past the cache, at limits scaled
    to their lse).  Then the main path: the depth-2 gradient check, ``Trainer`` steps at full width on
    the split pair, 2 steps under a saved decision naming the fused backward
    (which takes no transform: declined, 0 launches), and 16 requests
    through ``DecodeEngine`` on the dense and the paged int8 cache (ALiBi
    unfolds the decode rows), each with its kernels' launches counted over
    that run only.  Then each kernel's time at its path's shapes, D 64 and
    128, under the softcap alone, ALiBi alone and both, beside its
    untransformed time in the same call, its bound (the untransformed
    work; the MUFU ops per pair named beside it) and, under ALiBi, SDPA's
    with the bias as a float mask (the softcap has no SDPA counterpart).
    Returns each record's ``xf_*`` keys by kernel name, and the runs'
    numbers."""
    from flash_attention_metal_tpu_torch.harness import autotune, onchip, serving, train_bench
    from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
    from flash_attention_metal_tpu_torch.kernels import paged as pg
    from flash_attention_metal_tpu_torch.kernels import quant as qt
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import (
        flash_attention_fwd,
        flash_fwd_general,
        plain_visible,
    )
    from flash_attention_metal_tpu_torch.utils import roofline

    model = dict(softcap=onchip.SOFTCAP, alibi=True)
    errs = {}  # (kernel, tag) -> worst error, tag: bf16 / d128 / fp32

    def keep(kernel, tag, err):
        errs[(kernel, tag)] = max(err, errs.get((kernel, tag), 0.0))

    def tag_of(q):
        return "fp32" if q.dtype == torch.float32 else "d128" if q.shape[-1] == 128 else "bf16"

    def feats_text(feats):
        return {k: (v if k != "alibi_slopes" else "slopes") for k, v in feats.items()
                if k != "segment_ids"}

    # 1. Each transformed kernel against its plain version.
    fwd_cases = onchip.xf_fwd_cases(gen)
    for name, case in fwd_cases.items():
        err, lse_err = onchip.window_fwd_error(case)
        tol = onchip.TOL[case[0].dtype]
        check(err <= tol and lse_err <= tol,
              f"xf {name}: max abs err {err:.3e}, lse {lse_err:.3e} > {tol}")
        keep("flash_fwd", tag_of(case[0]), err)
        print(f"[xf-kernel] flash_fwd {name} q {tuple(case[0].shape)} kv {tuple(case[1].shape)} "
              f"{feats_text(case[5])}: max_abs_err {err:.3e} lse_err {lse_err:.3e} (tol {tol})")
    for name in onchip.XF_BWD_CASES:
        inputs = onchip.window_bwd_inputs(fwd_cases[name], gen)
        tol = onchip.BWD_TOL[inputs[0].dtype]
        e = onchip.window_bwd_errors(inputs)
        check(all(rel <= onchip.bwd_limit(g, inputs[0].dtype) for g, (_, rel) in e.items()),
              f"xf {name}: backward normalised errors {e} over their bounds")
        keep("flash_bwd_dkv", tag_of(inputs[0]),
             max(rel for g, (_, rel) in e.items() if g != "dq"))
        keep("flash_bwd_dq", tag_of(inputs[0]), e["dq"][1])
        print(f"[xf-kernel] split pair {name}: "
              + ", ".join(f"{g} rel {r:.3e}" for g, (_, r) in e.items()) + f" (tol rel {tol}; "
              f"d_slopes_head {onchip.DSLOPE_HEAD_TOL[inputs[0].dtype]})")
        del inputs
    del fwd_cases
    far = onchip.xf_far_errors(gen)
    check(all(e <= lim for e, lim in far.values()),
          f"xf {onchip.XF_FAR_FP32[0]}: errors over their limits {far}")
    print(f"[xf-kernel] {onchip.XF_FAR_FP32[0]} (fp32, rows far past the cache, limits scaled to "
          "the lse): " + ", ".join(f"{g} {e:.3e} (limit {lim:.3e})" for g, (e, lim) in far.items()))
    torch.cuda.empty_cache()
    kv_cases = {**onchip.kv_cases(gen), **onchip.kv_d128_cases(gen)}
    for name, unfold, feats in onchip.XF_KV_CASES:
        kernel, args, pos_div, kw = onchip.xf_kv_case(kv_cases, name, unfold, feats)
        err, lse_err = onchip.kv_kernel_error(kernel, args, pos_div, **kw)
        tol = onchip.TOL[args[0].dtype]
        check(err <= tol and lse_err <= tol,
              f"xf {name} {feats}: max abs err {err:.3e}, lse {lse_err:.3e}")
        keep(kernel, tag_of(args[0]), err)
        print(f"[xf-kernel] {kernel} {name}{' unfolded' if unfold else ''} {feats}: max_abs_err "
              f"{err:.3e} lse_err {lse_err:.3e} (tol {tol})")
    del kv_cases
    torch.cuda.empty_cache()

    # 2. The main path: training (the split pair, then under a saved
    # "fused" decision, which the transforms decline) and serving, every
    # count reset just before its run.
    g = grad_check(gen, **model)
    print(f"[xf-grad-check] softcap {onchip.SOFTCAP:g} ALiBi: {grad_line(g)}")
    counters = {"fwd": flash_fwd_general, "dkv": fb.flash_bwd_dkv, "dq": fb.flash_bwd_dq,
                "fused": fb.flash_bwd_fused}
    for fn in counters.values():
        fn.launches = 0
    train = train_bench.run_train_bench(steps=XF_TRAIN_STEPS, log=lambda m: None, **model)
    train_launches = {name: fn.launches for name, fn in counters.items()}
    layers = train["model"]["n_layers"]
    want = {"fwd": 2 * layers * XF_TRAIN_STEPS, "dkv": layers * XF_TRAIN_STEPS,
            "dq": layers * XF_TRAIN_STEPS, "fused": 0}
    losses = train["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[1],
          f"capped ALiBi training losses finite and falling: {losses}")
    check(train_launches == want, f"capped ALiBi training launches {train_launches} == {want}")
    print(f"[xf-train] {XF_TRAIN_STEPS} Trainer steps, L{layers} d2048 b4 s2048 softcap "
          f"{onchip.SOFTCAP:g} ALiBi: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; launches {train_launches}; step {train['step_ms']:.2f} ms, "
          f"{train['tokens_per_s']:.0f} tokens/s, MFU {train['mfu']:.2%} {stamp}")
    tuned = os.path.join(tmp, "xf_fused.json")
    b_, h_, n_, d_ = onchip.TRAIN_Q
    autotune.record_bwd((b_, h_, onchip.TRAIN_KV[1], n_, d_), "fused", {}, cache_path=tuned)
    default_cache = autotune.DEFAULT_CACHE
    autotune.DEFAULT_CACHE = tuned
    autotune.reset_memo()
    for fn in counters.values():
        fn.launches = 0
    train_f = train_bench.run_train_bench(steps=2, log=lambda m: None, **model)
    fused_launches = {name: fn.launches for name, fn in counters.items()}
    autotune.DEFAULT_CACHE = default_cache
    autotune.reset_memo()
    want = {"fwd": 4 * layers, "dkv": 2 * layers, "dq": 2 * layers, "fused": 0}
    check(all(np.isfinite(train_f["losses"])) and fused_launches == want,
          f"capped ALiBi training under a saved \"fused\" decision: launches {fused_launches} "
          f"== {want}, losses {train_f['losses']}")
    print(f"[xf-train-fused] 2 Trainer steps under a cache naming \"fused\": declined, losses "
          + ", ".join(f"{x:.4f}" for x in train_f["losses"])
          + f"; launches {fused_launches}; step {train_f['step_ms']:.2f} ms {stamp}")
    serving_out = {}
    prng = np.random.default_rng(SEED + 6)
    for mode, counted in (("dense", flash_fwd_general), ("paged_int8", pg.flash_attention_paged_quant)):
        opts, bound = serving.SERVING_MODES[mode]
        eng, cfg = serving.build_engine(
            **serving.FLASHLM_D2048, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=SEED,
            device="cuda", **model, **opts)
        eng.submit(serving.Request(uid=-1, prompt=list(range(1, 101)), max_new_tokens=4))
        eng.run()
        requests = serving.make_requests(N_REQUESTS, cfg.vocab_size, PROMPT_LENS, MAX_NEW, SEED)
        others = [fn for fn in (flash_fwd_general, qt.flash_attention_quant,
                                pg.flash_attention_paged, pg.flash_attention_paged_quant)
                  if fn is not counted]
        for fn in (counted, *others):
            fn.launches = 0
        bench = serving.run_serving_bench(eng, requests, log=lambda m: None)
        n_launch, n_other = counted.launches, sum(fn.launches for fn in others)
        check(all(r.done and len(r.generated) == MAX_NEW for r in requests)
              and all(np.isfinite(lp) and lp <= 0 for r in requests for lp in r.logprobs),
              f"capped ALiBi {mode} serving: every request finishes, log-probabilities finite")
        check(n_launch > 0 and n_other == 0,
              f"capped ALiBi {mode} serving launches its kernel ({n_launch}) and no other "
              f"({n_other})")
        prompts = [prng.integers(1, cfg.vocab_size, n).tolist() for n in CHECK_PROMPTS]
        rel = serving.teacher_forced_errors(eng.params, cfg, prompts, 16, MAX_LEN, seed=SEED,
                                            mode=mode)
        worst = float(np.max(rel))
        check(worst <= bound, f"capped ALiBi {mode} served logits rel L2 {worst:.3e} > {bound}")
        serving_out[mode] = {"tokens_per_s": bench["tokens_per_s"],
                             "ms_per_step": bench["ms_per_step"], "launches": n_launch,
                             "served_logits_rel_l2_max": worst}
        print(f"[xf-serve] {mode}: {N_REQUESTS} requests x {MAX_NEW} tokens, prompts "
              f"{min(len(r.prompt) for r in requests)}-{max(len(r.prompt) for r in requests)}: "
              f"{bench['tokens_per_s']:.1f} tok/s, {bench['ms_per_step']:.3f} ms/step; its kernel "
              f"launched {n_launch} times, the others 0; served logits rel L2 max {worst:.3e} "
              f"(tol {bound}) {stamp}")
        del eng
        torch.cuda.empty_cache()

    # 3. Times at the path's shapes, D 64 and 128: each transform and both,
    # the untransformed kernel in the same call, the bound of the
    # untransformed work with the MUFU ops per pair beside it, SDPA with
    # the ALiBi bias as a float mask.
    out = {name: {} for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_quant",
                                 "flash_paged", "flash_paged_quant")}
    variants = (("softcap", dict(softcap=onchip.SOFTCAP)), ("alibi", dict(alibi=True)),
                ("both", dict(softcap=onchip.SOFTCAP, alibi=True)))

    def xf_kw(v, heads):
        kw = {k: val for k, val in v.items() if k != "alibi"}
        if v.get("alibi"):
            kw["alibi_slopes"] = onchip.alibi_slopes("std", heads)
        return kw

    def put(name, suffix, times, plain_kernel_ms, flops, nbytes, libraries, shape):
        r = out[name]
        r.update({f"xf_{v}_ms{suffix}": ms for v, ms in times.items()})
        r.update({
            f"xf_untransformed_ms{suffix}": plain_kernel_ms,
            f"xf_bound_ms{suffix}": roofline.roofline_time(flops, nbytes, spec, 16) * 1e3,
            f"xf_bound_by{suffix}": roofline.bound_by(flops, nbytes, spec, 16),
            f"xf_shape{suffix}": shape})
        for v, lib in libraries.items():
            r[f"xf_{v}_library_ms{suffix}"] = lib[0]
            r[f"xf_{v}_library_backend{suffix}"] = lib[1] + " (ALiBi bias as a float mask)"
        print(f"[xf-time] {name} at {shape}: " + ", ".join(
            f"{v} {ms:.4f} ms" for v, ms in times.items())
            + f"; untransformed {plain_kernel_ms:.4f} ms; bound {r[f'xf_bound_ms{suffix}']:.4f} ms "
            f"({r[f'xf_bound_by{suffix}']}, MUFU ops a pair: {XF_MUFU[name]}); SDPA with the "
            "ALiBi mask " + ", ".join(f"{v} {lib[0]:.4f} ms" for v, lib in libraries.items())
            + f" (softcap: no SDPA counterpart) {stamp}")

    for suffix, (shape_q, shape_kv) in (("", (onchip.TRAIN_Q, onchip.TRAIN_KV)),
                                        ("_d128", (onchip.TRAIN_D128_Q, onchip.TRAIN_D128_KV))):
        q, k, v = onchip.ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)
        do = onchip.ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)[0]
        off = torch.zeros(shape_q[0], dtype=torch.int32, device="cuda")
        batch, heads, n, d = shape_q
        visible = plain_visible(n, n, off[:1], causal=True, device="cuda")
        mask = onchip.alibi_bias(onchip.alibi_slopes("std", heads), n, n, off[:1], visible)
        shape = f"training q {list(shape_q)} kv {list(shape_kv)} bf16 causal"
        kw = dict(sm_scale=d ** -0.5, causal=True)
        # Each variant's keywords (its slopes on the card) made once, outside
        # the timed calls.
        kws = {name: xf_kw(vv, heads) for name, vv in variants}
        fwd = {name: flash_attention_fwd(q, k, v, off, causal=True, save_lse=True, **kw_)
               for name, kw_ in kws.items()}
        fwd["none"] = flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)
        flops, nbytes = onchip.fwd_work(q, k, off.tolist(), 1, True)
        times = {name: onchip.device_ms(lambda: flash_attention_fwd(
            q, k, v, off, causal=True, save_lse=True, **kw_)) for name, kw_ in kws.items()}
        lib = onchip.sdpa_ms(q, k, v, mask=mask)
        put("flash_fwd", suffix, times,
            onchip.device_ms(lambda: flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)),
            flops, nbytes, {"alibi": lib, "both": lib}, shape)
        deltas = {name: fb.bwd_delta(o, do, None) for name, (o, _) in fwd.items()}
        pairs = roofline.visible_pairs(n, n, 0)
        lib_bwd = onchip.sdpa_ms(q, k, v, mask=mask, backward_of=do)
        for name, fn in (("flash_bwd_dkv", fb.flash_bwd_dkv), ("flash_bwd_dq", fb.flash_bwd_dq)):
            flops, nbytes = roofline.block_sparse_work(batch, heads, k.shape[1], n, n, d, 2, pairs,
                                                       name[-3:].lstrip("_"))

            def run(vname):
                x = kws.get(vname, {})
                cap = x.get("softcap") or 0.0
                return lambda: fn(q, k, v, do, fwd[vname][1], deltas[vname], off, softcap=cap,
                                  slopes=x.get("alibi_slopes"), **kw)

            times = {vname: onchip.device_ms(run(vname)) for vname, _ in variants}
            put(name, suffix, times, onchip.device_ms(run("none")), flops, nbytes,
                {"alibi": lib_bwd, "both": lib_bwd}, shape)
        del q, k, v, do, fwd, deltas, mask, visible
        torch.cuda.empty_cache()
    # Decode: the softcap on the folded rows, ALiBi unfolded (a q-head a
    # row), beside the untransformed folded and unfolded kernels.
    lengths = torch.from_numpy(onchip.decode_lengths()).to("cuda")
    for suffix, (shape_q, shape_kv) in (("", (onchip.XF_DECODE_Q, onchip.DECODE_KV)),
                                        ("_d128", (onchip.XF_DECODE_D128_Q, onchip.DECODE_D128_KV))):
        from flash_attention_metal_tpu_torch.ops.attention import fold_gqa_rows

        qu, k, v = onchip.ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)
        b, h_kv, n_kv, d = shape_kv
        heads = shape_q[1]
        qf = fold_gqa_rows(qu, h_kv).contiguous()
        visible = plain_visible(1, n_kv, lengths, causal=True, device="cuda")
        lib = onchip.sdpa_ms(qu, k, v, mask=onchip.alibi_bias(
            onchip.alibi_slopes("std", heads), 1, n_kv, lengths, visible))
        shape = (f"decode q {list(shape_q)} (the softcap folded {list(qf.shape)}) over a cache "
                 f"{list(shape_kv)} at the decode lengths")
        flops, nbytes = onchip.fwd_work(qf, k, lengths.tolist(), 2, False)

        def call(vv):
            x = xf_kw(vv, heads)
            if "alibi_slopes" in x:
                return lambda: flash_attention_fwd(qu, k, v, lengths, causal=True, **x)
            return lambda: flash_attention_fwd(qf, k, v, lengths, causal=True, pos_div=2, **x)

        times = {vname: onchip.device_ms(call(vv)) for vname, vv in variants}
        times["untransformed_unfolded"] = onchip.device_ms(
            lambda: flash_attention_fwd(qu, k, v, lengths, causal=True))
        put("flash_fwd", f"_decode{suffix}", times,
            onchip.device_ms(lambda: flash_attention_fwd(qf, k, v, lengths, causal=True,
                                                         pos_div=2)),
            flops, nbytes, {"alibi": lib, "both": lib}, shape)
        gen_kv = torch.Generator(device="cuda")
        gen_kv.manual_seed(SEED)
        cases = onchip.kv_d128_cases(gen_kv) if suffix else onchip.kv_cases(gen_kv)
        for name, kernel in (("quant_int8_decode_bf16", "flash_quant"),
                             ("paged_decode_bf16", "flash_paged"),
                             ("paged_quant_int8_decode_bf16", "flash_paged_quant")):
            kernel_, args, pos_div = cases[name + suffix]
            wrapper = onchip.KV_KERNELS[kernel][0]
            uargs = onchip.unfolded(args, heads)
            flops, nbytes = onchip.kv_work(kernel, args, pos_div)

            def kv_call(vv):
                x = xf_kw(vv, heads)
                if "alibi_slopes" in x:
                    return lambda: wrapper(*uargs, 1, **x)
                return lambda: wrapper(*args, pos_div, **x)

            times = {vname: onchip.device_ms(kv_call(vv)) for vname, vv in variants}
            times["untransformed_unfolded"] = onchip.device_ms(lambda: wrapper(*uargs, 1))
            put(kernel, suffix, times, onchip.device_ms(lambda: wrapper(*args, pos_div)),
                flops, nbytes, {"alibi": lib, "both": lib}, shape)
        del qu, qf, k, v, cases
        torch.cuda.empty_cache()

    # Launches on the main path: the forward in training and dense serving,
    # the split pair in training (the fused kernel never), the paged-quant
    # kernel in paged int8 serving; the quant and paged kernels are checked
    # at kernel level only.
    launches = {"flash_fwd": train_launches["fwd"] + serving_out["dense"]["launches"],
                "flash_bwd_dkv": train_launches["dkv"], "flash_bwd_dq": train_launches["dq"],
                "flash_quant": 0, "flash_paged": 0,
                "flash_paged_quant": serving_out["paged_int8"]["launches"]}
    for name in out:
        out[name]["xf_launches"] = launches[name]
        out[name]["xf_mufu_per_pair"] = XF_MUFU[name]
        out[name]["xf_max_err"] = errs.get((name, "bf16"), errs.get((name, "fp32")))
        for tag in ("d128", "fp32"):
            if (name, tag) in errs:
                out[name][f"xf_max_err_{tag}"] = errs[(name, tag)]
    unlaunched = [n for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_paged_quant")
                  if launches[n] == 0]
    check(not unlaunched, f"every transformed kernel of the main path launched: not {unlaunched}")
    return {"records": out, "grad_rel_l2_max": g["worst"], "train": {
        "losses": losses, "step_ms": train["step_ms"], "tokens_per_s": train["tokens_per_s"],
        "mfu": train["mfu"], "launches": train_launches, "fused_decision_losses": train_f["losses"],
        "fused_decision_step_ms": train_f["step_ms"], "fused_decision_launches": fused_launches},
        "serving": serving_out}


def drop_phase(gen: torch.Generator, stamp: str, spec, tmp: str) -> dict:
    """Attention dropout at GPT-2's ``attn_pdrop`` 0.1 (``onchip.DROP_RATE``)
    on the general forward and the split pair (rows 1, 5 and 6: the wgmma
    kernels and the fp32 templates).  First the keep mask bit for bit
    against ``_common.keep_factors`` (``onchip.MASK_CASES``: q = k = 0 and V
    the identity, so ``o * n_kv`` is the mask; D 64 and 128, bf16 and fp32,
    a seed with its top bit set, shard offsets and a head count that puts
    bh past 2^16), then each kernel against its plain version
    (``onchip.DROP_*_CASES``: the training shape at D 64 and 128, bf16 and
    fp32, ladder, peaked and spike fixtures, with the window, sinks,
    softcap and ALiBi together, segment ids, shard offsets, per-batch
    offsets, not causal, one decode token).  Then the main path: the
    depth-2 gradient check against the oracle with the same seeds, the
    dropout FlashLM trained through ``Trainer.train`` from token shards
    (``utils.data``: shards written here, ``batch_iterator``,
    ``prefetch_to_device``) beside the same model without dropout on the
    same stream, launches counted over the dropout run, and 16 requests
    served by the dropout config, which takes no seeds, equal to those of
    the config without dropout.  Then each kernel's time with dropout, D 64
    and 128 and fp32, beside its time without it in the same call, its
    bound (dropout adds no bytes and no tensor-core work: the undropped
    call's) and SDPA's with ``dropout_p`` in training mode (its own RNG, so
    another mask; forward, and forward and backward).  Returns each
    record's ``drop_*`` keys by kernel name, and the runs' numbers."""
    from flash_attention_metal_tpu_torch.harness import onchip, serving, train_bench
    from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import (
        check_dropout,
        flash_attention_fwd,
        flash_fwd_general,
    )
    from flash_attention_metal_tpu_torch.models import Trainer, make_optimizer
    from flash_attention_metal_tpu_torch.utils import data, roofline

    t_start = time.perf_counter()
    rate = onchip.DROP_RATE
    errs = {}  # (kernel, tag) -> worst error, tag: bf16 / d128 / fp32

    def keep(kernel, tag, err):
        errs[(kernel, tag)] = max(err, errs.get((kernel, tag), 0.0))

    def tag_of(q):
        return "fp32" if q.dtype == torch.float32 else "d128" if q.shape[-1] == 128 else "bf16"

    def feats_text(feats):
        return {k: v for k, v in feats.items()
                if k not in ("segment_ids", "alibi_slopes", "dropout_seed")}

    # 1. The keep mask, bit for bit.
    for name, *_ in onchip.MASK_CASES:
        got, want = onchip.dropout_mask(name)
        n_bad = int((got != want).sum())
        check(n_bad == 0, f"dropout mask {name}: {n_bad} of {got.numel()} keep factors differ "
              "from _common.keep_factors")
        print(f"[drop-mask] {name}: {got.numel()} keep factors of the forward kernel equal to "
              f"_common.keep_factors bit for bit (kept {float((want > 0).float().mean()):.4f} at "
              f"rate {onchip.MASK_RATE})")

    # 2. Each dropout kernel against its plain version.
    fwd_cases = onchip.drop_fwd_cases(gen)
    for name, case in fwd_cases.items():
        err, lse_err = onchip.window_fwd_error(case)
        tol = onchip.TOL[case[0].dtype]
        check(err <= tol and lse_err <= tol,
              f"dropout {name}: max abs err {err:.3e}, lse {lse_err:.3e} > {tol}")
        keep("flash_fwd", tag_of(case[0]), err)
        print(f"[drop-kernel] flash_fwd {name} q {tuple(case[0].shape)} kv {tuple(case[1].shape)} "
              f"{feats_text(case[5])}{' segment ids' if 'segment_ids' in case[5] else ''}: "
              f"max_abs_err {err:.3e} lse_err {lse_err:.3e} (tol {tol})")
    for name in onchip.DROP_BWD_CASES:
        inputs = onchip.window_bwd_inputs(fwd_cases[name], gen)
        tol = onchip.BWD_TOL[inputs[0].dtype]
        e = onchip.window_bwd_errors(inputs)
        check(all(rel <= onchip.bwd_limit(g, inputs[0].dtype) for g, (_, rel) in e.items()),
              f"dropout {name}: backward normalised errors {e} over their bounds")
        keep("flash_bwd_dkv", tag_of(inputs[0]), max(rel for g, (_, rel) in e.items() if g != "dq"))
        keep("flash_bwd_dq", tag_of(inputs[0]), e["dq"][1])
        print(f"[drop-kernel] split pair {name}: "
              + ", ".join(f"{g} rel {r:.3e}" for g, (_, r) in e.items()) + f" (tol rel {tol})")
        del inputs
    del fwd_cases
    torch.cuda.empty_cache()

    # 3. The main path.  The gradient check with the same seeds both ways.
    seeds = torch.tensor([onchip.DROP_SEED, 77], dtype=torch.int32, device="cuda")
    g = grad_check(gen, attn_dropout=rate, dropout_seeds=seeds)
    print(f"[drop-grad-check] attn_dropout {rate}, seeds {seeds.tolist()}: {grad_line(g)}")
    # Training from token shards: seeded tokens in two shards, enough
    # 2048-token windows for every step of both runs.
    cfg = train_bench.flashlm_config(attn_dropout=rate)
    batch, seq = 4, 2048
    windows = DROP_TRAIN_STEPS * batch
    rng = np.random.default_rng(SEED + 7)
    paths = []
    for i in range(2):
        paths.append(os.path.join(tmp, f"tokens{i}.bin"))
        data.write_token_shard(paths[-1], rng.integers(0, cfg.vocab_size, windows // 2 * seq))
    dataset = data.TokenDataset(paths)

    def stream():
        return (b for b, _ in data.prefetch_to_device(
            data.batch_iterator(dataset, batch, seq - 1, seed=SEED), size=2, device="cuda"))

    def train_run(run_cfg):
        trainer = Trainer(run_cfg, optimizer=make_optimizer(warmup_steps=2, total_steps=1000),
                          seed=SEED, device="cuda")
        batches, losses, times = stream(), [], []
        for _ in range(DROP_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += trainer.train(batches, steps=1)["losses"]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        del trainer
        torch.cuda.empty_cache()
        return losses, float(np.median(times[1:])) * 1e3

    counters = {"fwd": flash_fwd_general, "dkv": fb.flash_bwd_dkv, "dq": fb.flash_bwd_dq,
                "fused": fb.flash_bwd_fused}
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms = train_run(cfg)
    train_launches = {name: fn.launches for name, fn in counters.items()}
    layers = cfg.n_layers
    want = {"fwd": 2 * layers * DROP_TRAIN_STEPS, "dkv": layers * DROP_TRAIN_STEPS,
            "dq": layers * DROP_TRAIN_STEPS, "fused": 0}
    check(all(np.isfinite(losses)), f"dropout training losses finite: {losses}")
    check(train_launches == want, f"dropout training launches {train_launches} == {want}")
    plain_losses, plain_step_ms = train_run(dataclasses.replace(cfg, attn_dropout=0.0))
    check(all(np.isfinite(plain_losses)) and plain_losses != losses,
          f"the run without dropout differs: {plain_losses} vs {losses}")
    print(f"[drop-train] {DROP_TRAIN_STEPS} Trainer.train steps from {len(paths)} token shards "
          f"(batch_iterator, prefetch_to_device), L{layers} d2048 b{batch} s{seq} attn_dropout "
          f"{rate}: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; launches {train_launches}; step {step_ms:.2f} ms against {plain_step_ms:.2f} ms "
          "without dropout on the same stream (losses "
          + ", ".join(f"{x:.4f}" for x in plain_losses) + f") {stamp}")
    # Serving: the dropout config passes no seeds, so it serves what the
    # config without dropout serves.
    served = {}
    for label, drop in (("attn_dropout", rate), ("none", 0.0)):
        eng, ecfg = serving.build_engine(
            **serving.FLASHLM_D2048, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=SEED,
            device="cuda", attn_dropout=drop)
        requests = serving.make_requests(N_REQUESTS, ecfg.vocab_size, PROMPT_LENS, MAX_NEW, SEED)
        flash_fwd_general.launches = 0
        serving.run_serving_bench(eng, requests, log=lambda m: None)
        served[label] = ([r.generated for r in requests], [r.logprobs for r in requests],
                         flash_fwd_general.launches)
        del eng
        torch.cuda.empty_cache()
    same = served["attn_dropout"][:2] == served["none"][:2]
    check(same and served["attn_dropout"][2] > 0,
          "the dropout config serves the tokens and log-probabilities of the config without "
          f"dropout ({same}), through the forward kernel ({served['attn_dropout'][2]} launches)")
    print(f"[drop-serve] dense: {N_REQUESTS} requests x {MAX_NEW} tokens from the attn_dropout "
          f"{rate} config (no seeds): tokens and log-probabilities equal to the attn_dropout 0 "
          f"config's, bit for bit; forward kernel launched {served['attn_dropout'][2]} times")

    # 4. Times at the training shape, D 64 and 128 bf16 and fp32 at N 512:
    # with dropout, without it in the same call, the undropped bound, SDPA
    # with dropout_p in training mode.
    out = {name: {} for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    for suffix, (shape_q, shape_kv, dtype) in (
            ("", (onchip.TRAIN_Q, onchip.TRAIN_KV, torch.bfloat16)),
            ("_d128", (onchip.TRAIN_D128_Q, onchip.TRAIN_D128_KV, torch.bfloat16)),
            ("_fp32", (onchip.TRAIN_FP32_Q, onchip.TRAIN_FP32_KV, torch.float32))):
        q, k, v = onchip.ladder_inputs(shape_q, shape_kv, dtype, gen)
        do = onchip.ladder_inputs(shape_q, shape_kv, dtype, gen)[0]
        off = torch.zeros(shape_q[0], dtype=torch.int32, device="cuda")
        b_, h_, n, d = shape_q
        bits = 16 if dtype == torch.bfloat16 else 32
        shape = (f"training q {list(shape_q)} kv {list(shape_kv)} "
                 f"{'bf16' if bits == 16 else 'fp32'} causal")
        # The seed packed on the card once, as the op packs it: a timed call
        # copies nothing from the host.
        drop = check_dropout(rate, onchip.DROP_SEED, device="cuda")
        dkw = dict(dropout_rate=rate, dropout_seed=drop.seed)
        o_d, lse_d = flash_attention_fwd(q, k, v, off, causal=True, save_lse=True, **dkw)
        o_u, lse_u = flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)
        lib_f = onchip.sdpa_ms(q, k, v, causal=True, dropout_p=rate)
        lib_b = onchip.sdpa_ms(q, k, v, causal=True, dropout_p=rate, backward_of=do,
                               with_forward=True)
        kw = dict(sm_scale=d ** -0.5, causal=True)
        delta_d, delta_u = fb.bwd_delta(o_d, do, None), fb.bwd_delta(o_u, do, None)
        flops, nbytes = onchip.fwd_work(q, k, off.tolist(), 1, True)
        works = {"flash_fwd": (flops, nbytes)}
        pairs = roofline.visible_pairs(n, n, 0)
        for name in ("flash_bwd_dkv", "flash_bwd_dq"):
            works[name] = roofline.block_sparse_work(b_, h_, k.shape[1], n, n, d, bits // 8,
                                                     pairs, name[-3:].lstrip("_"))
        calls = {
            "flash_fwd": (lambda: flash_attention_fwd(q, k, v, off, causal=True, save_lse=True,
                                                      **dkw),
                          lambda: flash_attention_fwd(q, k, v, off, causal=True, save_lse=True),
                          lib_f),
            "flash_bwd_dkv": (lambda: fb.flash_bwd_dkv(q, k, v, do, lse_d, delta_d, off,
                                                       drop=drop, **kw),
                              lambda: fb.flash_bwd_dkv(q, k, v, do, lse_u, delta_u, off, **kw),
                              lib_b),
            "flash_bwd_dq": (lambda: fb.flash_bwd_dq(q, k, v, do, lse_d, delta_d, off, drop=drop,
                                                     **kw),
                             lambda: fb.flash_bwd_dq(q, k, v, do, lse_u, delta_u, off, **kw),
                             lib_b),
        }
        for name, (with_drop, without, lib) in calls.items():
            ms, plain_ms = onchip.device_ms(with_drop), onchip.device_ms(without)
            flops_, nbytes_ = works[name]
            r = out[name]
            r.update({
                f"drop_ms{suffix}": ms,
                f"drop_undropped_ms{suffix}": plain_ms,
                f"drop_bound_ms{suffix}": roofline.roofline_time(flops_, nbytes_, spec, bits) * 1e3,
                f"drop_bound_by{suffix}": roofline.bound_by(flops_, nbytes_, spec, bits),
                f"drop_library_ms{suffix}": lib[0],
                f"drop_library_backend{suffix}": lib[1] + f" with dropout_p {rate} ("
                + ("forward" if name == "flash_fwd" else "forward and backward") + ")",
                f"drop_shape{suffix}": shape})
            print(f"[drop-time] {name} at {shape}: dropout {ms:.4f} ms, without {plain_ms:.4f} ms "
                  f"({ms / plain_ms:.2f}x); bound {r[f'drop_bound_ms{suffix}']:.4f} ms "
                  f"({r[f'drop_bound_by{suffix}']}); SDPA dropout_p {rate} {lib[0]:.4f} ms "
                  f"({r[f'drop_library_backend{suffix}']}) {stamp}")
        del q, k, v, do, o_d, o_u, lse_d, lse_u, delta_d, delta_u, calls
        torch.cuda.empty_cache()

    launches = {"flash_fwd": train_launches["fwd"], "flash_bwd_dkv": train_launches["dkv"],
                "flash_bwd_dq": train_launches["dq"]}
    for name in out:
        out[name]["drop_launches"] = launches[name]
        out[name]["drop_max_err"] = errs[(name, "bf16")]
        out[name]["drop_max_err_d128"] = errs[(name, "d128")]
        out[name]["drop_max_err_fp32"] = errs[(name, "fp32")]
    check(all(launches.values()), f"every dropout kernel of the main path launched: {launches}")
    secs = time.perf_counter() - t_start
    print(f"[drop] phase {secs:.1f} s")
    return {"records": out, "grad_rel_l2_max": g["worst"], "seconds": secs, "train": {
        "losses": losses, "step_ms": step_ms, "launches": train_launches,
        "undropped_losses": plain_losses, "undropped_step_ms": plain_step_ms,
        "shards": len(paths), "tokens": dataset.n_tokens}}


def greedy_requests(n: int, vocab: int, prompt_lens, max_new: int, seed: int) -> list:
    """``serving.make_requests``' prompts, every request greedy."""
    from flash_attention_metal_tpu_torch.harness import serving

    reqs = serving.make_requests(n, vocab, prompt_lens, max_new, seed)
    for r in reqs:
        r.temperature, r.top_k = 0.0, 0
    return reqs


def stream_partings(params, cfg, got: list, want: list, what: str) -> list:
    """Greedy streams of ``got`` equal ``want``'s token for token, except
    where the reference's two largest logits at the step they part lie
    within ``NEAR_TIE`` of each other (a plain bf16 forward of its prompt and
    tokens up to there): returns the steps of such partings, fails on any
    other."""
    from flash_attention_metal_tpu_torch.models.transformer import forward

    partings = []
    for g, w in zip(got, want):
        check(len(g.generated) == len(w.generated), f"{what}: request {w.uid} emitted "
              f"{len(g.generated)} tokens, the reference {len(w.generated)}")
        if g.generated == w.generated:
            continue
        j = next(i for i, (a, b) in enumerate(zip(g.generated, w.generated)) if a != b)
        with torch.no_grad():
            seq = torch.tensor([w.prompt + w.generated[:j]], device="cuda")
            top = torch.topk(forward(params, seq, cfg)[0, -1].float(), 2).values
        margin = float(top[0] - top[1])
        check(margin < NEAR_TIE, f"{what}: request {w.uid} parts at step {j} where the "
              f"reference's top-2 logit margin is {margin:.3f} >= {NEAR_TIE}")
        partings.append(j)
    return partings


def partings_text(steps: list) -> str:
    """``stream_partings``' steps for a log line."""
    if not steps:
        return "no near-tie parting"
    return (f"{len(steps)} near-tie partings (margin < {NEAR_TIE}) at steps {min(steps)}-"
            f"{max(steps)}, median {int(np.median(steps))}")


def cache_bytes_per_slot(eng) -> float:
    """Bytes of an engine's KV cache (every tensor of it) per batch slot."""
    tensors = [getattr(eng.cache, f.name) for f in dataclasses.fields(eng.cache)]
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t)) / len(
        eng.slots)


def serve_phase(gen: torch.Generator, stamp: str, spec, tmp: str) -> dict:
    """The rest of one-device serving.  First the position-map kernels
    (rows 1 and 11 under ``kv_positions``: the wgmma forward's position
    walk, the fp32 template's and the decode grid's kPos instances, the
    8-bit caches' template and decode instances) against their plain
    versions (``onchip.POS_CASES``: prefill chunks of 128 rows and decode
    tokens over a 768-slot rolling cache wrapped up to six times, slots
    shuffled and 5% holes, W 512 with 4 (and 70) sinks, the softcap and
    ALiBi, D 64 and 128, bf16 and fp32, ladder, peaked, spike and negative
    fixtures).  Then the main path at full width (the windowed FlashLM,
    W 512, 4 sinks): 16 greedy requests of 64-3000 tokens through
    ``DecodeEngine(rolling=True)`` dense and int8 beside the windowed dense
    and int8 engines at max_len 4096 (streams equal but at near ties; the
    position instances launched, the index-space instances never; cache
    bytes per slot; teacher-forced logits past the capacity); then, on the
    same weights without the window, ``multi_step=4`` (dense and paged
    int8) beside one step, speculative serving with a 2-layer d 512 draft
    (dense, int8 and paged targets) and with the target as its own draft,
    beam search, a snapshot restored into a fresh engine, and the
    weight-only int8 tree.  Then each position kernel's time beside the
    index-space windowed kernel's on a linear cache with the same visible
    pairs, its bound over the visible pairs and SDPA's under the positions'
    boolean mask.  Returns the records' ``pos_*`` keys and the runs'
    numbers."""
    from flash_attention_metal_tpu_torch.harness import onchip, serving
    from flash_attention_metal_tpu_torch.kernels import flash_tri as ft
    from flash_attention_metal_tpu_torch.kernels import paged as pg
    from flash_attention_metal_tpu_torch.kernels import quant as qt
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import flash_fwd_general, flash_fwd_lean
    from flash_attention_metal_tpu_torch.models.transformer import forward, init_params, weight
    from flash_attention_metal_tpu_torch.models.wquant import quantize_weights, weight_bytes
    from flash_attention_metal_tpu_torch.runtime.beam import beam_search_generate
    from flash_attention_metal_tpu_torch.runtime.engine import DecodeEngine
    from flash_attention_metal_tpu_torch.runtime.speculative import speculative_generate
    from flash_attention_metal_tpu_torch.utils import roofline
    from flash_attention_metal_tpu_torch.utils.checkpoint import restore_pytree, save_pytree

    t_phase = time.perf_counter()
    counters = (flash_fwd_general, qt.flash_attention_quant, pg.flash_attention_paged,
                pg.flash_attention_paged_quant, flash_fwd_lean, ft.flash_attention_tri)

    def reset():
        for fn in counters:
            fn.launches = 0
        flash_fwd_general.pos_launches = qt.flash_attention_quant.pos_launches = 0

    # 1. Each position kernel against its plain version.
    errs = {}  # (record, tag) -> worst error; tag: bf16 / d128 / fp32
    cases = onchip.pos_cases(gen)
    for name, case in cases.items():
        err, lse_err = onchip.pos_error(case)
        q = case[1]
        tol = onchip.TOL[q.dtype]
        check(err <= tol and lse_err <= tol,
              f"{name}: position-map kernel vs plain o {err:.3e} lse {lse_err:.3e} > {tol}")
        rec = "flash_fwd" if case[0] == "fwd" else "flash_quant"
        tag = "fp32" if q.dtype == torch.float32 else "d128" if q.shape[-1] == 128 else "bf16"
        errs[(rec, tag)] = max(errs.get((rec, tag), 0.0), err, lse_err)
        print(f"[pos-kernel] {name}: {case[0]} q {list(q.shape)} over {case[4].shape[1]} slots "
              f"a batch; o {err:.3e} lse {lse_err:.3e} (tol {tol})")

    # 2. Rolling serving at full width against the windowed dense engines.
    win = dict(window=onchip.WINDOW, sinks=onchip.SINKS)
    ref_eng, cfg = serving.build_engine(
        **serving.FLASHLM_D2048, max_batch=MAX_BATCH, max_len=ROLL_MAX_LEN, seed=SEED,
        device="cuda", **win)
    params = ref_eng.params
    vocab = cfg.vocab_size
    requests = greedy_requests(N_REQUESTS, vocab, ROLL_PROMPT_LENS, MAX_NEW, SEED + 7)
    long_ = sum(len(r.prompt) > onchip.ROLL_CAP for r in requests)
    check(2 * long_ >= len(requests), f"{long_} of {len(requests)} rolling prompts pass the "
          f"{onchip.ROLL_CAP}-slot capacity: at least half must")
    prng = np.random.default_rng(SEED + 8)
    roll_prompts = [prng.integers(1, vocab, n).tolist() for n in ROLL_CHECK_PROMPTS]
    out_serve = {}
    pos_launches = {"flash_fwd": 0, "flash_quant": 0}

    def serve(eng, reqs, mode):
        eng.submit(serving.Request(uid=-1, prompt=list(range(1, 101)), max_new_tokens=4))
        eng.run()
        reset()
        reqs = [dataclasses.replace(r, generated=[], logprobs=[], slot=None, done=False)
                for r in reqs]
        bench = serving.run_serving_bench(eng, reqs, mode=mode, log=lambda m: None)
        check(all(r.done and len(r.generated) == r.max_new_tokens for r in reqs),
              f"{mode}: every request finishes")
        return reqs, bench

    for mode, kv_quant in (("rolling", None), ("rolling_int8", "int8")):
        linear = ref_eng if kv_quant is None else DecodeEngine(
            params, cfg, max_batch=MAX_BATCH, max_len=ROLL_MAX_LEN, seed=SEED, kv_quant=kv_quant)
        want, bench_lin = serve(linear, requests, f"windowed {kv_quant or 'dense'}")
        lin_launch = (flash_fwd_general if kv_quant is None else qt.flash_attention_quant)
        lin_counts = (lin_launch.launches, lin_launch.pos_launches)
        check(lin_counts[0] > 0 and lin_counts[1] == 0,
              f"the linear engine takes the index-space instances: {lin_counts}")
        eng = DecodeEngine(params, cfg, max_batch=MAX_BATCH, max_len=ROLL_MAX_LEN, seed=SEED,
                           **serving.SERVING_MODES[mode][0])
        got, bench = serve(eng, requests, mode)
        counted = flash_fwd_general if kv_quant is None else qt.flash_attention_quant
        n_pos, n_all = counted.pos_launches, counted.launches
        n_other = sum(fn.launches for fn in counters if fn is not counted)
        check(n_pos > 0 and n_pos == n_all and n_other == 0,
              f"{mode} serving launches only the position instances: {n_pos} of {n_all}, "
              f"others {n_other}")
        pos_launches["flash_fwd" if kv_quant is None else "flash_quant"] += n_pos
        partings = stream_partings(params, cfg, got, want, mode)
        bound = serving.SERVING_MODES[mode][1]
        rel = serving.teacher_forced_errors(params, cfg, roll_prompts, 16, ROLL_MAX_LEN,
                                            seed=SEED, mode=mode)
        worst = float(np.max(rel))
        check(worst <= bound, f"{mode} served logits rel L2 {worst:.3e} > {bound}")
        slot_bytes, lin_bytes = cache_bytes_per_slot(eng), cache_bytes_per_slot(linear)
        out_serve[mode] = {
            "tokens_per_s": bench["tokens_per_s"], "ms_per_step": bench["ms_per_step"],
            "linear_tokens_per_s": bench_lin["tokens_per_s"],
            "linear_ms_per_step": bench_lin["ms_per_step"], "pos_launches": n_pos,
            "linear_launches": lin_counts[0], "near_tie_partings": partings,
            "served_logits_rel_l2_max": worst, "cache_bytes_per_slot": slot_bytes,
            "linear_cache_bytes_per_slot": lin_bytes, "prompts_past_capacity": long_}
        print(f"[serve-rolling] {mode}: {N_REQUESTS} greedy requests x {MAX_NEW} tokens, prompts "
              f"{min(len(r.prompt) for r in requests)}-{max(len(r.prompt) for r in requests)} "
              f"({long_} past the {eng.cache.capacity}-slot cache): {bench['tokens_per_s']:.1f} "
              f"tok/s, {bench['ms_per_step']:.3f} ms/step (windowed max_len {ROLL_MAX_LEN}: "
              f"{bench_lin['tokens_per_s']:.1f} tok/s, {bench_lin['ms_per_step']:.3f} ms/step); "
              f"position instances {n_pos} launches, index-space {n_all - n_pos}, others "
              f"{n_other} (the windowed engine: index-space {lin_counts[0]}); greedy streams equal "
              f"but {partings_text(partings)}; teacher-forced logits rel L2 "
              f"max {worst:.3e} (tol {bound}) at prompts {list(ROLL_CHECK_PROMPTS)}; cache "
              f"{slot_bytes / 2**20:.2f} MiB a slot ({eng.cache.capacity} rows) against "
              f"{lin_bytes / 2**20:.2f} MiB ({ROLL_MAX_LEN} rows) {stamp}")
        if linear is not ref_eng:
            del linear
        del eng
        torch.cuda.empty_cache()
    del ref_eng
    torch.cuda.empty_cache()

    # 3. multi_step, speculative, beam, snapshot and weight-only int8 on
    # the same weights without the window.
    plain_cfg = dataclasses.replace(cfg, attn_window=None, attn_sinks=0)
    reqs = greedy_requests(N_REQUESTS, vocab, PROMPT_LENS, MAX_NEW, SEED + 9)
    single = {}
    for mode, opts in (("dense", {}), ("paged_int8", dict(paged=True, kv_quant="int8"))):
        one, bench1 = serve(DecodeEngine(params, plain_cfg, max_batch=MAX_BATCH,
                                         max_len=MAX_LEN, seed=SEED, **opts), reqs, mode)
        single[mode] = one
        multi, bench4 = serve(DecodeEngine(params, plain_cfg, max_batch=MAX_BATCH,
                                           max_len=MAX_LEN, seed=SEED, multi_step=MULTI_STEP,
                                           **opts), reqs, f"{mode} multi_step {MULTI_STEP}")
        partings = stream_partings(params, plain_cfg, multi, one, f"{mode} multi_step")
        out_serve[f"multi_step_{mode}"] = {
            "ms_per_step": bench4["ms_per_step"], "tokens_per_s": bench4["tokens_per_s"],
            "single_ms_per_step": bench1["ms_per_step"],
            "single_tokens_per_s": bench1["tokens_per_s"], "steps": bench4["decode_steps"],
            "single_steps": bench1["decode_steps"], "near_tie_partings": partings}
        print(f"[serve-multi] {mode} multi_step={MULTI_STEP}: {bench4['ms_per_step']:.3f} ms/step, "
              f"{bench4['tokens_per_s']:.1f} tok/s over {bench4['decode_steps']} steps (harvest "
              f"lag 16 dispatches) against one step {bench1['ms_per_step']:.3f} "
              f"ms/step, {bench1['tokens_per_s']:.1f} tok/s over {bench1['decode_steps']} steps; "
              f"greedy streams equal but "
              f"{partings_text(partings)} {stamp}")
        torch.cuda.empty_cache()
    bound = serving.SERVING_MODES["multi_step_8"][1]
    check_prompts = [prng.integers(1, vocab, n).tolist() for n in CHECK_PROMPTS]
    rel = serving.teacher_forced_errors(params, plain_cfg, check_prompts, 16, MAX_LEN, seed=SEED,
                                        mode="multi_step_8")
    check(max(rel) <= bound, f"multi_step_8 served logits rel L2 {max(rel):.3e} > {bound}")
    out_serve["multi_step_8_served_logits_rel_l2_max"] = float(max(rel))

    draft = serving.draft_model(plain_cfg, serving.DRAFT_D512, SEED, "cuda")
    for mode, opts in (("dense", {}), ("int8", dict(kv_quant="int8")), ("paged", dict(paged=True))):
        want = single.get(mode)
        if want is None:
            want, _ = serve(DecodeEngine(params, plain_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                                         seed=SEED, **opts), reqs, mode)
        got, bench = serve(DecodeEngine(params, plain_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                                        seed=SEED, draft=draft, spec_gamma=SPEC_GAMMA, **opts),
                           reqs, f"{mode} speculative")
        partings = stream_partings(params, plain_cfg, got, want, f"{mode} speculative")
        out_serve[f"speculative_{mode}"] = {
            "tokens_per_s": bench["tokens_per_s"], "rounds": bench["decode_steps"],
            "near_tie_partings": partings}
        print(f"[serve-spec] {mode} target, draft 2 x d512, gamma {SPEC_GAMMA}: "
              f"{bench['tokens_per_s']:.1f} tok/s over {bench['decode_steps']} rounds; greedy "
              f"streams equal the plain engine's but {partings_text(partings)} {stamp}")
        torch.cuda.empty_cache()
    rel = serving.teacher_forced_errors(params, plain_cfg, check_prompts, 15, MAX_LEN, seed=SEED,
                                        mode="speculative")
    bound = serving.SERVING_MODES["speculative"][1]
    check(max(rel) <= bound, f"speculative verify-chunk logits rel L2 {max(rel):.3e} > {bound}")
    out_serve["speculative_served_logits_rel_l2_max"] = float(max(rel))
    stats = {}
    speculative_generate(params, plain_cfg, params, plain_cfg, [r.prompt for r in reqs[:8]],
                         MAX_NEW, gamma=SPEC_GAMMA, seed=SEED, stats=stats)
    per_round = stats["emitted"] / stats["slot_rounds"]
    check(per_round > SPEC_GAMMA, f"self-draft tokens per round {per_round:.3f} <= {SPEC_GAMMA}")
    out_serve["speculative_self_draft_tokens_per_round"] = per_round
    print(f"[serve-spec] the target as its own draft: {per_round:.3f} tokens a slot a round "
          f"(gamma {SPEC_GAMMA}; {stats['emitted']} tokens in {stats['slot_rounds']} slot-rounds)"
          f" {stamp}")
    del draft
    torch.cuda.empty_cache()

    prompt = prng.integers(1, vocab, BEAM_PROMPT).tolist()
    t0 = time.perf_counter()
    toks, score = beam_search_generate(params, plain_cfg, prompt, beam_width=BEAM_WIDTH,
                                       max_new_tokens=BEAM_NEW, max_len=1024)
    beam_s = time.perf_counter() - t0
    with torch.no_grad():
        logits = forward(params, torch.tensor([prompt + toks], device="cuda"), plain_cfg)[0]
        logp = torch.log_softmax(logits.float(), dim=-1)
        ref = float(sum(logp[len(prompt) - 1 + i, t] for i, t in enumerate(toks)))
    beam_rel = abs(score - ref) / abs(ref)
    check(len(toks) == BEAM_NEW and beam_rel <= BEAM_REL_TOL,
          f"beam score {score:.4f} vs its tokens' summed log-probabilities {ref:.4f}: rel "
          f"{beam_rel:.3e} > {BEAM_REL_TOL}")
    out_serve["beam"] = {"score": score, "prefill_logprob_sum": ref, "rel_err": beam_rel,
                         "seconds": beam_s}
    print(f"[serve-beam] width {BEAM_WIDTH}, a {BEAM_PROMPT}-token prompt, {BEAM_NEW} tokens: "
          f"score {score:.4f}, one prefill of prompt + tokens sums {ref:.4f} (rel {beam_rel:.3e},"
          f" tol {BEAM_REL_TOL}); {beam_s:.2f} s {stamp}")

    # A snapshot mid-run, saved to disk, restored into a fresh engine: every
    # stream and its log-probabilities, of the engine that went on and of
    # the restored one, equal an uninterrupted run's bit for bit.
    snap_opts = dict(paged=True, kv_quant="int8")

    def mixed():
        return serving.make_requests(N_REQUESTS, vocab, PROMPT_LENS, MAX_NEW, SEED + 10)

    eng_c = DecodeEngine(params, plain_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=SEED,
                         **snap_opts)
    for r in mixed():
        eng_c.submit(r)
    eng_c.run()
    want = {u: (r.generated, r.logprobs) for u, r in eng_c.finished.items()}
    del eng_c
    torch.cuda.empty_cache()
    eng_a = DecodeEngine(params, plain_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=SEED,
                         **snap_opts)
    for r in mixed():
        eng_a.submit(r)
    for _ in range(SNAPSHOT_STEPS):
        eng_a.step()
    snap = eng_a.snapshot()
    path = os.path.join(tmp, "serving_snapshot.pt")
    save_pytree(path, snap)
    before = {u: (list(r.generated), list(r.logprobs)) for u, r in eng_a.finished.items()}
    eng_a.run()
    eng_b = DecodeEngine(params, plain_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=SEED + 99,
                         **snap_opts)
    eng_b.restore(restore_pytree(path))
    eng_b.finished = {}
    eng_b.run()
    resumed = {**before, **{u: (r.generated, r.logprobs) for u, r in eng_b.finished.items()}}
    went_on = {u: (r.generated, r.logprobs) for u, r in eng_a.finished.items()}
    same = sum(resumed.get(u) == w for u, w in want.items())
    same_on = sum(went_on.get(u) == w for u, w in want.items())
    check(len(want) == N_REQUESTS and same == N_REQUESTS and same_on == N_REQUESTS,
          f"snapshot/restore: {same} restored and {same_on} continued of {N_REQUESTS} streams "
          f"and log-probabilities equal the uninterrupted run's")
    out_serve["snapshot"] = {"steps_before": SNAPSHOT_STEPS, "bytes": os.path.getsize(path),
                             "streams_equal": same, "continued_streams_equal": same_on}
    print(f"[serve-snapshot] paged int8 engine, 16 requests (half sampled), snapshot after "
          f"{SNAPSHOT_STEPS} steps ({os.path.getsize(path) / 2**20:.1f} MiB on disk) restored "
          f"into a fresh engine: {same} restored and {same_on} continued of {N_REQUESTS} "
          f"streams and log-probabilities equal an uninterrupted run's bit for bit {stamp}")
    del eng_a, eng_b, snap
    torch.cuda.empty_cache()

    # Weight-only int8 of the fp32 masters (as JAX quantizes them).
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(SEED)
    masters = init_params(plain_cfg, wgen, master_dtype=torch.float32)
    qparams = quantize_weights(masters)
    ratio = weight_bytes(qparams) / weight_bytes(masters)
    ratio_bf16 = weight_bytes(qparams) / weight_bytes(params)
    check(ratio < 0.45, f"weight-only int8 bytes {ratio:.3f} of the fp32 tree's >= 0.45")
    bound = serving.SERVING_MODES["weight_int8"][1]
    rel = serving.teacher_forced_errors(masters, plain_cfg, check_prompts, 16, MAX_LEN, seed=SEED,
                                        mode="weight_int8")
    check(max(rel) <= bound, f"weight_int8 served logits rel L2 {max(rel):.3e} > {bound}")
    rel_orig = serving.teacher_forced_errors(masters, plain_cfg, check_prompts, 16, MAX_LEN,
                                             seed=SEED, mode="weight_int8",
                                             reference_params=masters)
    got, bench = serve(DecodeEngine(qparams, plain_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                                    seed=SEED), reqs, "weight_int8")
    w_q, w_b = qparams["layers"][0]["w_up"], params["layers"][0]["w_up"]
    x = torch.randn((MAX_BATCH, plain_cfg.d_model), device="cuda", dtype=plain_cfg.dtype)
    deq_ms = onchip.device_ms(lambda: x @ weight(w_q, plain_cfg.dtype))
    bf16_ms = onchip.device_ms(lambda: x @ w_b)
    out_serve["weight_int8"] = {
        "bytes_over_fp32": ratio, "bytes_over_bf16": ratio_bf16,
        "served_logits_rel_l2_max": float(max(rel)),
        "rel_l2_vs_unquantized": float(max(rel_orig)), "tokens_per_s": bench["tokens_per_s"],
        "ms_per_step": bench["ms_per_step"], "w_up_dequant_matmul_ms": deq_ms,
        "w_up_bf16_matmul_ms": bf16_ms}
    print(f"[serve-wint8] weight-only int8: {ratio:.3f} of the fp32 tree's bytes "
          f"({ratio_bf16:.3f} of the bf16 tree's: the embedding stays), served logits rel L2 max "
          f"{max(rel):.3e} against the dequantized fp32 forward (tol {bound}), "
          f"{max(rel_orig):.3e} against the unquantized; {bench['tokens_per_s']:.1f} tok/s, "
          f"{bench['ms_per_step']:.3f} ms/step; the w_up product at decode (dequantize + "
          f"matmul) {deq_ms:.4f} ms against bf16 {bf16_ms:.4f} ms {stamp}")
    del masters, qparams
    torch.cuda.empty_cache()

    # 4. Times: each position kernel at the rolling path's shapes beside the
    # index-space windowed kernel on a linear cache with the same visible
    # pairs, its bound over the visible pairs and SDPA under the positions'
    # boolean mask.
    out = {"flash_fwd": {}, "flash_quant": {}}
    for rec_name, name, key in (("flash_fwd", "pos_prefill_bf16", "prefill"),
                                ("flash_fwd", "pos_decode_bf16", "decode"),
                                ("flash_fwd", "pos_prefill_bf16_d128", "prefill_d128"),
                                ("flash_fwd", "pos_decode_bf16_d128", "decode_d128"),
                                ("flash_fwd", "pos_prefill_fp32", "prefill_fp32"),
                                ("flash_fwd", "pos_decode_fp32", "decode_fp32"),
                                ("flash_quant", "pos_prefill_int8", "prefill"),
                                ("flash_quant", "pos_decode_int8", "decode"),
                                ("flash_quant", "pos_prefill_int8_d128", "prefill_d128"),
                                ("flash_quant", "pos_decode_int8_d128", "decode_d128")):
        case = cases[name]
        q = case[1]
        call = lambda: onchip.pos_call(case)
        lin_call = lambda: onchip.pos_call(case, linear=True)
        flops, nbytes = onchip.pos_work(case)
        bits = 32 if q.dtype == torch.float32 else 16
        r = {f"pos_ms_{key}": onchip.device_ms(call),
             f"pos_linear_ms_{key}": onchip.device_ms(lin_call),
             f"pos_plain_ms_{key}": onchip.device_ms(lambda: onchip.pos_call(case, plain=True),
                                                     iters=5),
             f"pos_bound_ms_{key}": roofline.roofline_time(flops, nbytes, spec, bits) * 1e3,
             f"pos_bound_by_{key}": roofline.bound_by(flops, nbytes, spec, bits),
             f"pos_library_ms_{key}": onchip.pos_sdpa_ms(case)}
        out[rec_name].update(r)
        print(f"[pos-time] {rec_name} {key} ({name}: q {list(q.shape)}, {case[4].shape[1]} slots):"
              f" position map {r[f'pos_ms_{key}']:.4f} ms, index-space windowed on a linear cache"
              f" {r[f'pos_linear_ms_{key}']:.4f} ms, plain {r[f'pos_plain_ms_{key}']:.4f} ms, "
              f"bound {r[f'pos_bound_ms_{key}']:.4f} ms ({r[f'pos_bound_by_{key}']}), SDPA under "
              f"the positions' mask {r[f'pos_library_ms_{key}']:.4f} ms {stamp}")
    for rec_name in out:
        out[rec_name]["pos_launches"] = pos_launches[rec_name]
        out[rec_name]["pos_source"] = ("flash_attention_metal_tpu_torch/csrc/flash_fwd_sm90.cuh "
                                       "(PosWalk), flash_fwd.cu, flash_decode.cuh (kPos)")
        for tag in ("bf16", "d128", "fp32"):
            if (rec_name, tag) in errs:
                out[rec_name]["pos_max_err" + ("" if tag == "bf16" else f"_{tag}")] = errs[
                    (rec_name, tag)]
    print(f"[serve-phase] {time.perf_counter() - t_phase:.1f} s {stamp}")
    return {"records": out, "serving": out_serve}


def pos_seg_phase(gen: torch.Generator, stamp: str, spec, planted) -> dict:
    """Position maps with segment ids on the card (row 1: the wgmma
    forward's segmented position walk for bf16, decode-sized calls
    included, the fp32 template's segmented kPos instance), each case of
    ``onchip.POS_SEG_CASES`` (the 768-slot rolling cache wrapped and
    shuffled, slot ids changing inside a 64-slot tile, row ids inside a Q
    tile, a row or a decode batch whose id no slot holds) against its plain
    version, one kPos launch a call; then the same checks on a library
    built with ``onchip.POS_SEG_IGNORED`` planted (``planted()`` returns
    its path: both segmented walks ignore the ids), which must fail them;
    then each segmented call's time beside the unsegmented position walk's
    on the same case, its bound over the visible pairs and SDPA's under the
    positions' and ids' boolean mask.  Returns the flash_fwd record's
    ``pos_seg_*`` keys."""
    import ctypes

    from flash_attention_metal_tpu_torch.harness import onchip
    from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
    from flash_attention_metal_tpu_torch.utils import roofline

    t_phase = time.perf_counter()
    cases = onchip.pos_cases(gen, table=onchip.POS_SEG_CASES)
    errs, launches = {}, 0
    for name, case in cases.items():
        before = ff.flash_fwd_general.pos_launches
        err, lse_err = onchip.pos_error(case)
        q = case[1]
        tol = onchip.TOL[q.dtype]
        n = ff.flash_fwd_general.pos_launches - before
        launches += n
        check(n == 1, f"{name}: {n} position-walk launches for one call")
        check(err <= tol and lse_err <= tol,
              f"{name}: segmented position walk vs plain o {err:.3e} lse {lse_err:.3e} > {tol}")
        tag = "fp32" if q.dtype == torch.float32 else "d128" if q.shape[-1] == 128 else "bf16"
        errs[tag] = max(errs.get(tag, 0.0), err, lse_err)
        seg = case[5]["segment_ids"]
        print(f"[pos-seg] {name}: q {list(q.shape)} over {case[4].shape[1]} slots, kv ids cut at "
              f"slot {onchip.POS_SEG_KV_CUT}, q ids {sorted(set(seg.q.flatten().tolist()))}; "
              f"o {err:.3e} lse {lse_err:.3e} (tol {tol})")

    lib = ff.bind(ctypes.CDLL(str(planted())))
    saved = ff._lib
    ff._lib = lambda: lib
    try:
        for name in ("pos_seg_prefill_bf16_peaked", "pos_seg_decode_bf16", "pos_seg_prefill_fp32",
                     "pos_seg_decode_fp32"):
            tol = onchip.TOL[cases[name][1].dtype]
            faulty = max(onchip.pos_error(cases[name]))
            check(not faulty <= tol, f"{name}: the planted walk that ignores the ids passes "
                  f"({faulty:.3e} <= {tol})")
            print(f"[pos-seg] planted fault (the segmented walks ignore the ids) on {name}: "
                  f"{faulty:.3e} > {tol}, as it must")
    finally:
        ff._lib = saved

    out = {"pos_seg_launches_checks": launches}
    for name, key in (("pos_seg_prefill_bf16", "prefill"), ("pos_seg_decode_bf16", "decode"),
                      ("pos_seg_prefill_fp32", "prefill_fp32"),
                      ("pos_seg_decode_fp32", "decode_fp32")):
        case = cases[name]
        q = case[1]
        unseg = case[:5] + ({k: v for k, v in case[5].items() if k != "segment_ids"},)
        flops, nbytes = onchip.pos_work(case)
        bits = 32 if q.dtype == torch.float32 else 16
        r = {f"pos_seg_ms_{key}": onchip.device_ms(lambda: onchip.pos_call(case)),
             f"pos_seg_unsegmented_ms_{key}": onchip.device_ms(lambda: onchip.pos_call(unseg)),
             f"pos_seg_plain_ms_{key}": onchip.device_ms(
                 lambda: onchip.pos_call(case, plain=True), iters=5),
             f"pos_seg_bound_ms_{key}": roofline.roofline_time(flops, nbytes, spec, bits) * 1e3,
             f"pos_seg_bound_by_{key}": roofline.bound_by(flops, nbytes, spec, bits),
             f"pos_seg_library_ms_{key}": onchip.pos_sdpa_ms(case)}
        out.update(r)
        print(f"[pos-seg-time] {key} ({name}: q {list(q.shape)}, {case[4].shape[1]} slots): "
              f"segmented {r[f'pos_seg_ms_{key}']:.4f} ms, the unsegmented position walk "
              f"{r[f'pos_seg_unsegmented_ms_{key}']:.4f} ms, plain "
              f"{r[f'pos_seg_plain_ms_{key}']:.4f} ms, bound {r[f'pos_seg_bound_ms_{key}']:.4f} ms "
              f"({r[f'pos_seg_bound_by_{key}']}), SDPA under the positions' and ids' mask "
              f"{r[f'pos_seg_library_ms_{key}']:.4f} ms {stamp}")
    for tag, err in errs.items():
        out["pos_seg_max_err" + ("" if tag == "bf16" else f"_{tag}")] = err
    out["pos_seg_source"] = ("flash_attention_metal_tpu_torch/csrc/flash_fwd_sm90.cuh "
                             "(PosSegWalk), flash_fwd.cu (kPosSeg)")
    print(f"[pos-seg-phase] {time.perf_counter() - t_phase:.1f} s {stamp}")
    return out


def family_counters() -> dict:
    """The attention kernels' wrappers the families' paths can reach, by
    record name."""
    from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
    from flash_attention_metal_tpu_torch.kernels import flash_tri as ft
    from flash_attention_metal_tpu_torch.kernels import paged as pg
    from flash_attention_metal_tpu_torch.kernels import quant as qt
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import flash_fwd_general, flash_fwd_lean

    return {"flash_fwd": flash_fwd_general, "flash_lean": flash_fwd_lean,
            "flash_tri": ft.flash_attention_tri, "flash_tri_bwd": ft.flash_attention_bwd_tri,
            "flash_bwd_dkv": fb.flash_bwd_dkv, "flash_bwd_dq": fb.flash_bwd_dq,
            "flash_bwd_fused": fb.flash_bwd_fused, "flash_quant": qt.flash_attention_quant,
            "flash_paged": pg.flash_attention_paged,
            "flash_paged_quant": pg.flash_attention_paged_quant}


def counted(fn) -> tuple:
    """``(fn()'s result, launches of each family counter during it)``: every
    count set to 0 just before and read just after."""
    counters = family_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counters.items() if c.launches}


def adam_steps(loss, params, batch: tuple, steps: int, lr: float) -> tuple:
    """``steps`` AdamW steps (constant ``lr``, clip 1.0) of ``loss(params,
    *batch)`` on one batch, in place: the losses and the median step ms
    after the first."""
    from flash_attention_metal_tpu_torch.models.trainer import constant_adamw
    from flash_attention_metal_tpu_torch.models.transformer import value_and_grad

    opt = constant_adamw(lr, grad_clip=1.0)
    state = opt.init(params)
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, grads = value_and_grad(loss, params, *batch)
        opt.update(grads, state, params)
        losses.append(float(value))
        times.append(time.perf_counter() - t0)
    return losses, float(np.median(times[1:])) * 1e3


def falling(losses: list) -> bool:
    return all(np.isfinite(losses)) and losses[-1] < losses[0]


def launches_text(counts: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in sorted(counts.items())) or "none"


def moe_served_errors(params, cfg, prompts: list, mode: str) -> tuple:
    """Served logits of an MoE model against the plain forward, the worst
    relative L2 over the teacher-forced rows and how many rows over the
    bound a router near tie excuses.

    Routing is discrete: a rounding that crosses a tie at the router's
    top-k edge sends a token to another expert.  So both sides run an fp32
    copy of the weights (the card's fp32 kernel instances; the oracle
    attention), where the served path and the plain forward differ by
    ~1e-6, and under an 8-bit cache the plain forward attends over K and V
    round-tripped through the same per-token int8 quantization (the
    cache's own arithmetic, which bf16 logits cannot absorb at a tie).  A
    row may exceed the bound only where the plain forward's router holds a
    gap under ``MOE_NEAR_TIE`` at the top-k edge in some layer."""
    from flash_attention_metal_tpu_torch.harness import serving
    from flash_attention_metal_tpu_torch.kernels.quant import dequantize_kv, quantize_kv
    from flash_attention_metal_tpu_torch.models import transformer
    from flash_attention_metal_tpu_torch.models.transformer import map_params

    fp = map_params(lambda t: t.float(), params)
    fcfg = dataclasses.replace(cfg, dtype=torch.float32)
    attend = transformer.flash_attention
    kv_quant = serving.SERVING_MODES[mode][0].get("kv_quant")

    def round_trip(q, k, v, **kw):
        k, v = dequantize_kv(quantize_kv(k, v, torch.int8), k.dtype)
        return attend(q, k, v, **kw)

    if kv_quant is not None:
        check(kv_quant == "int8", f"the MoE check takes an int8 cache, not {kv_quant}")
        transformer.flash_attention = round_trip
    try:
        errs = serving.teacher_forced_errors(fp, fcfg, prompts, 16, MAX_LEN, seed=SEED, mode=mode)
    finally:
        transformer.flash_attention = attend
    bound = serving.SERVING_MODES[mode][1]
    if max(errs) <= bound:
        return float(max(errs)), 0
    gaps = moe_router_gaps(fp, fcfg, prompts, 16)
    ties = sum(e > bound and g < MOE_NEAR_TIE for e, g in zip(errs, gaps))
    return float(max([e for e, g in zip(errs, gaps) if g >= MOE_NEAR_TIE] or [0.0])), ties


def moe_router_gaps(params, cfg, prompts: list, n_decode: int) -> list:
    """For each row ``serving.teacher_forced_errors`` compares (each
    prompt's last token, then its ``n_decode`` seeded tokens), the smallest
    gap over the layers between the router's k-th and (k+1)-th largest
    probability in a plain forward of the same tokens (oracle attention,
    the model's dtype)."""
    from flash_attention_metal_tpu_torch.models import moe
    from flash_attention_metal_tpu_torch.models.transformer import forward

    cont = np.random.default_rng(SEED).integers(1, cfg.vocab_size, (len(prompts), n_decode))
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    router = moe._router_probs
    gaps = []
    for slot, prompt in enumerate(prompts):
        seen = []

        def spy(layer, h):
            probs = router(layer, h)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            seen.append(top[:, cfg.top_k - 1] - top[:, cfg.top_k])
            return probs

        moe._router_probs = spy
        try:
            with torch.no_grad():
                forward(params, torch.tensor([list(prompt) + cont[slot].tolist()], device="cuda"),
                        ref_cfg)
        finally:
            moe._router_probs = router
        gap = torch.stack(seen).amin(dim=0)
        gaps += gap[len(prompt) - 1: len(prompt) + n_decode].tolist()
    return gaps


def family_phase(gen: torch.Generator, stamp: str, spec) -> dict:
    """The one-device model families at their widths (PERF.md §4).

    * ``[family-moe]``: FlashLM at the serving width with Mixtral's routing
      (``MOE``: 8 experts, top-2, capacity factor 1.25), bf16, served by
      ``DecodeEngine(8, 2048)`` dense and paged int8 (16 requests; served
      logits within rel L2 5e-2 of the plain fp32 forward on the card,
      teacher-forced), the routed MLP's device time at decode; then
      ``MOE_TRAIN_STEPS`` AdamW steps of the capacity-bucketed MoE loss with
      the Switch aux loss at batch 1 x 2048 (depth ``MOE_TRAIN_LAYERS``),
      the loss falling.
    * ``[family-encoder]``: ``EncoderConfig``'s defaults (d 512, 4 layers, 8
      heads, length 512) with attention dropout 0.1 over a padded batch:
      the kernel path's hidden states against the oracle attention's
      (without dropout), then masked-LM AdamW steps with fresh seeds, the
      loss falling.
    * ``[family-seq2seq]``: ``Seq2SeqConfig``'s defaults: AdamW steps over
      padded sources, the loss falling; greedy decoding equal to the
      teacher-forced argmax of its own chain (but at near ties), and beam
      width 1 equal to greedy.
    * ``[family-lora]``: rank-8 attention adapters on FlashLM at d 2048
      (depth ``FAMILY_LAYERS``): AdamW steps, the loss falling, the base
      weights unchanged bit for bit; the merged tree served through the
      engine within the served-logits bound.
    * ``[family-muon]``: ``Trainer(optimizer=make_muon_optimizer(...))`` on
      the same FlashLM, the loss falling.
    * ``[family-llama]``: a seeded state dict with Hugging Face LLaMA names
      at TinyLlama-1.1B's published widths (``LLAMA``; depth
      ``LLAMA_LAYERS``) converted by ``models.convert`` (GQA group 8, head
      dim 64): the kernel path's logits within rel L2 5e-2 of the plain
      fp32 path, and served through the engine within the bound.

    Every run's attention launches are counted (``counted``) and must
    include its kernels.  Returns each kernel's ``family_launches`` and the
    families' numbers."""
    from types import SimpleNamespace

    from flash_attention_metal_tpu_torch.harness import onchip, serving
    from flash_attention_metal_tpu_torch.models import convert, encoder, lora, moe, muon, seq2seq
    from flash_attention_metal_tpu_torch.models.trainer import Trainer
    from flash_attention_metal_tpu_torch.models.transformer import (
        ModelConfig,
        forward,
        init_params,
        map_params,
        param_leaves,
    )
    from flash_attention_metal_tpu_torch.runtime.engine import DecodeEngine

    t_phase = time.perf_counter()
    fams, launches = {}, {}
    prng = np.random.default_rng(SEED + 20)

    def note(family: str, counts: dict) -> None:
        for name, n in counts.items():
            launches.setdefault(name, {})
            launches[name][family] = launches[name].get(family, 0) + n

    def serve_mode(params, cfg, mode, tag):
        eng = DecodeEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=SEED,
                           **serving.SERVING_MODES[mode][0])
        eng.submit(serving.Request(uid=-1, prompt=list(range(1, 101)), max_new_tokens=4))
        eng.run()
        reqs = serving.make_requests(N_REQUESTS, cfg.vocab_size, PROMPT_LENS, MAX_NEW, SEED + 21)
        bench, counts = counted(lambda: serving.run_serving_bench(eng, reqs, mode=mode,
                                                                  log=lambda m: None))
        check(all(r.done and len(r.generated) == MAX_NEW for r in reqs),
              f"{tag} {mode}: every request finishes")
        kernel = "flash_fwd" if mode == "dense" else "flash_paged_quant"
        check(counts.get(kernel, 0) > 0, f"{tag} {mode} serving launched {kernel}: {counts}")
        note(tag, counts)
        del eng
        torch.cuda.empty_cache()
        prompts = [prng.integers(1, cfg.vocab_size, n).tolist() for n in CHECK_PROMPTS]
        bound = serving.SERVING_MODES[mode][1]
        routed = hasattr(cfg, "n_experts")
        if routed:
            worst, ties = moe_served_errors(params, cfg, prompts, mode)
        else:
            worst = float(max(serving.teacher_forced_errors(params, cfg, prompts, 16, MAX_LEN,
                                                            seed=SEED, mode=mode)))
            ties = 0
        check(worst <= bound, f"{tag} {mode} served logits rel L2 {worst:.3e} > {bound}")
        return {"tokens_per_s": bench["tokens_per_s"], "ms_per_step": bench["ms_per_step"],
                "served_logits_rel_l2_max": worst, "router_near_tie_rows_over_bound": ties,
                "launches": counts}

    # MoE: served at the full width, then trained at a cut depth.
    d2048 = dict(vocab_size=serving.FLASHLM_D2048["vocab"], d_model=2048, n_heads=16,
                 n_kv_heads=8, head_dim=128, d_ff=4096)
    mcfg = moe.MoEConfig(**d2048, n_layers=serving.FLASHLM_D2048["n_layers"], **MOE)
    mgen = torch.Generator(device="cuda")
    mgen.manual_seed(SEED)
    mparams = moe.init_moe_params(mcfg, mgen, master_dtype=None)
    stack_bytes = sum(t.numel() * t.element_size() for layer in mparams["layers"]
                      for k, t in layer.items() if k in ("w_gate", "w_up", "w_down"))
    out = {"expert_stack_bytes": stack_bytes}
    for mode in ("dense", "paged_int8"):
        out[mode] = serve_mode(mparams, mcfg, mode, "moe")
        print(f"[family-moe] serve {mode}: d2048 L{mcfg.n_layers} {mcfg.n_experts} experts top-"
              f"{mcfg.top_k} ({stack_bytes / 1e9:.2f} GB of bf16 expert stacks), "
              f"{N_REQUESTS} requests: {out[mode]['tokens_per_s']:.1f} tok/s, "
              f"{out[mode]['ms_per_step']:.3f} ms/step; served logits rel L2 max "
              f"{out[mode]['served_logits_rel_l2_max']:.3e} (tol "
              f"{serving.SERVING_MODES[mode][1]}); launches {launches_text(out[mode]['launches'])} "
              f"{stamp}")
    x = torch.randn((MAX_BATCH, 1, mcfg.d_model), generator=mgen, device="cuda",
                    dtype=mcfg.dtype)
    layer = mparams["layers"][0]
    out["routed_mlp_decode_ms"] = onchip.device_ms(lambda: moe.moe_mlp_dense(layer, x, mcfg))
    out["routed_mlp_decode_bytes"] = stack_bytes / mcfg.n_layers
    print(f"[family-moe] the drop-free routed MLP of one layer at decode (batch {MAX_BATCH}): "
          f"{out['routed_mlp_decode_ms']:.4f} ms for {out['routed_mlp_decode_bytes'] / 1e6:.0f} "
          f"MB of expert weights (bound {out['routed_mlp_decode_bytes'] / spec.hbm_bw * 1e3:.4f}"
          f" ms) {stamp}")
    del mparams, layer
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(mcfg, n_layers=MOE_TRAIN_LAYERS)
    masters = moe.init_moe_params(tcfg, mgen)
    tokens = torch.randint(0, tcfg.vocab_size, (1, MAX_LEN), generator=mgen, device="cuda")
    (losses, step_ms), counts = counted(lambda: adam_steps(
        moe._moe_loss, masters, (tokens, tcfg), MOE_TRAIN_STEPS, FAMILY_LR))
    check(falling(losses), f"MoE training losses finite and falling: {losses}")
    check(all(counts.get(k, 0) > 0 for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")),
          f"MoE training launched the forward and the split pair: {counts}")
    note("moe", counts)
    with torch.no_grad():
        aux_share = float(moe._moe_loss(masters, tokens, tcfg)) - float(
            moe._moe_loss(masters, tokens, dataclasses.replace(tcfg, aux_loss_weight=0.0)))
    out["train"] = {"losses": losses, "step_ms": step_ms, "layers": MOE_TRAIN_LAYERS,
                    "aux_loss_term": aux_share, "launches": counts}
    print(f"[family-moe] train: {MOE_TRAIN_STEPS} AdamW steps of the capacity-bucketed loss "
          f"(capacity {moe._capacity(MAX_LEN, tcfg)} a expert) + Switch aux (term "
          f"{aux_share:.4f}), d2048 L{MOE_TRAIN_LAYERS} b1 s{MAX_LEN}: losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; step {step_ms:.2f} ms; launches "
          f"{launches_text(counts)} {stamp}")
    fams["moe"] = out
    del masters
    torch.cuda.empty_cache()

    # The encoder: its contract (segment ids and dropout in one call).
    ecfg = encoder.EncoderConfig(attn_dropout=0.1)
    egen = torch.Generator(device="cuda")
    egen.manual_seed(SEED + 1)
    eparams = encoder.init_params(ecfg, egen)
    n = ecfg.max_seq_len
    etok = torch.randint(1, ecfg.vocab_size, (FAMILY_BATCH, n), generator=egen, device="cuda")
    lengths = torch.randint(n // 3, n + 1, (FAMILY_BATCH,), generator=egen, device="cuda")
    lengths[0] = n
    emask = (torch.arange(n, device="cuda")[None] < lengths[:, None]).to(torch.int32)
    with torch.no_grad():
        kern = encoder.encode(eparams, etok, emask, cfg=ecfg).float()
        ref = encoder.encode(eparams, etok, emask,
                             cfg=dataclasses.replace(ecfg, dtype=torch.float32,
                                                     attn_impl="reference")).float()
    real = emask.bool()
    enc_rel = float((kern - ref)[real].norm() / ref[real].norm())
    check(enc_rel <= serving.LOGITS_REL_L2_TOL,
          f"encoder kernel path vs the oracle attention: rel L2 {enc_rel:.3e}")
    labels = etok.clone()
    loss_mask = (torch.rand(etok.shape, generator=egen, device="cuda") < 0.15).int() * emask
    corrupt = torch.where(loss_mask.bool(), torch.zeros_like(etok), etok)

    def enc_loss(p, seeds):
        return encoder.mlm_loss(p, corrupt, labels, loss_mask, emask, cfg=ecfg,
                                dropout_seeds=seeds)

    seeds = torch.randint(0, 2**31 - 1, (FAMILY_STEPS, ecfg.n_layers), generator=egen,
                          device="cuda", dtype=torch.int32)
    step_no = iter(range(FAMILY_STEPS))
    (losses, step_ms), counts = counted(lambda: adam_steps(
        lambda p: enc_loss(p, seeds[next(step_no)]), eparams, (), FAMILY_STEPS, FAMILY_LR))
    check(falling(losses), f"encoder training losses finite and falling: {losses}")
    check(all(counts.get(k, 0) > 0 for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")),
          f"encoder training launched the forward and the split pair: {counts}")
    note("encoder", counts)
    fams["encoder"] = {"rel_l2_vs_oracle": enc_rel, "losses": losses, "step_ms": step_ms,
                       "launches": counts}
    print(f"[family-encoder] d{ecfg.d_model} L{ecfg.n_layers} {ecfg.n_heads} heads, batch "
          f"{FAMILY_BATCH} x {n}, pads from {int(lengths.min())} tokens on, dropout "
          f"{ecfg.attn_dropout}: hidden states rel L2 {enc_rel:.3e} against the oracle attention "
          f"(tol {serving.LOGITS_REL_L2_TOL}); {FAMILY_STEPS} masked-LM AdamW steps: losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; step {step_ms:.2f} ms; launches "
          f"{launches_text(counts)} {stamp}")
    del eparams
    torch.cuda.empty_cache()

    # seq2seq: training, then greedy and beam decoding.
    scfg = seq2seq.Seq2SeqConfig()
    sgen = torch.Generator(device="cuda")
    sgen.manual_seed(SEED + 2)
    sparams = seq2seq.init_params(scfg, sgen)
    src = torch.randint(2, scfg.vocab_size, (FAMILY_BATCH, scfg.max_src_len), generator=sgen,
                        device="cuda")
    src_len = torch.randint(64, scfg.max_src_len + 1, (FAMILY_BATCH,), generator=sgen,
                            device="cuda")
    smask = (torch.arange(scfg.max_src_len, device="cuda")[None] < src_len[:, None]).int()
    tgt = torch.randint(2, scfg.vocab_size, (FAMILY_BATCH, S2S_TGT), generator=sgen,
                        device="cuda")
    (losses, step_ms), counts = counted(lambda: adam_steps(
        seq2seq.loss_fn, sparams, (src, tgt, scfg, smask), FAMILY_STEPS, FAMILY_LR))
    check(falling(losses), f"seq2seq training losses finite and falling: {losses}")
    check(all(counts.get(k, 0) > 0 for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")),
          f"seq2seq training launched the forward and the split pair: {counts}")
    note("seq2seq", counts)
    source = prng.integers(2, scfg.vocab_size, S2S_SOURCE).tolist()
    t0 = time.perf_counter()
    greedy, dec_counts = counted(lambda: seq2seq.greedy_generate(
        sparams, scfg, source, max_new_tokens=S2S_NEW))
    greedy_s = time.perf_counter() - t0
    check(len(greedy) == S2S_NEW and dec_counts.get("flash_fwd", 0) > 0,
          f"seq2seq greedy: {len(greedy)} tokens, launches {dec_counts}")
    note("seq2seq", dec_counts)
    s_pad = -(-len(source) // 128) * 128
    src1 = torch.zeros((1, s_pad), dtype=torch.int32, device="cuda")
    src1[0, : len(source)] = torch.tensor(source, device="cuda")
    mask1 = (torch.arange(s_pad, device="cuda") < len(source)).int()[None]
    with torch.no_grad():
        tf_logits = seq2seq.forward(sparams, src1, torch.tensor([[1] + greedy], device="cuda"),
                                    scfg, mask1)[0, :S2S_NEW]
    top2 = torch.topk(tf_logits, 2, dim=-1).values
    argmax = tf_logits.argmax(-1).tolist()
    partings = [t for t, (a, b) in enumerate(zip(argmax, greedy)) if a != b]
    near = [t for t in partings if float(top2[t, 0] - top2[t, 1]) < NEAR_TIE]
    check(partings == near, f"seq2seq greedy parts from the teacher-forced argmax at steps "
          f"{partings}, not all near ties ({near})")
    beam1, _ = seq2seq.beam_generate(sparams, scfg, source, beam_width=1, max_new_tokens=S2S_NEW)
    check(beam1 == greedy, "seq2seq beam width 1 equals greedy")
    beam4, score4 = seq2seq.beam_generate(sparams, scfg, source, beam_width=4,
                                          max_new_tokens=S2S_NEW)
    check(len(beam4) == S2S_NEW and np.isfinite(score4), "seq2seq beam width 4 finishes")
    fams["seq2seq"] = {"losses": losses, "step_ms": step_ms, "greedy_seconds": greedy_s,
                       "teacher_forced_partings": partings, "beam4_score": score4,
                       "launches": counts, "decode_launches": dec_counts}
    print(f"[family-seq2seq] d{scfg.d_model} L{scfg.enc_layers}+{scfg.dec_layers}, batch "
          f"{FAMILY_BATCH}, sources of {int(src_len.min())}-{scfg.max_src_len} tokens padded to "
          f"{scfg.max_src_len}, targets {S2S_TGT}: {FAMILY_STEPS} AdamW steps, losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; step {step_ms:.2f} ms; launches "
          f"{launches_text(counts)}; greedy {S2S_NEW} tokens from a {S2S_SOURCE}-token source "
          f"in {greedy_s:.2f} s (launches {launches_text(dec_counts)}) equal the teacher-forced "
          f"argmax but {len(partings)} near ties; beam width 1 equals greedy; width 4 score "
          f"{score4:.4f} {stamp}")
    del sparams
    torch.cuda.empty_cache()

    # LoRA and Muon on FlashLM at d 2048, a cut depth.
    fcfg = ModelConfig(**d2048, n_layers=FAMILY_LAYERS)
    fgen = torch.Generator(device="cuda")
    fgen.manual_seed(SEED + 3)
    base = init_params(fcfg, fgen, master_dtype=torch.float32)
    ftok = torch.randint(0, fcfg.vocab_size, (2, MAX_LEN // 2), generator=fgen, device="cuda")
    lcfg = lora.LoRAConfig()
    adapters = lora.init_lora(base, lcfg, fgen)
    before = [t.clone() for t in param_leaves(base)]
    step, init = lora.make_lora_train_step(fcfg, lcfg)
    state = init(adapters)

    def lora_run():
        losses = []
        for _ in range(FAMILY_STEPS):
            _, _, value = step(adapters, state, base, ftok)
            losses.append(float(value))
        return losses

    losses, counts = counted(lora_run)
    check(falling(losses), f"LoRA training losses finite and falling: {losses}")
    check(all(torch.equal(a, b) for a, b in zip(param_leaves(base), before)),
          "LoRA leaves the base weights unchanged bit for bit")
    check(counts.get("flash_bwd_dkv", 0) > 0, f"LoRA training launched the split pair: {counts}")
    note("lora", counts)
    merged = map_params(lambda t: t.to(fcfg.dtype) if t.ndim == 2 else t,
                        lora.merge_lora(base, adapters, lcfg))
    served = serve_mode(merged, fcfg, "dense", "lora")
    fams["lora"] = {"losses": losses, "adapter_params": lora.lora_num_params(adapters),
                    "served": served, "launches": counts}
    print(f"[family-lora] rank {lcfg.rank} on {', '.join(lcfg.targets)}, d2048 L{FAMILY_LAYERS}"
          f" b2 s{MAX_LEN // 2}: {lora.lora_num_params(adapters)} adapter parameters, "
          f"{FAMILY_STEPS} AdamW steps: losses " + ", ".join(f"{v:.4f}" for v in losses)
          + f"; base unchanged bit for bit; launches {launches_text(counts)}; the merged tree "
          f"served: {served['tokens_per_s']:.1f} tok/s, logits rel L2 max "
          f"{served['served_logits_rel_l2_max']:.3e} {stamp}")
    del merged, adapters, state
    torch.cuda.empty_cache()

    opt = muon.make_muon_optimizer(base)
    trainer = Trainer(fcfg, optimizer=opt, seed=SEED + 4, device="cuda")

    def muon_run():
        losses, times = [], []
        for _ in range(FAMILY_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.step(ftok))
            times.append(time.perf_counter() - t0)
        return losses, float(np.median(times[1:])) * 1e3

    (losses, step_ms), counts = counted(muon_run)
    check(falling(losses), f"Muon training losses finite and falling: {losses}")
    check(counts.get("flash_bwd_dkv", 0) > 0, f"Muon training launched the split pair: {counts}")
    note("muon", counts)
    n_muon = sum(lab == "muon" for lab in param_leaves(muon.muon_label_tree(base)))
    fams["muon"] = {"losses": losses, "step_ms": step_ms, "muon_leaves": n_muon,
                    "launches": counts}
    print(f"[family-muon] Trainer with make_muon_optimizer ({n_muon} hidden matrices on Muon, "
          f"the rest AdamW), d2048 L{FAMILY_LAYERS} b2 s{MAX_LEN // 2}: losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; step {step_ms:.2f} ms; launches "
          f"{launches_text(counts)} {stamp}")
    del trainer, opt, base
    torch.cuda.empty_cache()

    # LLaMA: a seeded state dict with Hugging Face names, converted.
    hf = SimpleNamespace(**LLAMA, num_hidden_layers=LLAMA_LAYERS, max_position_embeddings=2048,
                         rope_theta=10000.0)
    lgen = torch.Generator(device="cuda")
    lgen.manual_seed(SEED + 5)
    h, hd = hf.hidden_size, hf.hidden_size // hf.num_attention_heads

    def lin(n_out, n_in):
        return torch.randn((n_out, n_in), generator=lgen, device="cuda") * n_in**-0.5

    sd = {"model.embed_tokens.weight": torch.randn((hf.vocab_size, h), generator=lgen,
                                                   device="cuda") * 0.02,
          "model.norm.weight": torch.ones(h, device="cuda"),
          "lm_head.weight": lin(hf.vocab_size, h)}
    for i in range(LLAMA_LAYERS):
        pre = f"model.layers.{i}."
        sd.update({
            pre + "input_layernorm.weight": torch.ones(h, device="cuda"),
            pre + "post_attention_layernorm.weight": torch.ones(h, device="cuda"),
            pre + "self_attn.q_proj.weight": lin(h, h),
            pre + "self_attn.k_proj.weight": lin(hf.num_key_value_heads * hd, h),
            pre + "self_attn.v_proj.weight": lin(hf.num_key_value_heads * hd, h),
            pre + "self_attn.o_proj.weight": lin(h, h),
            pre + "mlp.gate_proj.weight": lin(hf.intermediate_size, h),
            pre + "mlp.up_proj.weight": lin(hf.intermediate_size, h),
            pre + "mlp.down_proj.weight": lin(h, hf.intermediate_size)})
    lcfg_, lparams = convert.convert_hf_llama(SimpleNamespace(config=hf, state_dict=lambda: sd),
                                              device="cuda", master_dtype=torch.bfloat16)
    del sd
    check((lcfg_.n_heads // lcfg_.n_kv_heads, lcfg_.head_dim) == (8, 64),
          f"the converted LLaMA is GQA group 8 at head dim 64: {lcfg_}")
    ltok = torch.randint(0, hf.vocab_size, (1, 512), generator=lgen, device="cuda")
    with torch.no_grad():
        kern_logits, counts = counted(lambda: forward(lparams, ltok, lcfg_))
        ref_logits = forward(lparams, ltok, dataclasses.replace(
            lcfg_, dtype=torch.float32, attn_impl="reference"))
    llama_rel = float((kern_logits - ref_logits).norm() / ref_logits.norm())
    check(llama_rel <= serving.LOGITS_REL_L2_TOL,
          f"converted LLaMA kernel path vs plain path: rel L2 {llama_rel:.3e}")
    check(counts.get("flash_fwd", 0) > 0, f"the LLaMA forward launched flash_fwd: {counts}")
    note("llama", counts)
    served = serve_mode(lparams, lcfg_, "dense", "llama")
    fams["llama"] = {"rel_l2_kernel_vs_plain": llama_rel, "served": served,
                     "launches": counts, "layers": LLAMA_LAYERS}
    print(f"[family-llama] a seeded Hugging Face state dict at TinyLlama-1.1B's widths (hidden "
          f"{h}, intermediate {hf.intermediate_size}, {hf.num_attention_heads}/"
          f"{hf.num_key_value_heads} heads, vocab {hf.vocab_size}; L{LLAMA_LAYERS}) converted: "
          f"kernel-path logits rel L2 {llama_rel:.3e} from the plain path (tol "
          f"{serving.LOGITS_REL_L2_TOL}); served {served['tokens_per_s']:.1f} tok/s, "
          f"{served['ms_per_step']:.3f} ms/step, logits rel L2 max "
          f"{served['served_logits_rel_l2_max']:.3e}; launches "
          f"{launches_text(served['launches'])} {stamp}")
    del lparams
    torch.cuda.empty_cache()
    fams["seconds"] = time.perf_counter() - t_phase
    print(f"[family-phase] {fams['seconds']:.1f} s {stamp}")
    return {"records": {name: {"family_launches": per} for name, per in launches.items()},
            "families": fams}


def sparse_grid_text(grid) -> str:
    """A block-sparse kernel's grid (``flash_mask.SparseGrid``); the bf16
    kernels issue their blocks longest walk first."""
    return (f"grid: at most {grid.cap} tile pairs a block, {grid.chunks} blocks a head, "
            f"{grid.blocks} blocks, longest walk first")


def sparse_phase(gen: torch.Generator, stamp: str, spec, ladder_launches: dict) -> list:
    """Block-sparse attention (``csrc/flash_mask.cu``'s entries; bf16 on
    ``flash_fwd_sm90.cuh`` and ``flash_bwd_sm90.cuh``) under ladder rung
    11's mask at the training shape: each of the three kernels against its
    plain version (bf16 on the ladder, peaked and spike fixtures, fp32 at
    N = 512, bf16 at head dim 128); then the main path, one
    ``torch.autograd.grad`` through ``block_sparse_attention`` with every
    count set to 0 before it, against the plain gradient; each kernel's
    times, bound and SDPA's (boolean mask, efficient backend), and each
    kernel's grid of the timed launches (the dK/dV plan's chunk cap, chunks
    and blocks), as its wrapper kept it.  Returns the three
    kernel records; ``ladder_launches``: the rung-11 run's counts."""
    from flash_attention_metal_tpu_torch.harness import onchip
    from flash_attention_metal_tpu_torch.kernels import flash_mask as fm
    from flash_attention_metal_tpu_torch.kernels.flash_bwd import bwd_delta
    from flash_attention_metal_tpu_torch.utils import roofline

    cases = onchip.sparse_cases(gen)
    bm = cases["sparse_bf16"][4]
    visible = bm.visible_pairs()
    tables = bm.tables("cuda")
    print(f"[sparse] rung 11's mask at n {onchip.SPARSE_N}, {onchip.SPARSE_BLOCK}-row blocks: "
          f"block density {bm.density:.4f}, element density {visible / onchip.SPARSE_N ** 2:.4f}; "
          f"{tables.q_list.shape[0]} visited 64-tile pairs, {tables.bit_tiles.shape[0]} partial; "
          f"tables {tables.nbytes} bytes")
    errors = {}
    for name, case in cases.items():
        errs = onchip.sparse_kernel_errors(case)
        dtype = case[0].dtype
        fwd_tol, bwd_tol = onchip.TOL[dtype], onchip.BWD_TOL[dtype]
        errors[name] = errs
        (o_err, lse_err), worst_rel = errs["o"], max(errs[g][1] for g in ("dq", "dk", "dv"))
        check(o_err <= fwd_tol and lse_err <= fwd_tol,
              f"{name}: sparse forward max abs err {o_err:.3e}, lse {lse_err:.3e} > {fwd_tol}")
        check(worst_rel <= bwd_tol, f"{name}: sparse backward normalised error {worst_rel:.3e} > "
                                    f"{bwd_tol}")
        print(f"[sparse-kernel] {name} q {tuple(case[0].shape)} kv {tuple(case[1].shape)}: o "
              f"max_abs {o_err:.3e} lse {lse_err:.3e} (tol {fwd_tol}); "
              + ", ".join(f"{g} max_abs {errs[g][0]:.3e} rel {errs[g][1]:.3e}"
                          for g in ("dq", "dk", "dv")) + f" (tol rel {bwd_tol})")

    # The main path: the op's forward and backward, counts over it alone.
    q, k, v, do, _ = cases["sparse_bf16"]
    counters = {"flash_sparse_fwd": fm.flash_sparse_fwd, "flash_sparse_dkv": fm.flash_sparse_dkv,
                "flash_sparse_dq": fm.flash_sparse_dq}
    for fn in counters.values():
        fn.launches = 0
    grad_errors = onchip.sparse_op_grad_errors(cases["sparse_bf16"])
    launches = {name: fn.launches for name, fn in counters.items()}
    worst = max(grad_errors.values())
    check(all(n == 1 for n in launches.values()),
          f"block_sparse_attention's forward and backward launch each kernel once: {launches}")
    check(worst <= onchip.BWD_TOL[torch.bfloat16],
          f"block_sparse_attention gradient normalised error {worst:.3e} > "
          f"{onchip.BWD_TOL[torch.bfloat16]}")
    print(f"[sparse-op] torch.autograd.grad through block_sparse_attention, q {tuple(q.shape)} kv "
          f"{tuple(k.shape)} bf16: " + ", ".join(f"{g} rel {e:.3e}" for g, e in grad_errors.items())
          + f" (tol rel {onchip.BWD_TOL[torch.bfloat16]}); launches {launches}")
    del cases
    torch.cuda.empty_cache()

    # Times at the training shape, each beside its plain version, its
    # bound and SDPA with the same boolean mask (forward; forward and
    # backward for the backward kernels).
    scale = 0.125
    batch, heads, n, d = q.shape
    o, lse = fm.flash_sparse_fwd(q, k, v, bm, sm_scale=scale, save_lse=True)
    delta = bwd_delta(o, do, None)
    dense = bm.dense("cuda")
    sdpa_fwd = onchip.sdpa_ms(q, k, v, mask=dense)
    sdpa_bwd = onchip.sdpa_ms(q, k, v, mask=dense, backward_of=do, with_forward=True)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    timed = {
        "flash_sparse_fwd": (
            lambda: fm.flash_sparse_fwd(q, k, v, bm, sm_scale=scale, save_lse=True),
            lambda: fm.flash_sparse_fwd_plain(qf, kf, vf, bm, sm_scale=scale, save_lse=True),
            "fwd", sdpa_fwd, 127),
        "flash_sparse_dkv": (
            lambda: fm.flash_sparse_dkv(q, k, v, do, lse, delta, bm, sm_scale=scale),
            lambda: fm.flash_sparse_dkv_plain(qf, kf, vf, dof, lse, delta, bm, sm_scale=scale),
            "dkv", sdpa_bwd, 318),
        "flash_sparse_dq": (
            lambda: fm.flash_sparse_dq(q, k, v, do, lse, delta, bm, sm_scale=scale),
            lambda: fm.flash_sparse_dq_plain(qf, kf, vf, dof, lse, delta, bm, sm_scale=scale),
            "dq", sdpa_bwd, 372),
    }
    records = []
    for name, (kernel_fn, plain_fn, work, library, line) in timed.items():
        flops, nbytes = roofline.block_sparse_work(batch, heads, k.shape[1], n, n, d, 2, visible,
                                                   work)
        source = "flash_fwd_sm90.cuh" if work == "fwd" else "flash_bwd_sm90.cuh"
        rec = {
            "name": name,
            "route": "cuda",
            "source": f"flash_attention_metal_tpu_torch/csrc/{source}",
            "entry": "flash_attention_metal_tpu_torch/csrc/flash_mask.cu",
            "replaces": f"flash_attention_metal_tpu/kernels/flash_mask.py:{line}",
            "launches": launches[name],
            "launches_ladder": ladder_launches[name],
            "max_abs_err": max(e[key][0] for c, e in errors.items() if "bf16" in c
                               for key in (("o",) if work == "fwd" else
                                           ("dk", "dv") if work == "dkv" else ("dq",))),
            **timed_record(kernel_fn, plain_fn, library, flops, nbytes, 16,
                           "training q [4,16,2048,64] kv [4,8,2048,64] bf16, rung 11's mask", spec),
        }
        if work == "fwd":
            rec["max_abs_err_fp32"] = errors["sparse_fp32_n512"]["o"][0]
            rec["lse_err_max"] = max(e["o"][1] for e in errors.values())
        else:
            grads = ("dk", "dv") if work == "dkv" else ("dq",)
            rec["max_rel_err"] = max(e[g][1] for c, e in errors.items() if "bf16" in c for g in grads)
            rec["max_rel_err_fp32"] = max(errors["sparse_fp32_n512"][g][1] for g in grads)
            rec["library_backend"] += " forward and backward (dQ, dK, dV together)"
            rec["op_grad_rel_err"] = max(grad_errors[g] for g in grads)
        # The grid of the timed launches, as the wrapper kept it.
        rec.update(counters[name].grid._asdict())
        records.append(rec)
        print(f"[time] kernel {name} at {rec['shape']}: device {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms "
              f"({rec['library_backend']}), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
              f"launches {rec['launches']}; source {source}; "
              f"{sparse_grid_text(counters[name].grid)} {stamp}")
    del q, k, v, do, o, lse, delta, dense, qf, kf, vf, dof
    torch.cuda.empty_cache()
    return records


def d128_phase(gen: torch.Generator, stamp: str, spec) -> dict:
    """Every kernel at head dim 128, at its path's shape with D = 128 (the
    ladder fixture; the split pair also peaked): its error against its plain
    version (checked), device ms, plain ms, bound and SDPA's ms; the forward
    router's three also beside their own ms at head dim 64 on the same shape.
    Returns ``{kernel: {...}}``."""
    from flash_attention_metal_tpu_torch.harness import onchip
    from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
    from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
    from flash_attention_metal_tpu_torch.kernels import flash_mask as fm
    from flash_attention_metal_tpu_torch.kernels import flash_tri as ft
    from flash_attention_metal_tpu_torch.kernels import flash_v1 as fv
    from flash_attention_metal_tpu_torch.kernels import naive as nv
    from flash_attention_metal_tpu_torch.kernels import paged as pg
    from flash_attention_metal_tpu_torch.kernels import quant as qt
    from flash_attention_metal_tpu_torch.utils import roofline

    bf16, f32 = torch.bfloat16, torch.float32
    scale = 128 ** -0.5
    out = {}

    # The training path at head dim 128: every gradient at depth 2 against
    # the fp32 oracle attention, the backward through the split pair.
    fb.flash_bwd_dkv.launches = fb.flash_bwd_dq.launches = 0
    g = grad_check(gen, head_dim=128)
    launches = [fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches]
    check(launches == [GRAD_CHECK_LAYERS] * 2,
          f"head dim 128 gradients launch the split pair once a layer: {launches}")
    print(f"[d128] grad check, head dim 128: {grad_line(g)}; split pair launches {launches}")
    out["training_d128"] = {"grad_rel_l2_max": g["worst"], "launches_dkv_dq": launches}

    def nb(*tensors):
        return float(sum(t.numel() * t.element_size() for t in tensors))

    def record(name, err, tol, kernel_fn, plain_fn, library, work, bits, shape, d64_fn=None,
               tag=None, wrapper=None):
        """The kernel's record at head dim 128, or with ``tag`` a second
        shape of its path beside it (keys ``<tag>_ms`` etc.); with
        ``wrapper``, the grid its timed launches took (its ``.grid``)."""
        check(err <= tol, f"{name} at head dim 128, {shape}: error {err:.3e} > {tol}")
        r = timed_record(kernel_fn, plain_fn, library, *work, bits, shape, spec)
        r["err"] = err
        if wrapper is not None:
            r.update(wrapper.grid._asdict())
            if isinstance(wrapper.grid, fm.SparseGrid):
                shape = r["shape"] = f"{shape}, {sparse_grid_text(wrapper.grid)}"
            else:
                shape = r["shape"] = (f"{shape}, split-KV grid {r['kv_splits']} splits of "
                                      f"{r['kv_chunk']} columns, {r['blocks']} blocks")
        if d64_fn is not None:
            r["ms_at_d64"] = onchip.device_ms(d64_fn)
        if tag is None:
            out[name] = r
        else:
            out[name].setdefault("extra", {}).update({f"{tag}_{key}": r[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "err")})
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[d128] kernel {name} at {shape}: error {err:.3e} (tol {tol}); device "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib} ms "
              f"({r['library_backend']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + ("" if d64_fn is None else f"; the same shape at head dim 64 {r['ms_at_d64']:.4f} ms")
              + f" {stamp}")

    def d64(*xs):
        return [x[..., :64].contiguous() for x in xs]

    # Row 1: the general forward at the prefill chunk, offset 512.
    q, k, v = onchip.ladder_inputs(onchip.PREFILL_D128_Q, onchip.PREFILL_D128_KV, bf16, gen)
    off = torch.tensor([512], dtype=torch.int32, device="cuda")
    n_q, n_kv = q.shape[2], k.shape[2]
    mask = torch.arange(n_kv, device="cuda")[None, :] <= torch.arange(n_q, device="cuda")[:, None] + 512
    q6, k6, v6 = d64(q, k, v)
    record("flash_fwd", max(onchip.kernel_error((q, k, v, off, 1))), onchip.TOL[bf16],
           lambda: ff.flash_fwd_general(q, k, v, off, causal=True),
           lambda: ff.flash_attention_fwd_plain(q, k, v, off, sm_scale=scale, causal=True),
           onchip.sdpa_ms(q, k, v, mask=mask), onchip.fwd_work(q, k, [512]), 16,
           "prefill q [1,16,512,128] kv [1,8,2048,128] offset 512 bf16",
           lambda: ff.flash_fwd_general(q6, k6, v6, off, causal=True))
    # Row 1 at the training shape (causal, with the lse).
    q, k, v = onchip.ladder_inputs(onchip.TRAIN_D128_Q, onchip.TRAIN_D128_KV, bf16, gen)
    off = torch.zeros(q.shape[0], dtype=torch.int32, device="cuda")
    record("flash_fwd", max(onchip.kernel_error((q, k, v, off, 1))), onchip.TOL[bf16],
           lambda: ff.flash_fwd_general(q, k, v, off, causal=True, save_lse=True),
           lambda: ff.flash_attention_fwd_plain(q, k, v, off, sm_scale=scale, causal=True,
                                                save_lse=True),
           onchip.sdpa_ms(q, k, v, causal=True), onchip.fwd_work(q, k, off.tolist(), 1, True), 16,
           "training q [4,16,2048,128] kv [4,8,2048,128] bf16 causal, lse", tag="train")
    del q, k, v
    # Rows 2, 8, 9: lean (bf16), naive and streaming V1 (fp32) at the sweep's N = 1024.
    shp = onchip.SWEEP_1024_D128
    b, h, n, d = shp
    full = (4.0 * d * b * h * n * n, 0.0)
    q, k, v = onchip.ladder_inputs(shp, shp, bf16, gen)
    q6, k6, v6 = d64(q, k, v)
    record("flash_lean", max(onchip.ladder_fwd_error("flash_lean", (q, k, v), dict(save_lse=True))),
           onchip.TOL[bf16], lambda: ff.flash_fwd_lean(q, k, v),
           lambda: ff.flash_fwd_lean_plain(q, k, v, 0, sm_scale=scale, causal=False),
           onchip.sdpa_ms(q, k, v), (full[0], 2 * nb(q, k)), 16,
           "sweep N=1024 B=8 H=1 D=128 bf16 non-causal", lambda: ff.flash_fwd_lean(q6, k6, v6))
    shp = onchip.SWEEP_128_D128
    qs, ks, vs = onchip.ladder_inputs(shp, shp, bf16, gen)
    record("flash_lean",
           max(onchip.ladder_fwd_error("flash_lean", (qs, ks, vs), dict(save_lse=True))),
           onchip.TOL[bf16], lambda: ff.flash_fwd_lean(qs, ks, vs),
           lambda: ff.flash_fwd_lean_plain(qs, ks, vs, 0, sm_scale=scale, causal=False),
           onchip.sdpa_ms(qs, ks, vs), (4.0 * 128 * shp[0] * shp[2] ** 2, 2 * nb(qs, ks)), 16,
           "sweep N=128 B=512 H=1 D=128 bf16 non-causal", tag="n128")
    del qs, ks, vs
    shp = onchip.SWEEP_1024_D128
    q, k, v = onchip.ladder_inputs(shp, shp, f32, gen)
    library = onchip.sdpa_ms(q, k, v)
    record("naive", onchip.ladder_fwd_error("naive", (q, k, v), {})[0], onchip.TOL[f32],
           lambda: nv.naive_attention(q, k, v),
           lambda: nv.naive_attention_plain(q, k, v, sm_scale=scale, causal=False),
           library, (full[0], 2 * nb(q, k)), 32, "sweep N=1024 B=8 H=1 D=128 fp32 non-causal")
    check(onchip.v1_kernel(shp) == "flash_v1", "the sweep's N = 1024 takes streaming V1")
    record("flash_v1", onchip.v1_error((q, k, v), False), onchip.TOL[f32],
           lambda: fv.flash_attention_v1(q, k, v),
           lambda: fv.flash_attention_v1_plain(q, k, v, sm_scale=scale, causal=False),
           library, (full[0], 2 * nb(q, k)), 32, "sweep N=1024 B=8 H=1 D=128 fp32 non-causal")
    # Row 10: folded V1 at the sweep's N = 128.
    shp = onchip.SWEEP_128_D128
    check(onchip.v1_kernel(shp) == "flash_v1_folded", "the sweep's N = 128 takes folded V1")
    q, k, v = onchip.ladder_inputs(shp, shp, f32, gen)
    record("flash_v1_folded", onchip.v1_error((q, k, v), False), onchip.TOL[f32],
           lambda: fv.flash_attention_v1(q, k, v),
           lambda: fv.flash_attention_v1_plain(q, k, v, sm_scale=scale, causal=False),
           onchip.sdpa_ms(q, k, v), (4.0 * 128 * shp[0] * shp[2] ** 2, 2 * nb(q, k)), 32,
           "sweep N=128 B=512 H=1 D=128 fp32 non-causal")
    del q, k, v, q6, k6, v6
    # Rows 3-4: the triangular forward and backward, causal.
    shp = onchip.TRI_D128
    b, h, n, d = shp
    pairs = b * h * roofline.visible_pairs(n, n, 0)
    q, k, v = onchip.ladder_inputs(shp, shp, bf16, gen)
    do = onchip.ladder_inputs(shp, shp, bf16, gen)[0]
    q6, k6, v6 = d64(q, k, v)
    o, lse = ft.flash_attention_tri(q, k, v, save_lse=True)
    record("flash_tri", max(onchip.ladder_fwd_error("flash_tri", (q, k, v), dict(save_lse=True))),
           onchip.TOL[bf16], lambda: ft.flash_attention_tri(q, k, v, save_lse=True),
           lambda: ft.flash_attention_tri_plain(q, k, v, 0, sm_scale=scale, save_lse=True),
           onchip.sdpa_ms(q, k, v, causal=True), (4.0 * d * pairs, 2 * nb(q, k) + nb(lse)), 16,
           "q [2,8,2048,128] bf16 causal, lse", lambda: ft.flash_attention_tri(q6, k6, v6, save_lse=True))
    errs = onchip.tri_bwd_errors((q, k, v, o, do, lse, 0))
    record("flash_tri_bwd", max(r for _, r in errs.values()), onchip.BWD_TOL[bf16],
           lambda: ft.flash_attention_bwd_tri(q, k, v, o, do, lse),
           lambda: ft.flash_attention_bwd_tri_plain(q, k, v, o, do, lse, 0, sm_scale=scale),
           onchip.sdpa_ms(q, k, v, causal=True, backward_of=do),
           (10.0 * d * pairs, 5 * nb(q) + nb(lse) + nb(q) + 4 * q.numel() * 2), 16,
           "q [2,8,2048,128] bf16 causal")
    del q, k, v, do, o, lse, q6, k6, v6
    torch.cuda.empty_cache()
    # Rows 5-7: the split pair (ladder and peaked) and the fused backward at
    # the training shape.
    errs = {}
    for tag, q_scale in (("_peaked", onchip.PEAKED_Q_SCALE), ("", 1.0)):
        q, k, v = onchip.ladder_inputs(onchip.TRAIN_D128_Q, onchip.TRAIN_D128_KV, bf16, gen, q_scale)
        do = onchip.ladder_inputs(onchip.TRAIN_D128_Q, onchip.TRAIN_D128_KV, bf16, gen)[0]
        inputs = onchip.bwd_inputs((q, k, v, do, torch.zeros(4, dtype=torch.int32, device="cuda")))
        errs[tag] = onchip.bwd_kernel_errors(inputs)
        print(f"[d128] split pair, training shape q {tuple(q.shape)}{tag}: "
              + ", ".join(f"{g} rel {r:.3e}" for g, (_, r) in errs[tag].items()))
    # Timed on the ladder fixture, as at head dim 64.
    q, k, v, o, do, lse, off = inputs
    delta = fb.bwd_delta(o, do, None)
    kw = dict(sm_scale=scale, causal=True)
    b, h, n, d = q.shape
    pairs = b * h * roofline.visible_pairs(n, n, 0)
    library = onchip.sdpa_ms(q, k, v, causal=True, backward_of=do)
    rows = nb(lse, delta)
    shape = "training q [4,16,2048,128] kv [4,8,2048,128] bf16 causal"
    for name, grads, flops, nbytes, kernel_fn, plain_fn in (
        ("flash_bwd_dkv", ("dk", "dv"), 8 * d * pairs, nb(q, do, k, v, k, v) + rows,
         lambda: fb.flash_bwd_dkv(q, k, v, do, lse, delta, off, **kw),
         lambda: fb.flash_bwd_dkv_plain(q, k, v, do, lse, delta, off, **kw)),
        ("flash_bwd_dq", ("dq",), 6 * d * pairs, nb(q, do, k, v, q) + rows,
         lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, off, **kw),
         lambda: fb.flash_bwd_dq_plain(q, k, v, do, lse, delta, off, **kw)),
    ):
        record(name, max(e[g][1] for e in errs.values() for g in grads), onchip.BWD_TOL[bf16],
               kernel_fn, plain_fn, library, (flops, nbytes), 16, shape)
    errs = onchip.bwd_kernel_errors(inputs, fused=True)
    record("flash_bwd_fused", max(r for _, r in errs.values()), onchip.BWD_TOL[bf16],
           lambda: fb.flash_attention_bwd_fused(q, k, v, o, do, lse, off, q_offset_max=0, **kw),
           lambda: fb.flash_attention_bwd_fused_plain(q, k, v, o, do, lse, off, **kw), library,
           roofline.fused_bwd_work(b, h, k.shape[1], n, n, d, 2, causal=True), 16, shape)
    out["flash_bwd_fused"]["workspace_bytes"] = fb.fused_workspace_bytes(q)
    del q, k, v, o, do, lse, off, delta, inputs
    torch.cuda.empty_cache()
    # Rows 11-13: the KV caches' kernels at folded decode; SDPA over a dense
    # bf16 cache of the same shape beside them (another function).
    lengths = torch.from_numpy(onchip.decode_lengths()).to("cuda")
    qd, kd, vd = onchip.ladder_inputs(onchip.DECODE_D128_Q, onchip.DECODE_D128_KV, bf16, gen)
    cols = torch.arange(onchip.DECODE_D128_KV[2], device="cuda")
    dense = onchip.sdpa_ms(qd, kd, vd, mask=(cols <= lengths[:, None])[:, None, None, :])
    # Row 1 at folded decode over a dense bf16 cache.
    record("flash_fwd", max(onchip.kernel_error((qd, kd, vd, lengths, 2))), onchip.TOL[bf16],
           lambda: ff.flash_fwd_general(qd, kd, vd, lengths, causal=True, pos_div=2),
           lambda: ff.flash_attention_fwd_plain(qd, kd, vd, lengths, sm_scale=scale, causal=True,
                                                pos_div=2),
           dense, onchip.fwd_work(qd, kd, lengths.tolist(), 2), 16,
           "decode q [8,8,2,128] pos_div 2 over [8,8,2048,128] at onchip.decode_lengths()",
           tag="decode")
    del qd, kd, vd
    wrappers = {"flash_quant": qt.flash_attention_quant, "flash_paged": pg.flash_attention_paged,
                "flash_paged_quant": pg.flash_attention_paged_quant}
    for case, (kernel, args, pos_div) in onchip.kv_d128_cases(gen).items():
        err, lse_err = onchip.kv_kernel_error(kernel, args, pos_div)
        wrapper, plain = onchip.KV_KERNELS[kernel]
        record(kernel, max(err, lse_err), onchip.TOL[bf16], lambda: wrapper(*args, pos_div),
               lambda: plain(*args, pos_div), (None, "none: no PyTorch call attends over an "
                                               "8-bit or paged cache"),
               onchip.kv_work(kernel, args, pos_div), 16,
               "decode q [8,8,2,128] pos_div 2 over [8,8,2048,128] at onchip.decode_lengths()"
               + ("" if kernel == "flash_paged" else ", int8"), wrapper=wrappers[kernel])
        out[kernel]["sdpa_dense_bf16_ms"] = dense[0]
    # Rows 14-16: block-sparse under rung 11's mask.
    bm = onchip.sparse_mask()
    q, k, v = onchip.ladder_inputs(onchip.SPARSE_D128_Q, onchip.SPARSE_D128_KV, bf16, gen)
    do = onchip.ladder_inputs(onchip.SPARSE_D128_Q, onchip.SPARSE_D128_KV, bf16, gen)[0]
    errs = onchip.sparse_kernel_errors((q, k, v, do, bm))
    o, lse = fm.flash_sparse_fwd(q, k, v, bm, sm_scale=scale, save_lse=True)
    delta = fb.bwd_delta(o, do, None)
    dense_mask = bm.dense("cuda")
    b, h, n, d = q.shape
    visible = bm.visible_pairs()
    shape = "q [1,8,2048,128] kv [1,4,2048,128] bf16, rung 11's mask"
    fwd_library = onchip.sdpa_ms(q, k, v, mask=dense_mask)
    bwd_library = onchip.sdpa_ms(q, k, v, mask=dense_mask, backward_of=do, with_forward=True)
    for name, err, tol, work, library, kernel_fn, plain_fn in (
        ("flash_sparse_fwd", max(errs["o"]), onchip.TOL[bf16], "fwd", fwd_library,
         lambda: fm.flash_sparse_fwd(q, k, v, bm, sm_scale=scale, save_lse=True),
         lambda: fm.flash_sparse_fwd_plain(q, k, v, bm, sm_scale=scale, save_lse=True)),
        ("flash_sparse_dkv", max(errs[g][1] for g in ("dk", "dv")), onchip.BWD_TOL[bf16], "dkv",
         bwd_library, lambda: fm.flash_sparse_dkv(q, k, v, do, lse, delta, bm, sm_scale=scale),
         lambda: fm.flash_sparse_dkv_plain(q, k, v, do, lse, delta, bm, sm_scale=scale)),
        ("flash_sparse_dq", errs["dq"][1], onchip.BWD_TOL[bf16], "dq", bwd_library,
         lambda: fm.flash_sparse_dq(q, k, v, do, lse, delta, bm, sm_scale=scale),
         lambda: fm.flash_sparse_dq_plain(q, k, v, do, lse, delta, bm, sm_scale=scale)),
    ):
        record(name, err, tol, kernel_fn, plain_fn, library,
               roofline.block_sparse_work(b, h, k.shape[1], n, n, d, 2, visible, work), 16, shape,
               wrapper=getattr(fm, name))
    del q, k, v, do, o, lse, delta, dense_mask
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from flash_attention_metal_tpu_torch import bench as bench_mod
    from flash_attention_metal_tpu_torch.harness import autotune, onchip, serving, train_bench
    from flash_attention_metal_tpu_torch.harness.verify import RUNGS_2_8_9_12_18, run_ladder
    from flash_attention_metal_tpu_torch.kernels import flash_mask as fm
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

    # 2. Build; beside it (its nvcc processes started with the build's), a
    # copy of csrc/ with the segmented position walks' planted fault, which
    # pos_seg_phase reads.  The thread is not a daemon: a run that fails
    # earlier waits for its processes before it exits.
    planted_tmp = tempfile.TemporaryDirectory()
    planted_box = {}

    def build_planted():
        try:
            planted_box["path"] = onchip.build_planted(planted_tmp.name, onchip.POS_SEG_IGNORED)
        except (RuntimeError, OSError, ValueError) as err:  # raised where the phase reads it
            planted_box["error"] = err

    planted_thread = threading.Thread(target=build_planted)
    planted_thread.start()

    def planted():
        planted_thread.join()
        if "error" in planted_box:
            raise planted_box["error"]
        return planted_box["path"]

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
    # shape (bf16 ladder, peaked and spike fixtures, fp32 at N = 512); the
    # bf16 pair bitwise deterministic.
    train_cases = onchip.train_cases(gen)
    bwd_errors = {}
    for name, case in train_cases.items():
        inputs = onchip.bwd_inputs(case)
        errs = onchip.bwd_kernel_errors(inputs)
        tol = onchip.BWD_TOL[case[0].dtype]
        bwd_errors[name] = errs
        worst_rel = max(rel for _, rel in errs.values())
        check(worst_rel <= tol, f"{name}: backward normalised error {worst_rel:.3e} > {tol}")
        print(f"[bwd-kernel] {name} q {tuple(case[0].shape)} kv {tuple(case[1].shape)}: "
              + ", ".join(f"{g} max_abs {a:.3e} rel {r:.3e}" for g, (a, r) in errs.items())
              + f" (tol rel {tol})")
        if name == "train_bf16_peaked":
            runs = [fb.flash_attention_bwd(*inputs, causal=True) for _ in range(2)]
            check(all(torch.equal(a, b) for a, b in zip(*runs)),
                  f"{name}: two runs of the split pair give the same bits")
            print(f"[bwd-kernel] {name}: two runs bitwise equal")
            del runs
        del inputs

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

    # 10. The forward kernel against its plain version at the training
    # shape (causal, with the lse; bf16 ladder, peaked and spike fixtures at
    # head dim 64 and 128), then the kernels' device times there.
    train_fwd_errors = {}
    for d in (64, 128):
        for fixture in ("ladder", "peaked", "spike"):
            shape_q, shape_kv = (*onchip.TRAIN_Q[:3], d), (*onchip.TRAIN_KV[:3], d)
            if fixture == "spike":
                qf, kf, vf = onchip.spike_inputs(shape_q, shape_kv, torch.bfloat16, gen)
            else:
                scale_q = onchip.PEAKED_Q_SCALE if fixture == "peaked" else 1.0
                qf, kf, vf = onchip.ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen, scale_q)
            offf = torch.zeros(shape_q[0], dtype=torch.int32, device="cuda")
            err, lse_err = onchip.kernel_error((qf, kf, vf, offf, 1))
            tol = onchip.TOL[torch.bfloat16]
            train_fwd_errors[(d, fixture)] = err
            check(err <= tol and lse_err <= tol,
                  f"forward at the training shape, D {d} {fixture}: max abs err {err:.3e}, "
                  f"lse {lse_err:.3e} > {tol}")
            print(f"[kernel] flash_fwd at the training shape q {shape_q} kv {shape_kv} causal, "
                  f"{fixture}: max_abs_err {err:.3e} lse_err {lse_err:.3e} (tol {tol})")
            del qf, kf, vf
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
        if inputs[0].dtype == torch.bfloat16 and name != "tri_bwd_bf16_b16h8n2048":
            # Deterministic: the KV tiles add to each dQ row in KV-tile order.
            runs = [ft.flash_attention_bwd_tri(*inputs[:6], q_offset=inputs[6])
                    for _ in range(3)]
            check(all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run)),
                  f"{name}: repeated triangular backward runs differ")
            print(f"[ladder-kernel] {name} (flash_tri_bwd): 3 runs bit-identical")
            del runs
    torch.cuda.empty_cache()

    # 12. The slice's path: the verification ladder, then a short benchmark,
    # with every kernel's launches counted over the two.
    sparse_kernels = {"flash_sparse_fwd": fm.flash_sparse_fwd,
                      "flash_sparse_dkv": fm.flash_sparse_dkv, "flash_sparse_dq": fm.flash_sparse_dq}
    for fn in (*bench_mod.KERNELS.values(), *sparse_kernels.values()):
        fn.launches = 0
    rungs = run_ladder(LADDER_N, device="cuda", log=lambda line: print(f"[ladder] {line}"))
    ladder_sparse = {name: fn.launches for name, fn in sparse_kernels.items()}
    failed = [r.name for r in rungs if not r.passed]
    check(not failed, f"every ported ladder rung passes; failed: {failed}")
    missing = sorted(set(RUNGS_2_8_9_12_18 + (RUNG_11,)) - {r.name for r in rungs})
    check(not missing, f"rungs 2, 8, 9, 11, 12 and 18 run; missing: {missing}")
    check(ladder_sparse["flash_sparse_fwd"] > 0,
          f"rung 11 launches the block-sparse forward kernel: {ladder_sparse}")
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
    # The triangular backward's dQ workspace is the fused kernel's: the fp32
    # accumulator and its counters, O(B H N D), whatever the offset.
    ws_alloc, ws_written = onchip.tri_workspace_bytes((qo, ko, vo, oo, doo, lseo, 0))
    ws_need = fb.fused_workspace_bytes(qo)
    check(0 <= ws_alloc - ws_need < 512 and 0 < ws_written <= 4 * qo.numel(),
          f"triangular dQ workspace: {ws_alloc} bytes allocated (accumulator and counters: "
          f"{ws_need}), {ws_written} bytes of the accumulator written")
    rec["flash_tri_bwd"].update(workspace_bytes_allocated=ws_alloc,
                                workspace_bytes_written=ws_written)
    print(f"[time] kernel flash_tri_bwd at high occupancy: dQ workspace {ws_alloc} bytes "
          f"allocated, {ws_written} bytes of the accumulator written (the fused kernel's at "
          f"the training shape: {fused['record']['workspace_bytes_allocated']}) {stamp}")
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

    # 15. Block-sparse attention: its three kernels, the op's forward and
    # backward, and the forward router's kernels at head dim 128.
    sparse_records = sparse_phase(gen, stamp, spec, ladder_sparse)
    d128 = d128_phase(gen, stamp, spec)

    # 16. Sliding-window attention with sinks, and segment ids: the
    # windowed and segmented kernels, the windowed FlashLM's training and
    # serving, and the windowed times beside the unwindowed ones.
    window = window_phase(gen, stamp, spec, tmp)

    # 17. The score transforms, the tanh softcap and ALiBi: the transformed
    # kernels, the capped ALiBi FlashLM's training (the fused decision
    # declined) and serving, and the transformed times beside the others.
    xf = xf_phase(gen, stamp, spec, tmp)

    # 18. Attention dropout: the mask bit for bit, the dropout kernels, the
    # dropout FlashLM trained from token shards and served without seeds,
    # and the dropout times beside the others.
    drop = drop_phase(gen, stamp, spec, tmp)

    # 19. The rest of one-device serving: the position-map kernels, rolling
    # caches, multi-step dispatch, speculative and beam decoding,
    # snapshot/restore and weight-only int8.
    serve_rest = serve_phase(gen, stamp, spec, tmp)

    # 20. Position maps with segment ids on the card, and their planted
    # fault (ROADMAP Queue C 15).
    pos_seg = pos_seg_phase(gen, stamp, spec, planted)
    planted_tmp.cleanup()

    # 21. The one-device model families: MoE served and trained, the
    # encoder, seq2seq, LoRA, Muon and a converted LLaMA.
    families = family_phase(gen, stamp, spec)

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

    def with_d128(rec):
        """The kernel's head-dim-128 numbers beside its record's."""
        r = d128[rec["name"]]
        rec.update({f"{key}_d128": r[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_backend", "shape")})
        rec["max_err_d128"] = r["err"]
        rec.update({f"{key}_d128": value for key, value in r.get("extra", {}).items()})
        for key, name in (("ms_at_d64", "ms_d64_same_shape"), ("workspace_bytes", "workspace_bytes_d128"),
                          ("sdpa_dense_bf16_ms", "sdpa_dense_bf16_ms_d128"),
                          ("kv_chunk", "kv_chunk_d128"), ("kv_splits", "kv_splits_d128"),
                          ("cap", "cap_d128"), ("chunks", "chunks_d128"),
                          ("blocks", "blocks_d128")):
            if key in r:
                rec[name] = r[key]
        return rec

    lean_rec = ladder_record("flash_lean", "flash_lean.cu",
                             "flash_attention_metal_tpu/kernels/flash_fwd.py:429", "flash_lean")
    lean_rec.update({"max_abs_err_fp32": ladder_err("flash_lean", torch.float32),
                     **{f"{key}_n128": lean_128[key] for key in (
                         "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
    tri_rec = ladder_record("flash_tri", "flash_fwd_sm90.cuh",
                            "flash_attention_metal_tpu/kernels/flash_tri.py:50", "flash_tri")
    tri_rec.update(entry="flash_attention_metal_tpu_torch/csrc/flash_tri.cu",
                   max_abs_err_fp32=ladder_err("flash_tri", torch.float32))
    record = {
        "kernels": [with_d128(r) for r in [{
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
            "train_max_abs_err": max(e for (d_, _), e in train_fwd_errors.items() if d_ == 64),
            "train_max_abs_err_d128": max(
                e for (d_, _), e in train_fwd_errors.items() if d_ == 128),
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
                "source": "flash_attention_metal_tpu_torch/csrc/flash_bwd_fused_sm90.cuh",
                "entry": "flash_attention_metal_tpu_torch/csrc/flash_tri.cu",
                "replaces": "flash_attention_metal_tpu/kernels/flash_tri.py:431",
                "launches": slice_launches["flash_tri_bwd"],
                "max_abs_err": max(e[g][0] for e in bf16_tri_bwd for g in e),
                "max_rel_err": max(e[g][1] for e in bf16_tri_bwd for g in e),
                "max_rel_err_fp32": max(r for _, r in tri_bwd_errors["tri_bwd_fp32_n1024"].values()),
                **times_of("flash_tri_bwd"),
                "workspace_bytes_allocated": rec["flash_tri_bwd"]["workspace_bytes_allocated"],
                "workspace_bytes_written": rec["flash_tri_bwd"]["workspace_bytes_written"],
            },
            *kv["records"],
            fused["record"],
            *v1_records,
            *sparse_records,
        ]],
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
            "train_launches": train_launches,
        },
        "training_d128": d128.pop("training_d128"),
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
    for rec_ in record["kernels"]:
        rec_.update(window["records"].get(rec_["name"], {}))
        rec_.update(xf["records"].get(rec_["name"], {}))
        rec_.update(drop["records"].get(rec_["name"], {}))
        rec_.update(serve_rest["records"].get(rec_["name"], {}))
        rec_.update(families["records"].get(rec_["name"], {}))
        if rec_["name"] == "flash_fwd":
            rec_.update(pos_seg)
    record["training_window"] = {"grad_rel_l2_max": window["grad_rel_l2_max"], **window["train"]}
    record["serving_window"] = window["serving"]
    record["training_xf"] = {"grad_rel_l2_max": xf["grad_rel_l2_max"], **xf["train"]}
    record["serving_xf"] = xf["serving"]
    record["serving_rest"] = serve_rest["serving"]
    record["families"] = families["families"]
    record["training_dropout"] = {"grad_rel_l2_max": drop["grad_rel_l2_max"],
                                  "phase_seconds": drop["seconds"], **drop["train"]}
    tmp_dir.cleanup()
    check(len(record["kernels"]) == 16, f"16 kernels recorded: {len(record['kernels'])}")
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
