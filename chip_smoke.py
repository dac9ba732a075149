#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``flash_attention_metal_tpu_torch/csrc``
and drives both main paths at the widest FlashLM width the repo records
(``train_bench.json``: d_model 2048, 8 layers, 16/8 heads, d_ff 4096,
vocab 32768) with seeded random weights:

* serving: the forward kernel against its plain version at the serving
  shapes, 16 requests through ``DecodeEngine``, served logits against a
  plain fp32 forward, kernel/prefill/decode times;
* training: the dK/dV and dQ kernels against their plain versions at the
  training shape, each parameter's gradient at depth 2 against the fp32
  oracle attention, 6 ``Trainer`` steps at batch 4, seq 2048 with the
  kernels' launch counts, step time, tokens/s and MFU.

Each phase prints one line; any failure exits non-zero before the result
lines.  The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from flash_attention_metal_tpu_torch.harness import onchip, serving, train_bench
    from flash_attention_metal_tpu_torch.kernels import _build
    from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import (
        flash_attention_fwd,
        flash_attention_fwd_plain,
    )
    from flash_attention_metal_tpu_torch.models import transformer as tf
    from flash_attention_metal_tpu_torch.runtime import engine as engine_mod

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
        before = flash_attention_fwd.launches
        out = prefill_slot(*args, **kwargs)
        prefill_launches[0] += flash_attention_fwd.launches - before
        return out

    engine_mod.prefill_slot = counted_prefill
    requests = serving.make_requests(N_REQUESTS, cfg.vocab_size, PROMPT_LENS, MAX_NEW, SEED)
    flash_attention_fwd.launches = 0
    bench = serving.run_serving_bench(eng, requests, log=lambda s: None)
    launches = flash_attention_fwd.launches
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

    # 7. Backward kernels against their plain versions at the training
    # shape (bf16 ladder and peaked fixtures, fp32 at N = 512).
    del eng
    torch.cuda.empty_cache()
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
    print(f"[grad-check] L{GRAD_CHECK_LAYERS} d2048 b1 s2048: loss {float(loss_k):.5f} vs "
          f"{float(loss_r):.5f}; {len(rels)} gradients, rel L2 max {rels[worst_i]:.3e} "
          f"({names[worst_i]}), median {float(np.median(rels)):.3e} (tol {GRAD_REL_L2_TOL})")
    del gparams, grads_k, grads_r

    # 9. Train: Trainer.step at the full width, counts over these steps only.
    flash_attention_fwd.launches = fb.flash_bwd_dkv.launches = fb.flash_bwd_dq.launches = 0
    train = train_bench.run_train_bench(steps=TRAIN_STEPS, log=lambda s: None)
    train_launches = {
        "fwd": flash_attention_fwd.launches,
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

    bf16_bwd = [errs for name, errs in bwd_errors.items() if "bf16" in name]

    def bwd_record(name, line, grads):
        return {
            "name": name,
            "route": "cuda",
            "source": "flash_attention_metal_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"flash_attention_metal_tpu/kernels/flash_bwd.py:{line}",
            "launches": train_launches["dkv" if name.endswith("dkv") else "dq"],
            "max_abs_err": max(e[g][0] for e in bf16_bwd for g in grads),
            "max_rel_err": max(e[g][1] for e in bf16_bwd for g in grads),
            "max_rel_err_fp32": max(bwd_errors["train_fp32_n512"][g][1] for g in grads),
            "ms": train_times[name][0],
            "plain_ms": train_times[name][1],
        }

    record = {
        "kernels": [{
            "name": "flash_fwd",
            "route": "cuda",
            "source": "flash_attention_metal_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "flash_attention_metal_tpu/kernels/flash_fwd.py:84",
            "launches": launches + train_launches["fwd"],
            "max_abs_err": max(errors[n] for n in errors if "bf16" in n),
            "max_abs_err_fp32": errors["prefill_fp32_off512"],
            "ms": timings["prefill_bf16_off512"][0],
            "plain_ms": timings["prefill_bf16_off512"][1],
            "decode_ms": timings["decode_bf16"][0],
            "decode_plain_ms": timings["decode_bf16"][1],
            "launches_prefill": prefill_launches[0],
            "launches_decode": decode_launches,
            "launches_train": train_launches["fwd"],
            "train_ms": train_times["flash_fwd"][0],
            "train_plain_ms": train_times["flash_fwd"][1],
        },
            bwd_record("flash_bwd_dkv", 79, ("dk", "dv")),
            bwd_record("flash_bwd_dq", 268, ("dq",)),
        ],
        "serving": {
            "tokens_per_s": bench["tokens_per_s"],
            "ms_per_step": bench["ms_per_step"],
            "decode_step_ms": step_ms,
            "prefill_ms_512": prefill_ms,
            "served_logits_rel_l2_max": worst,
        },
        "training": {
            "step_ms": train["step_ms"],
            "tokens_per_s": train["tokens_per_s"],
            "model_tflops": train["model_tflops"],
            "mfu": train["mfu"],
            "losses": losses,
            "grad_rel_l2_max": rels[worst_i],
        },
        "card": smi,
    }
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
