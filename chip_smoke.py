#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``flash_attention_metal_tpu_torch/csrc``,
holds it against its plain PyTorch version at the serving path's shapes,
serves a FlashLM through ``DecodeEngine`` at the widest FlashLM width the
repo records (``train_bench.json``: d_model 2048, 8 layers, 16/8 heads,
d_ff 4096, vocab 32768) with seeded random weights, checks the served
logits against a plain fp32 forward, and times the kernel, prefill and
decode with CUDA events.  Each phase prints one line; any failure exits
non-zero before the result lines.  The last two lines are the kernels'
JSON record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

MAX_BATCH, MAX_LEN = 8, 2048
N_REQUESTS, PROMPT_LENS, MAX_NEW = 16, (64, 1000), 64
SEED = 0
# Prompts of the served-logits check: a short pair (one KV tile; a cache
# position too few or too many moves these logits most) and a long pair
# (multi-tile prefill with padded rows, decode past 64 columns).
CHECK_PROMPTS = (5, 11, 300, 900)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from flash_attention_metal_tpu_torch.harness import onchip, serving
    from flash_attention_metal_tpu_torch.kernels import _build
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import (
        flash_attention_fwd,
        flash_attention_fwd_plain,
    )
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

    record = {
        "kernels": [{
            "name": "flash_fwd",
            "route": "cuda",
            "source": "flash_attention_metal_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "flash_attention_metal_tpu/kernels/flash_fwd.py:84",
            "launches": launches,
            "max_abs_err": max(errors[n] for n in errors if "bf16" in n),
            "max_abs_err_fp32": errors["prefill_fp32_off512"],
            "ms": timings["prefill_bf16_off512"][0],
            "plain_ms": timings["prefill_bf16_off512"][1],
            "decode_ms": timings["decode_bf16"][0],
            "decode_plain_ms": timings["decode_bf16"][1],
            "launches_prefill": prefill_launches[0],
            "launches_decode": decode_launches,
        }],
        "serving": {
            "tokens_per_s": bench["tokens_per_s"],
            "ms_per_step": bench["ms_per_step"],
            "decode_step_ms": step_ms,
            "prefill_ms_512": prefill_ms,
            "served_logits_rel_l2_max": worst,
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
