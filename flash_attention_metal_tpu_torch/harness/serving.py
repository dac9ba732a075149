"""Serving benchmark and served-path check for the PyTorch port.

Counterpart of ``flash_attention_metal_tpu/harness/serving.py``:
continuous-batching decode throughput of ``DecodeEngine`` on a FlashLM
model in each serving mode (``SERVING_MODES``: the dense, 8-bit and paged
caches, prefix sharing, the rolling caches of a sliding-window model,
multi-step dispatch, weight-only int8 and speculative decoding), timed on
the host clock between device fences.  ``host_context`` records the card's name and power limit, since a
card set below its maximum power runs slower under load.

``teacher_forced_errors`` is the check that the served path is right: the
logits of prefill and cached decode steps, through an engine of a given
serving mode, against a plain fp32 forward over the same tokens.

The JAX package's command line (on the card; there is no CPU fallback)::

    python -m flash_attention_metal_tpu_torch.harness.serving [--max-batch 8]
        [--requests 16] [--prompt-len 128] [--max-new 128] [--dense-only]
        [--multi-step 1]

runs ``serving_suite`` and writes ``serving_bench_torch.json`` (never the
JAX package's ``serving_bench.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.transformer import ModelConfig, Params, forward, init_params
from ..models.wquant import quantize_weights
from ..runtime.decode import decode_and_sample_multi, decode_step
from ..runtime.engine import DecodeEngine, Request
from ..runtime.kv_cache import bump_lengths
from ..runtime.speculative import _forward_chunk

# Largest relative L2 error ||served - reference|| / ||reference|| allowed
# for one step's [V] logits by ``teacher_forced_errors`` with bf16
# weights, activations and cache against the fp32 plain forward.  bf16
# rounding of activations through the layers costs one to two percent, at
# short and at long prompts; a kernel that reads one cache position too
# few or too many, or RoPE in the half-split pairing, costs more than this
# at short lengths (tests/test_torch_serving.py injects each fault).  The
# paged bf16 cache holds the same values, so it keeps this bound.
LOGITS_REL_L2_TOL = 5e-2
# The 8-bit caches add their quantization error to the bf16 one.  int8:
# each K/V element is off by at most half a step, absmax / 254, a fraction
# of the bf16 activation error, so int8 keeps 5e-2 (it reads 2.1-2.7%
# against bf16's 1.3-1.7% on CPU models of 2-8 layers, d 128-512).  e4m3
# keeps 3 mantissa bits: each element is off by up to 2^-4 of itself
# (~3.6% RMS), and the same CPU models read 6.5-8.8%; the JAX tests allow
# 8e-2 for e4m3 against 3e-2 for int8 on one attention call
# (tests/test_quant.py).  Its bound is 1.5e-1, which the injected faults
# (a cache position too few or too many reads 0.85-0.92) still exceed
# (tests/test_torch_paged.py).
LOGITS_REL_L2_TOL_INT8 = 5e-2
LOGITS_REL_L2_TOL_FP8 = 1.5e-1

# The speculative mode's draft: a 2-layer, d 512 FlashLM of the target's
# vocab, head dim and dtype, its weights seeded apart from the target's.
DRAFT_D512 = dict(n_layers=2, d_model=512, n_heads=8, n_kv_heads=4, d_ff=2048)

# Each serving mode: the engine's options, and the bound on its served
# logits (the prefix-shared mode serves from the paged cache).  Two
# options are not the engine's: ``weight_quant`` serves the weight-only
# int8 tree of the model (``models/wquant.py``) and ``draft`` builds the
# draft model of those sizes (``engine_options``).  The bounds of the new
# modes, each against the plain fp32 forward of the same weights:
#   * rolling, rolling_int8: the dense and int8 caches' bounds.  The rolling
#     cache holds the same values in other slots, and the kernels mask in
#     position space, so only the cache's format adds error; a slot whose
#     position is off by one (tests/test_torch_rolling.py) exceeds them.
#   * multi_step_8: the dense bound; each step of the dispatch is a dense
#     decode step, fed the token the step before it chose on the device (a
#     step fed another token, or none, reads far past it).
#   * weight_int8: the dense bound, against the fp32 forward of the
#     dequantized weights (the same tree): the int8 rounding is in both,
#     and what is left is the bf16 one.
#   * speculative: the dense bound on the verify chunk's logits (gamma + 1
#     rows a call at each slot's offset, the decode grid's multi-row tile, or
#     at a GQA group whose verify window folds to more than 16 rows, the
#     folded grid); speculative_int8, _paged, _paged_int8: the same over the
#     target's 8-bit and paged caches, at their caches' bounds.
SERVING_MODES = {
    "dense": (dict(), LOGITS_REL_L2_TOL),
    "int8": (dict(kv_quant="int8"), LOGITS_REL_L2_TOL_INT8),
    "fp8": (dict(kv_quant="fp8"), LOGITS_REL_L2_TOL_FP8),
    "paged": (dict(paged=True), LOGITS_REL_L2_TOL),
    "paged_prefix_shared": (dict(paged=True, prefix_share=True), LOGITS_REL_L2_TOL),
    "paged_int8": (dict(paged=True, kv_quant="int8"), LOGITS_REL_L2_TOL_INT8),
    "rolling": (dict(rolling=True), LOGITS_REL_L2_TOL),
    "rolling_int8": (dict(rolling=True, kv_quant="int8"), LOGITS_REL_L2_TOL_INT8),
    "multi_step_8": (dict(multi_step=8), LOGITS_REL_L2_TOL),
    "weight_int8": (dict(weight_quant=True), LOGITS_REL_L2_TOL),
    "speculative": (dict(draft=DRAFT_D512), LOGITS_REL_L2_TOL),
    "speculative_int8": (dict(draft=DRAFT_D512, kv_quant="int8"), LOGITS_REL_L2_TOL_INT8),
    "speculative_paged": (dict(draft=DRAFT_D512, paged=True), LOGITS_REL_L2_TOL),
    "speculative_paged_int8": (dict(draft=DRAFT_D512, paged=True, kv_quant="int8"),
                               LOGITS_REL_L2_TOL_INT8),
}
# The KV-cache modes: every model serves them (the rolling ones need a
# sliding window).
KV_MODES = ("dense", "int8", "fp8", "paged", "paged_prefix_shared", "paged_int8")


def draft_model(cfg: ModelConfig, sizes: dict, seed: int, device) -> tuple:
    """``(params, cfg)`` of a draft FlashLM of ``sizes`` (``DRAFT_D512``'s
    keys) with ``cfg``'s vocab, head dim, dtype and length, seeded."""
    dcfg = ModelConfig(vocab_size=cfg.vocab_size, head_dim=cfg.head_dim, dtype=cfg.dtype,
                       max_seq_len=cfg.max_seq_len, **sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    return init_params(dcfg, gen), dcfg


def engine_options(params: Params, cfg: ModelConfig, options: dict, seed: int = 0) -> tuple:
    """``(params, DecodeEngine keywords)`` of a mode's options: the
    weight-only int8 tree for ``weight_quant``, a seeded draft model for
    ``draft``."""
    opts = dict(options)
    if opts.pop("weight_quant", False):
        params = quantize_weights(params)
    if isinstance(opts.get("draft"), dict):
        opts["draft"] = draft_model(cfg, opts["draft"], seed, params["embed"].device)
    return params, opts

# The widest FlashLM the repo records (the model of train_bench.json), as
# ``build_engine`` keywords.
FLASHLM_D2048 = dict(
    vocab=32768, d_model=2048, n_layers=8, n_heads=16, n_kv_heads=8, d_ff=4096
)


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def host_context(device: torch.device) -> Dict[str, object]:
    """What the recorded numbers ran on."""
    ctx: Dict[str, object] = {"device": str(device), "host_cpus": os.cpu_count()}
    if torch.device(device).type == "cuda":
        ctx["gpu"] = torch.cuda.get_device_name(device)
        ctx["nvidia_smi"] = nvidia_smi_line()
    return ctx


def _fence(device: torch.device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_engine(
    *,
    max_batch: int = 8,
    max_len: int = 2048,
    n_layers: int = 4,
    d_model: int = 512,
    n_heads: int = 8,
    n_kv_heads: int = 4,
    d_ff: int = 2048,
    vocab: int = 32768,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    device="cuda",
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi: bool = False,
    attn_dropout: float = 0.0,
    **engine_kwargs,
) -> tuple:
    """A ``DecodeEngine`` over a FlashLM with seeded random weights
    (``window``, ``sinks``: its sliding-window attention; ``softcap``,
    ``alibi``: its score transforms; ``attn_dropout``: its training-time
    dropout rate, which serving never applies: the engine passes no
    seeds).  ``engine_kwargs``: a ``SERVING_MODES`` entry's options
    (``engine_options``) or the engine's own."""
    cfg = ModelConfig(
        vocab_size=vocab, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv_heads, head_dim=64, d_ff=d_ff, max_seq_len=max_len,
        dtype=dtype, attn_window=window, attn_sinks=sinks, attn_softcap=softcap,
        attn_alibi=alibi, attn_dropout=attn_dropout,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params, opts = engine_options(init_params(cfg, gen), cfg, engine_kwargs, seed)
    eng = DecodeEngine(params, cfg, max_batch=max_batch, max_len=max_len, seed=seed, **opts)
    return eng, cfg


def make_requests(
    n: int,
    vocab: int,
    prompt_lens: Sequence[int],
    max_new: int,
    seed: int,
    shared_prefix: int = 0,
) -> List[Request]:
    """``n`` requests with prompt lengths drawn from ``[lo, hi]``; odd uids
    sample at temperature 0.8 with top-k 50, even uids are greedy (the mix
    of ``examples/generate.py``).  The first ``shared_prefix`` prompt
    tokens are common to all requests (the JAX bench's prefix-sharing
    traffic); ``lo`` must be at least ``shared_prefix``."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_lens
    if lo < shared_prefix:
        raise ValueError(f"prompts of {lo} tokens cannot hold a {shared_prefix}-token prefix")
    common = rng.integers(1, vocab, shared_prefix).tolist()
    reqs = []
    for uid in range(n):
        n_tail = int(rng.integers(lo, hi + 1)) - shared_prefix
        reqs.append(Request(
            uid=uid,
            prompt=common + rng.integers(1, vocab, n_tail).tolist(),
            max_new_tokens=max_new,
            temperature=0.8 if uid % 2 else 0.0,
            top_k=50 if uid % 2 else 0,
        ))
    return reqs


def run_serving_bench(
    eng: DecodeEngine, requests: List[Request], mode: str = "dense", log=print
) -> Dict[str, object]:
    """Serve ``requests`` to completion and time it end to end.

    ``mode`` is the ``SERVING_MODES`` name ``eng`` was built with; it
    labels the result.  The timed region starts and ends with a device
    fence and includes every admission (prefill) and decode step.  Run a
    warm-up request through the engine first so one-time set-up stays
    outside it.
    """
    for req in requests:
        eng.submit(req)
    _fence(eng.device)
    steps0, stats0 = eng.steps, eng.stats()
    t0 = time.perf_counter()
    while eng.pending():
        eng.step()
    _fence(eng.device)
    elapsed = time.perf_counter() - t0
    steps, stats = eng.steps - steps0, eng.stats()
    tokens = sum(len(r.generated) for r in requests)
    cfg = eng.cfg
    result = {
        "mode": mode,
        "host": host_context(eng.device),
        "model": {
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": str(cfg.dtype),
        },
        "max_batch": len(eng.slots),
        "n_requests": len(requests),
        "decode_steps": steps,
        "elapsed_s": elapsed,
        "total_generated_tokens": tokens,
        "tokens_per_s": tokens / elapsed,
        "ms_per_step": elapsed / max(steps, 1) * 1e3,
        "pages_reserved": int(stats["pages_reserved"] - stats0["pages_reserved"]),
        "pages_adopted": int(stats["pages_adopted"] - stats0["pages_adopted"]),
    }
    log(
        f"serving[{mode}]: {tokens} tokens in {elapsed:.3f}s over {steps} "
        f"steps -> {result['tokens_per_s']:.1f} tok/s, "
        f"{result['ms_per_step']:.3f} ms/step (batch {len(eng.slots)})"
    )
    return result


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want) / torch.linalg.vector_norm(want))


def teacher_forced_errors(
    params: Params,
    cfg: ModelConfig,
    prompts: List[List[int]],
    n_decode: int,
    max_len: int,
    seed: int = 0,
    mode: str = "dense",
    reference_params: Optional[Params] = None,
) -> List[float]:
    """Relative L2 errors of served logits against a plain fp32 forward.

    A fresh ``DecodeEngine`` of ``mode`` (a ``SERVING_MODES`` name) with
    one slot per prompt prefills each prompt into its slot through the
    engine's own admission (``prefill_request``: page reservation and, with
    prefix sharing, adoption of the pages a prompt shares with an earlier
    one, whose tail alone is prefilled; at least one page must be adopted).
    Then ``n_decode`` teacher-forced ``decode_step``s feed seeded tokens to
    all slots at once, each after the engine's page growth
    (``grow_for_decode``); the speculative mode feeds them as its verify
    chunks of ``gamma + 1`` rows (``n_decode`` a multiple of it).  A
    multi-step mode runs the engine's dispatch (``decode_and_sample_multi``,
    greedy) from the first seeded token: each step is fed the token the one
    before it chose on the device, and those tokens are the ones the
    reference forwards.  The
    reference runs the same tokens through ``forward`` in fp32 with the
    oracle attention and no cache, with the mode's weights (the weight-only
    int8 tree dequantized).  Returns one error per slot per step (the
    prefill's last-token logits first).  Logits, not tokens, are compared:
    with random weights the top logit flips on rounding.
    ``reference_params``: the reference's weights instead (the weight-only
    int8 mode's error against the unquantized model).
    """
    device = params["embed"].device
    rng = np.random.default_rng(seed)
    cont = rng.integers(1, cfg.vocab_size, (len(prompts), n_decode))
    params, opts = engine_options(params, cfg, SERVING_MODES[mode][0], seed)
    eng = DecodeEngine(params, cfg, max_batch=len(prompts), max_len=max_len, **opts)
    served: List[List[torch.Tensor]] = []
    for slot, prompt in enumerate(prompts):
        req = Request(uid=slot, prompt=list(prompt), max_new_tokens=n_decode)
        logits = eng.prefill_request(slot, req)
        if logits is None:
            raise MemoryError(f"the page pool cannot take prompt {slot}")
        served.append([logits])
    if SERVING_MODES[mode][0].get("prefix_share") and not eng.stats()["pages_adopted"]:
        raise ValueError("no prompt shares a full page with an earlier one")
    active = torch.ones((len(prompts),), dtype=torch.bool, device=device)
    multi = opts.get("multi_step", 1)
    rows = eng._spec_gamma + 1 if "draft" in opts else 1
    if n_decode % rows:
        raise ValueError(f"n_decode={n_decode} must be a multiple of the {rows}-row chunk")
    greedy = torch.zeros((len(prompts),), dtype=torch.float32, device=device)
    chunk = max(multi, rows)
    for t in range(0, n_decode, chunk):
        n = min(chunk, n_decode - t)
        eng.grow_for_decode(range(len(prompts)), n)
        toks = torch.from_numpy(cont[:, t : t + n].astype(np.int32)).to(device)
        if multi > 1:
            # Each step is fed the token the one before it chose, on the
            # device: those become the continuation the reference forwards.
            chosen, _, eng.cache, logits = decode_and_sample_multi(
                params, cfg, eng.cache, toks[:, 0], active, eng.generator, greedy, n_steps=n,
                with_logits=True)
            cont[:, t + 1 : t + n + 1] = chosen.T.cpu().numpy()[:, : n_decode - t - 1]
            logits = logits.transpose(0, 1)
        elif rows == 1:
            logits, eng.cache = decode_step(params, cfg, eng.cache, toks[:, 0], active)
            logits = logits[:, None]
        else:
            logits, eng.cache = _forward_chunk(params, cfg, eng.cache, toks)
            eng.cache = bump_lengths(eng.cache, rows, active)
        for slot in range(len(prompts)):
            served[slot].extend(logits[slot])

    ref_cfg = dataclasses.replace(cfg, dtype=torch.float32, attn_impl="reference")
    errors = []
    for slot, prompt in enumerate(prompts):
        seq = torch.tensor([list(prompt) + cont[slot].tolist()], device=device)
        ref = forward(params if reference_params is None else reference_params, seq,
                      ref_cfg)[0]
        for i, got in enumerate(served[slot]):
            errors.append(_rel_l2(got, ref[len(prompt) - 1 + i]))
    return errors


# The runs of ``serving_suite`` after the dense one, under the JAX CLI's
# result keys: (key, SERVING_MODES name, multi_step override, shared prefix
# as a fraction of the prompt).
SUITE_RUNS = (("paged", "paged", None, 0.0),
              ("paged_prefix_shared", "paged_prefix_shared", None, 0.5),
              ("multi_step_8", "dense", 8, 0.0),
              ("weight_int8", "weight_int8", None, 0.0))


def serving_suite(*, max_batch: int = 8, n_requests: int = 16, prompt_len: int = 128,
                  max_new: int = 128, dense_only: bool = False, multi_step: int = 1,
                  max_len: int = 2048, device="cuda", log=print, **model) -> Dict[str, object]:
    """The JAX serving CLI's runs (JAX ``harness/serving.py:180-222``) on
    ``build_engine``'s FlashLM (``model``: its sizes): ``n_requests``
    greedy requests of ``prompt_len`` tokens and ``max_new`` new ones at
    ``multi_step``, served dense; then, unless ``dense_only``, paged, paged
    with the first ``prompt_len // 2`` tokens shared (prefix sharing),
    multi-step 8 and weight-only int8, each under its JAX key
    (``SUITE_RUNS``) in the dense run's result."""
    if prompt_len + max_new > max_len:
        raise ValueError(f"prompt_len + max_new = {prompt_len + max_new} > max_len {max_len}")
    runs = [("dense", "dense", None, 0.0)] + ([] if dense_only else list(SUITE_RUNS))
    result: Dict[str, object] = {}
    for key, mode, steps, shared in runs:
        options = {**SERVING_MODES[mode][0], "multi_step": steps or multi_step}
        eng, cfg = build_engine(max_batch=max_batch, max_len=max_len, device=device, **model,
                                **options)
        eng.submit(Request(uid=-1, prompt=list(range(1, min(prompt_len, 100) + 1)),
                           max_new_tokens=4))
        eng.run()
        prefix = int(prompt_len * shared)
        requests = make_requests(n_requests, cfg.vocab_size, (prompt_len, prompt_len), max_new,
                                 seed=0, shared_prefix=prefix)
        for req in requests:
            req.temperature, req.top_k = 0.0, 0
        run = run_serving_bench(eng, requests, mode=key, log=log)
        run.update(shared_prefix=prefix, multi_step=options["multi_step"],
                   prompt_len=prompt_len, max_new=max_new)
        if key == "dense":
            result.update(run)
        else:
            result[key] = run
        del eng
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Serving benchmark of the PyTorch port (on the card)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--dense-only", action="store_true",
                    help="skip the paged / prefix-shared / multi-step / int8-weight runs")
    ap.add_argument("--multi-step", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    result = serving_suite(max_batch=args.max_batch, n_requests=args.requests,
                           prompt_len=args.prompt_len, max_new=args.max_new,
                           dense_only=args.dense_only, multi_step=args.multi_step)
    result["card"] = nvidia_smi_line()
    with open("serving_bench_torch.json", "w") as f:
        json.dump(result, f, indent=2)
    print("wrote serving_bench_torch.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
