"""Kernel checks, device timing, the kernel sweep and the decode profile.

Shared by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``, and runnable on
its own on a CUDA card:

    python -m flash_attention_metal_tpu_torch.harness.onchip sweep
    python -m flash_attention_metal_tpu_torch.harness.onchip profile [serving|train]

``sweep`` times the forward kernel against slot length (decode) and chunk
offset (prefill).  ``profile`` (``serving``, the default) traces steady
decode steps and a prefill of the served FlashLM with ``torch.profiler``
and splits their wall time into device-busy time, by kernel, and idle time;
``profile train`` does the same for ``Trainer.step`` at the
``train_bench.json`` width.  Every line it prints carries the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..config import default_scale
from ..kernels.flash_bwd import flash_attention_bwd, flash_attention_bwd_plain
from ..kernels.flash_fwd import flash_attention_fwd, flash_attention_fwd_plain
from ..runtime import decode as decode_mod
from . import serving

SEED = 0
# Max-abs tolerances of the kernel against its fp32 plain version.  bf16
# is the verification ladder's half-precision rung (BASELINE.md).  fp32 is
# held well below the ladder's 1e-3 (it reads ~1e-7): TF32 products, or P
# rounded to bf16 on the fp32 path, would move outputs by ~1e-4 and fail.
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# Query scale of the peaked fixture.  On the ladder's uniform(-1, 1)
# inputs the scores have a standard deviation of ~0.33 at head_dim 64, the
# softmax of a long row is nearly flat and its outputs are ~0.02, so a
# kernel that rescales its accumulators wrongly between KV tiles can stay
# inside 1e-2.  Scaled by 8 the scores spread ~2.7, a few columns carry
# each row and the running max rises across tiles: such a fault moves
# outputs by O(0.1) (tests/test_torch_gpu.py plants it).
PEAKED_Q_SCALE = 8.0
PREFILL_Q, PREFILL_KV = (1, 16, 512, 64), (1, 8, 2048, 64)
DECODE_Q, DECODE_KV = (8, 8, 2, 64), (8, 8, 2048, 64)
# The training step's attention (train_bench.json: batch 4, seq 2048,
# 16 q-heads over 8 KV heads), and its fp32 case at N = 512.
TRAIN_Q, TRAIN_KV = (4, 16, 2048, 64), (4, 8, 2048, 64)
TRAIN_FP32_Q, TRAIN_FP32_KV = (4, 16, 512, 64), (4, 8, 512, 64)
# Backward kernels against their fp32 plain version: max-abs error over
# max-abs of the plain gradient, per gradient.  Gradients grow with N and
# with the fixture's peakedness (dK is O(10) on the peaked one), so an
# absolute bound would be either loose on the ladder or tight on the peaked
# fixture.  bf16: P and dS enter the products rounded to bf16 and the
# gradients are stored in bf16 (2^-9 each, relative), so 1e-2 is the
# ladder's half-precision rung on this scale.  fp32 reads ~1e-7 (IEEE FMA,
# other summation order); TF32 products would read ~1e-3 and fail 1e-5.
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def ladder_inputs(shape_q, shape_kv, dtype, gen, q_scale: float = 1.0):
    """uniform(-1, 1) q, k, v on the card (the verification ladder's
    fixture), with q scaled by ``q_scale``."""
    def u(shape, scale=1.0):
        x = torch.rand(shape, generator=gen, device="cuda", dtype=torch.float32)
        return ((2 * x - 1) * scale).to(dtype)
    return u(shape_q, q_scale), u(shape_kv), u(shape_kv)


def decode_lengths() -> np.ndarray:
    """Seeded slot lengths of the decode case, including 0 and 2046."""
    lengths = np.random.default_rng(SEED).integers(1, 2046, 8)
    lengths[0], lengths[1] = 0, 2046
    return lengths.astype(np.int32)


def path_cases(gen: torch.Generator) -> Dict[str, tuple]:
    """``{name: (q, k, v, q_offset, pos_div)}`` at the serving path's shapes.

    Prefill: a 512-row chunk of 16 q-heads over 8 KV heads and a
    2048-column cache, at offsets 0 and 512.  Folded decode: 8 slots,
    2 rows per KV head (``pos_div`` 2), at ``decode_lengths()``.  bf16 on
    the ladder fixture, then one fp32 case, then bf16 on the peaked one.
    """
    bf16 = torch.bfloat16
    lengths = torch.from_numpy(decode_lengths())
    cases = {}
    for off in (0, 512):
        cases[f"prefill_bf16_off{off}"] = (
            *ladder_inputs(PREFILL_Q, PREFILL_KV, bf16, gen), torch.tensor([off]), 1)
    cases["decode_bf16"] = (*ladder_inputs(DECODE_Q, DECODE_KV, bf16, gen), lengths, 2)
    cases["prefill_fp32_off512"] = (
        *ladder_inputs(PREFILL_Q, PREFILL_KV, torch.float32, gen), torch.tensor([512]), 1)
    cases["prefill_bf16_off512_peaked"] = (
        *ladder_inputs(PREFILL_Q, PREFILL_KV, bf16, gen, PEAKED_Q_SCALE),
        torch.tensor([512]), 1)
    cases["decode_bf16_peaked"] = (
        *ladder_inputs(DECODE_Q, DECODE_KV, bf16, gen, PEAKED_Q_SCALE), lengths, 2)
    return {
        name: (q, k, v, off.to("cuda", torch.int32), pos_div)
        for name, (q, k, v, off, pos_div) in cases.items()
    }


def train_cases(gen: torch.Generator) -> Dict[str, tuple]:
    """``{name: (q, k, v, do, q_offset)}`` at the training step's shapes:
    causal self-attention (offset 0), bf16 on the ladder and the peaked
    fixture, and fp32 at N = 512.  ``do`` is uniform(-1, 1) too."""
    cases = {}
    for name, shape_q, shape_kv, dtype, q_scale in (
        ("train_bf16", TRAIN_Q, TRAIN_KV, torch.bfloat16, 1.0),
        ("train_bf16_peaked", TRAIN_Q, TRAIN_KV, torch.bfloat16, PEAKED_Q_SCALE),
        ("train_fp32_n512", TRAIN_FP32_Q, TRAIN_FP32_KV, torch.float32, 1.0),
    ):
        q, k, v = ladder_inputs(shape_q, shape_kv, dtype, gen, q_scale)
        do = ladder_inputs(shape_q, shape_kv, dtype, gen)[0]
        off = torch.zeros((shape_q[0],), dtype=torch.int32, device="cuda")
        cases[name] = (q, k, v, do, off)
    return cases


def bwd_inputs(case: tuple) -> tuple:
    """``(q, k, v, o, do, lse, q_offset)``: a ``train_cases`` entry with the
    forward kernel's ``o`` and ``lse``, which the backward takes as given."""
    q, k, v, do, off = case
    o, lse = flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)
    return q, k, v, o, do, lse, off


def bwd_kernel_errors(inputs: tuple) -> Dict[str, Tuple[float, float]]:
    """``{"dq", "dk", "dv"}: (max-abs error, normalised error)`` of the
    backward kernels against the fp32 plain version on the same inputs; the
    normalised error (``BWD_TOL``'s measure) divides by the plain
    gradient's max-abs."""
    q, k, v, o, do, lse, off = inputs
    scale = default_scale(q.shape[-1])
    got = flash_attention_bwd(q, k, v, o, do, lse, off, sm_scale=scale, causal=True)
    want = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), do.float(), lse, off,
        sm_scale=scale, causal=True,
    )
    torch.cuda.synchronize()
    errors = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w).abs().max().item()
        errors[name] = (err, err / w.abs().max().item())
    return errors


def kernel_error(case: tuple) -> Tuple[float, float]:
    """Max-abs errors of the kernel's ``o`` and ``lse`` against the fp32
    plain version on one ``path_cases`` entry.  The lse error is inf when
    the two disagree on which rows see no column (``lse = -inf``)."""
    q, k, v, off, pos_div = case
    kw = dict(causal=True, pos_div=pos_div, save_lse=True)
    o, lse = flash_attention_fwd(q, k, v, off, **kw)
    o_ref, lse_ref = flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), off, sm_scale=default_scale(q.shape[-1]), **kw
    )
    torch.cuda.synchronize()
    err = (o.float() - o_ref).abs().max().item()
    finite = torch.isfinite(lse_ref)
    if not torch.equal(finite, torch.isfinite(lse)):
        return err, float("inf")
    return err, (lse[finite] - lse_ref[finite]).abs().max().item()


def device_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Median device time of ``fn`` on CUDA events.

    Before each call the L2 is flushed (serving finds the KV cache cold:
    8 layers of it exceed the 50 MB L2) and a large matmul keeps the card
    busy while the host queues ``fn``, so the events bracket device work
    only, not the host's time to launch it.  The median, not the mean: a
    call whose host was descheduled for longer than the matmul still
    carries the wait.
    """
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    busy = torch.zeros((8192, 8192), dtype=torch.bfloat16, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.mm(busy, busy)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def wall_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Mean host-clock time of back-to-back calls of ``fn``, fenced."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def steady_decode(eng, lengths: torch.Tensor) -> Callable[[], None]:
    """One ``decode_and_sample`` step with every slot busy at ``lengths``."""
    active = torch.ones(len(eng.slots), dtype=torch.bool, device=eng.device)

    def step():
        eng.cache.lengths.copy_(lengths)
        decode_mod.decode_and_sample(
            eng.params, eng.cfg, eng.cache, eng.next_token, active, eng.generator,
            eng.temps, eng.top_ks, eng.top_ps, eng.pen_counts, eng.presences,
            eng.frequencies, eng.min_ps,
        )

    return step


def prefill_request(eng, n: int) -> Callable[[], None]:
    """Prefill of an ``n``-token prompt (``n`` a multiple of 128) into
    slot 0, which is then freed again."""
    tokens = torch.arange(1, n + 1, dtype=torch.int32, device=eng.device)

    def prefill():
        decode_mod.prefill_slot(eng.params, eng.cfg, eng.cache, tokens, n, 0)
        eng.cache.lengths.zero_()

    return prefill


def sweep(stamp: str, log=print) -> None:
    """Kernel device time against the longest slot (decode) and the chunk
    offset (prefill), on the ladder fixture in bf16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def time_case(shape_q, shape_kv, offsets, pos_div):
        q, k, v = ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)
        off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
        return device_ms(lambda: flash_attention_fwd(q, k, v, off, causal=True, pos_div=pos_div))

    for length in (64, 256, 1024, 2047):
        ms = time_case(DECODE_Q, DECODE_KV, [length] * 8, 2)
        log(f"[sweep] decode {DECODE_Q}, all 8 slots at {length}: {ms:.4f} ms ({stamp})")
    ms = time_case(DECODE_Q, DECODE_KV, [2047] + [64] * 7, 2)
    log(f"[sweep] decode {DECODE_Q}, one slot at 2047, seven at 64: {ms:.4f} ms ({stamp})")
    for off in (0, 512, 1536):
        ms = time_case(PREFILL_Q, PREFILL_KV, [off], 1)
        log(f"[sweep] prefill {PREFILL_Q} x kv {PREFILL_KV}, offset {off}: {ms:.4f} ms ({stamp})")


def _device_breakdown(fn: Callable[[], object], iters: int) -> Tuple[float, Dict[str, List[float]]]:
    """Device-busy ms per call of ``fn`` (union of the kernels' intervals)
    and ``{kernel: [ms per call, launches per call]}``, from a trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans, kernels = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        entry = kernels.setdefault(ev.name, [0.0, 0.0])
        entry[0] += (end - start) / 1e3 / iters
        entry[1] += 1 / iters
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us / 1e3 / iters, kernels


def profile_serving(eng, stamp: str, iters: int = 20, log=print) -> None:
    """Where a decode step and a 512-token prefill spend their wall time.

    Wall time is measured without the profiler (it slows the host); busy
    time is the union of the traced kernels' intervals; idle = 1 - busy /
    wall.  The decode step runs every slot at ``decode_lengths()``.
    """
    phases = (
        ("decode step, batch 8", steady_decode(eng, torch.from_numpy(decode_lengths()).to(eng.device))),
        ("prefill, 512 tokens", prefill_request(eng, 512)),
    )
    for what, fn in phases:
        wall = wall_ms(fn, iters)
        busy, kernels = _device_breakdown(fn, iters)
        launches = sum(n for _, n in kernels.values())
        log(f"[profile] {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
            f"{1 - busy / wall:.1%}, {launches:.0f} device ops per call ({stamp})")
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        for name, (ms, n) in top:
            log(f"[profile]   {ms * 1e3:9.1f} us in {n:4.0f} ops  {name[:100]}")


def profile_train(stamp: str, iters: int = 3, log=print) -> Dict[str, float]:
    """Where a full-width ``Trainer.step`` (L8 d2048, batch 4, seq 2048)
    spends its wall time: device busy and idle, the top device ops, and the
    backward kernels' share of the step."""
    from ..models.trainer import Trainer, make_optimizer
    from .train_bench import fixed_batch, flashlm_config

    cfg = flashlm_config()
    trainer = Trainer(cfg, optimizer=make_optimizer(warmup_steps=2), seed=SEED, device="cuda")
    tokens = fixed_batch(cfg, 4, 2048, SEED + 1)
    step = lambda: trainer.step(tokens)  # noqa: E731
    wall = wall_ms(step, iters)
    busy, kernels = _device_breakdown(step, iters)
    launches = sum(n for _, n in kernels.values())
    bwd_ms = sum(ms for name, (ms, _) in kernels.items() if "flash_bwd" in name)
    fwd_ms = sum(ms for name, (ms, _) in kernels.items() if "flash_fwd" in name)
    log(f"[profile] train step, L{cfg.n_layers} d{cfg.d_model} b4 s2048: wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms, idle {1 - busy / wall:.1%}, {launches:.0f} device ops "
        f"per step ({stamp})")
    log(f"[profile]   backward kernels {bwd_ms:.3f} ms = {bwd_ms / wall:.1%} of the step; "
        f"forward kernel {fwd_ms:.3f} ms = {fwd_ms / wall:.1%}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[profile]   {ms * 1e3:9.1f} us in {n:4.0f} ops  {name[:100]}")
    return {"wall_ms": wall, "busy_ms": busy, "bwd_ms": bwd_ms, "fwd_ms": fwd_ms}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("sweep", "profile"))
    parser.add_argument("target", nargs="?", choices=("serving", "train"), default="serving")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    stamp = serving.nvidia_smi_line()
    if args.what == "sweep":
        sweep(stamp)
        return 0
    if args.target == "train":
        profile_train(stamp)
        return 0
    eng, _ = serving.build_engine(
        **serving.FLASHLM_D2048, max_batch=8, max_len=2048, seed=SEED, device="cuda"
    )
    profile_serving(eng, stamp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
