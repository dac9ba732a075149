"""The reference benchmark's sweep: a CSV table of the kernel ladder over N.

Counterpart of ``flash_attention_metal_tpu/harness/benchmark.py`` (the
Metal reference's own table, ``main.mm:596-1207``): per N, naive fp32
against FlashV1 (fp32), FlashV2 (fp32) and FlashMXU (bf16), each timed in a
pair with naive (``utils/timing.measure_kernel_pair``), the causal MXU
column alone (``device_ms``), speedups, TF/s and the share of the H100's
roofline; and the high-occupancy phase (B16 H8 N2048 causal bf16, forward
and backward, with a backward spot check against the oracle).  The CSV
schema is the JAX package's, byte for byte.  The JAX module's tunnel
calibration and native CSV writer are not carried.

    python -m flash_attention_metal_tpu_torch.harness.benchmark [--quick] [--csv PATH] [--json PATH]

writes ``benchmark_results_torch.csv`` by default (never the JAX package's
v5e ``benchmark_results.csv``).  Without a card it exits 1.  The tests call
``run_sweep`` and ``run_high_occupancy`` with ``device="cpu"``: the plain
versions run once each and every time is left blank (not measured), unless
a ``timer`` is injected.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
from typing import Callable, List, Optional, Sequence

import torch

from ..kernels import (
    flash_attention_bwd_auto,
    flash_attention_fwd,
    flash_attention_mxu,
    flash_attention_v1,
    flash_attention_v2,
    naive_attention,
)
from ..reference import attention_reference_bwd, make_qkv
from ..utils.roofline import attention_bytes, attention_flops, detect_chip, roofline_fraction
from ..utils.timing import device_ms, measure_kernel_pair

# Reference sweep (main.mm:608); naive skipped above 8192 (main.mm:673).
DEFAULT_SWEEP = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)
QUICK_SWEEP = (128, 512, 2048)
NAIVE_MAX_N = 8192
DEFAULT_CSV = "benchmark_results_torch.csv"

CSV_HEADER = (
    "N,B,Naive(ms),FlashV1(ms),FlashV2(ms),FlashMXU(ms),FlashMXU-causal(ms),"
    "SpeedupV1,SpeedupV2,SpeedupMXU,TFLOPs_MXU,TFLOPs_MXU_causal,"
    "Roofline_MXU,Roofline_MXU_causal"
)
# The reference's backward rung tolerance (main.mm:1191), the high-occupancy
# spot check's.
BWD_SPOT_TOL = 1e-1

# timer(fn, args, iters) -> seconds: replaces the CUDA-event timing.
Timer = Callable[[Callable[..., object], Sequence, int], float]


def amortizing_batch(n: int) -> int:
    """Batch of a sweep point at sequence length ``n``: B * N^2 ~ 2^23
    (B = 512 at N = 128 down to B = 1 from N = 4096), so every point is
    kernel work rather than the launch floor, for naive and flash alike."""
    return max(1, (1 << 23) // (n * n))


@dataclasses.dataclass
class SweepRow:
    """One CSV row; a None (not measured) prints as an empty cell."""

    n: int
    b: int
    naive_ms: Optional[float]
    v1_ms: Optional[float]
    v2_ms: Optional[float]
    mxu_ms: Optional[float]
    mxu_causal_ms: Optional[float]
    speedup_v1: Optional[float]
    speedup_v2: Optional[float]
    speedup_mxu: Optional[float]
    tflops_mxu: Optional[float]
    tflops_mxu_causal: Optional[float]
    roofline_mxu: Optional[float]
    roofline_mxu_causal: Optional[float]

    def csv(self) -> str:
        def f(x, spec=".4f"):
            return "" if x is None else format(x, spec)

        return ",".join([
            str(self.n), str(self.b),
            *(f(x) for x in (self.naive_ms, self.v1_ms, self.v2_ms, self.mxu_ms,
                             self.mxu_causal_ms, self.speedup_v1, self.speedup_v2,
                             self.speedup_mxu)),
            f(self.tflops_mxu, ".2f"), f(self.tflops_mxu_causal, ".2f"),
            f(self.roofline_mxu, ".3f"), f(self.roofline_mxu_causal, ".3f"),
        ])


class _Clock:
    """Seconds per call of a function: CUDA events on a card, the injected
    ``timer`` if any, else None (the function runs once, untimed)."""

    def __init__(self, device, iters: int, timer: Optional[Timer]):
        self.on_card = torch.device(device).type == "cuda"
        self.iters, self.timer = iters, timer

    def one(self, fn, args) -> Optional[float]:
        if self.timer is not None:
            return self.timer(fn, args, self.iters)
        if self.on_card:
            return device_ms(lambda: fn(*args), self.iters) * 1e-3
        fn(*args)
        return None

    def pair(self, fn_a, args_a, fn_b, args_b, repeats: int):
        """``(a_s, b_s, a_s / b_s)``, drift-matched (``measure_kernel_pair``)."""
        if self.timer is None and not self.on_card:
            fn_a(*args_a), fn_b(*args_b)
            return None, None, None
        p = measure_kernel_pair(fn_a, args_a, fn_b, args_b, repeats=repeats,
                                iters=self.iters, timer=self.timer)
        return p["a_s"], p["b_s"], p["ratio"]


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else seconds * 1e3


def run_sweep(
    sweep: Sequence[int] = DEFAULT_SWEEP,
    head_dim: int = 64,
    *,
    iters: int = 20,
    repeats: Optional[int] = None,
    device="cuda",
    timer: Optional[Timer] = None,
    log=print,
) -> List[SweepRow]:
    """Single-head N-sweep of the reference's setup (H = 1, D = 64) at the
    dispatch-amortized batch (B = 1 on the CPU); one ``SweepRow`` per N,
    logged as its CSV line.  ``repeats`` of each naive pair: 5 up to
    N = 4096, 3 above, by default."""
    clock = _Clock(device, iters, timer)
    spec = detect_chip(device) if clock.on_card else None
    rows = []
    for n in sweep:
        gen = torch.Generator(device=device)
        gen.manual_seed(42)
        b = amortizing_batch(n) if clock.on_card else 1
        q, k, v = make_qkv(gen, (b, 1, n, head_dim))
        qh, kh, vh = (x.bfloat16() for x in (q, k, v))
        reps = repeats or (5 if n <= 4096 else 3)
        if n <= NAIVE_MAX_N:
            _, v1_s, sp1 = clock.pair(naive_attention, (q, k, v), flash_attention_v1, (q, k, v), reps)
            _, v2_s, sp2 = clock.pair(naive_attention, (q, k, v), flash_attention_v2, (q, k, v), reps)
            naive_s, mxu_s, spm = clock.pair(naive_attention, (q, k, v), flash_attention_mxu,
                                             (qh, kh, vh), reps)
        else:
            naive_s = sp1 = sp2 = spm = None
            v1_s = clock.one(flash_attention_v1, (q, k, v))
            v2_s = clock.one(flash_attention_v2, (q, k, v))
            mxu_s = clock.one(flash_attention_mxu, (qh, kh, vh))
        mxuc_s = clock.one(functools.partial(flash_attention_mxu, causal=True), (qh, kh, vh))

        flops = attention_flops(b, 1, n, n, head_dim)
        flops_c = attention_flops(b, 1, n, n, head_dim, causal=True)
        bts = attention_bytes(b, 1, n, n, head_dim, 2)

        def rate(f, s):
            return None if s is None else f / s / 1e12

        def share(f, s):
            return None if s is None or spec is None else roofline_fraction(s, f, bts, spec)

        row = SweepRow(
            n=n, b=b, naive_ms=_ms(naive_s), v1_ms=_ms(v1_s), v2_ms=_ms(v2_s),
            mxu_ms=_ms(mxu_s), mxu_causal_ms=_ms(mxuc_s),
            speedup_v1=sp1, speedup_v2=sp2, speedup_mxu=spm,
            tflops_mxu=rate(flops, mxu_s), tflops_mxu_causal=rate(flops_c, mxuc_s),
            roofline_mxu=share(flops, mxu_s), roofline_mxu_causal=share(flops_c, mxuc_s),
        )
        rows.append(row)
        log(row.csv())
    return rows


def run_high_occupancy(
    batch: int = 16,
    heads: int = 8,
    n: int = 2048,
    head_dim: int = 64,
    *,
    iters: int = 20,
    device="cuda",
    timer: Optional[Timer] = None,
    log=print,
) -> dict:
    """The batched forward and backward phase (main.mm:881-1204, B=16 H=8):
    causal bf16 through the routers, inputs scaled by 0.01 (the reference's
    overflow guard, main.mm:951-954), and the backward of a 2-batch slice
    at the full length against the oracle gradient (tolerance 1e-1)."""
    clock = _Clock(device, iters, timer)
    spec = detect_chip(device) if clock.on_card else None
    gen = torch.Generator(device=device)
    gen.manual_seed(42)
    q, k, v = (x * 0.01 for x in make_qkv(gen, (batch, heads, n, head_dim), dtype=torch.bfloat16))
    gen.manual_seed(9)
    do = (torch.randn(q.shape, generator=gen, device=device) * 0.01).bfloat16()

    fwd = functools.partial(flash_attention_fwd, causal=True, save_lse=True)
    fwd_s = clock.one(fwd, (q, k, v))
    o, lse = fwd(q, k, v)
    bwd = functools.partial(flash_attention_bwd_auto, causal=True)
    bwd_s = clock.one(bwd, (q, k, v, o, do, lse))

    sl = slice(0, min(2, batch))
    got = bwd(*(x[sl].contiguous() for x in (q, k, v, o, do, lse)))
    want = attention_reference_bwd(q[sl], k[sl], v[sl], do[sl], causal=True)
    bwd_diff = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
    log(f"[{'PASS' if bwd_diff < BWD_SPOT_TOL else 'FAIL'}] high-occupancy backward vs oracle "
        f"(B=2 slice): max diff {bwd_diff:.3e} (tol {BWD_SPOT_TOL:.0e})")

    flops_f = attention_flops(batch, heads, n, n, head_dim, causal=True)
    flops_b = attention_flops(batch, heads, n, n, head_dim, causal=True, backward=True)
    bts = attention_bytes(batch, heads, n, n, head_dim, 2)

    def share(s, f, nbytes):
        return None if s is None or spec is None else roofline_fraction(s, f, nbytes, spec)

    result = {
        "batch": batch, "heads": heads, "n": n,
        "fwd_ms": _ms(fwd_s), "bwd_ms": _ms(bwd_s),
        "bwd_verify_max_diff": bwd_diff, "bwd_verify_pass": bwd_diff < BWD_SPOT_TOL,
        "fwd_tflops": None if fwd_s is None else flops_f / fwd_s / 1e12,
        "bwd_tflops": None if bwd_s is None else flops_b / bwd_s / 1e12,
        "fwd_roofline": share(fwd_s, flops_f, bts),
        "bwd_roofline": share(bwd_s, flops_b, 2 * bts),
    }
    if fwd_s is not None and bwd_s is not None:
        log(f"high-occupancy B={batch} H={heads} N={n}: fwd {result['fwd_ms']:.3f} ms "
            f"({result['fwd_tflops']:.1f} TFLOP/s), bwd {result['bwd_ms']:.3f} ms "
            f"({result['bwd_tflops']:.1f} TFLOP/s)")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="short sweep")
    ap.add_argument("--csv", default=DEFAULT_CSV)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from .serving import nvidia_smi_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    print(f"== benchmark on {torch.cuda.get_device_name(0)} ({card}) ==")
    print(CSV_HEADER)
    # Incremental CSV: each completed row lands on disk at once, so a run
    # cut by a time limit still leaves the rows done so far.
    with open(args.csv, "w") as f:
        f.write(CSV_HEADER + "\n")

    def log_row(line: str) -> None:
        print(line, flush=True)
        with open(args.csv, "a") as f:
            f.write(line + "\n")

    rows = run_sweep(QUICK_SWEEP if args.quick else DEFAULT_SWEEP, log=log_row)
    hi = run_high_occupancy(n=1024 if args.quick else 2048)
    print(f"wrote {args.csv}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "sweep": [dataclasses.asdict(r) for r in rows],
                       "high_occupancy": hi}, f, indent=2)
        print(f"wrote {args.json}")
    return 0 if hi["bwd_verify_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
