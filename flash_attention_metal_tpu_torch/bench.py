"""Benchmark of the port on the card: ONE JSON line on stdout.

    python -m flash_attention_metal_tpu_torch.bench [--detail bench_detail_torch.json]

Counterpart of the JAX package's ``bench.py`` (which stays at the repo's
root): the same sweep, pairs and phases, on the port's kernels.

* Sweep: N = 128 .. 8192 at B = ``amortizing_batch(N)``, H = 1, D = 64;
  the naive kernel on fp32 against ``flash_attention_mxu`` on bf16, both
  non-causal and causal, timed in pairs (``measure_kernel_pair``).  The
  headline is the non-causal geomean of naive / flash, like for like with
  the Metal reference's published V2 sweep (non-causal, B = H = 1, D = 64),
  so ``vs_baseline`` divides it by that sweep's 3.56x geomean
  (``BASELINE.md``): a ratio measured on an Apple GPU, not a target.
* High occupancy: B16 H8 N2048 causal bf16, the forward and the backward
  through the routers, with TF/s and the share of the H100's roofline.
* Spot check: the backward on a 128-row slice of those tensors against the
  closed-form oracle gradient at 1e-2 max-abs, the JAX bench's contract.
  The cotangent is ``q * 0.01``, so the gradients are ~1e-3 to 3e-2 and a
  fault in dQ alone can stay inside it; the detail also records the error
  relative to the oracle gradient's max-abs.  The kernels' real gate is
  ``chip_smoke.py``'s normalised triangular-backward check.

The JSON line has ``metric``, ``value``, ``unit``, ``vs_baseline`` and
``card`` (the card's name and power limit as ``nvidia-smi`` prints them).
Everything else goes to stderr and to the detail file, with each kernel's
launches over the run.  If the run outlasts ``BUDGET_S`` seconds, a watchdog
prints the line with ``"value": null`` and the points done so far, and the
process exits 3.  Without a CUDA card the bench exits 1 and prints no line.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

from .harness.benchmark import amortizing_batch
from .harness.serving import nvidia_smi_line
from .kernels import flash_bwd, flash_fwd, flash_tri, flash_v1, naive
from .kernels.flash_bwd import flash_attention_bwd_auto
from .kernels.flash_fwd import flash_attention_fwd
from .kernels.flash_mxu import flash_attention_mxu
from .kernels.naive import naive_attention
from .reference import attention_reference_bwd, make_qkv
from .utils.roofline import (
    ChipSpec,
    attention_bytes,
    attention_flops,
    detect_chip,
    roofline_fraction,
)
from .utils.timing import measure, measure_kernel_pair

# The Metal reference's V2 speedups over its N sweep (BASELINE.md): geomean.
REFERENCE_GEOMEAN_SPEEDUP = 3.56
# The reference's published sweep, naive capped at 8192 (BASELINE.md).
SWEEP = (128, 256, 512, 1024, 2048, 4096, 8192)
METRIC = (
    "non-causal flash-attn (bf16, hand-written CUDA) geomean speedup vs naive "
    "(fp32), N=128-8192, D=64, dispatch-amortized batches"
)
DETAIL_PATH = Path("bench_detail_torch.json")
HIGH_OCCUPANCY = (16, 8, 2048, 64)
SPOT_CHECK_ROWS, SPOT_CHECK_TOL = 128, 1e-2
# Seconds before the watchdog prints the null line and ends the process.
BUDGET_S = 600.0

# The wrapper of every CUDA kernel, by the name the records use.
KERNELS: Dict[str, Callable] = {
    "naive": naive.naive_attention,
    "flash_fwd": flash_fwd.flash_fwd_general,
    "flash_lean": flash_fwd.flash_fwd_lean,
    "flash_tri": flash_tri.flash_attention_tri,
    "flash_tri_bwd": flash_tri.flash_attention_bwd_tri,
    "flash_bwd_dkv": flash_bwd.flash_bwd_dkv,
    "flash_bwd_dq": flash_bwd.flash_bwd_dq,
    "flash_bwd_fused": flash_bwd.flash_bwd_fused,
    "flash_v1": flash_v1.flash_v1_stream,
    "flash_v1_folded": flash_v1.flash_v1_folded,
}


def kernel_launches() -> Dict[str, int]:
    """Each CUDA kernel's launch count since import."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def result_line(geomean: Optional[float], card: str) -> dict:
    """The benchmark's one stdout record."""
    return {
        "metric": METRIC,
        "value": None if geomean is None else round(geomean, 3),
        "unit": "x",
        "vs_baseline": None if geomean is None else round(geomean / REFERENCE_GEOMEAN_SPEEDUP, 3),
        "card": card,
    }


def geomean(xs: Sequence[float]) -> float:
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


class Watchdog:
    """Prints the null result line, with the points done so far, and ends
    the process if the run outlasts its budget; ``finish`` prints the real
    line instead.  One of the two lines is printed, never both."""

    def __init__(self, budget_s: float, card: str, progress: dict, exit_fn=os._exit):
        self._lock = threading.Lock()
        self._done = False
        self._card, self._progress, self._exit = card, progress, exit_fn
        self._timer = threading.Timer(budget_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def _fire(self) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
            line = result_line(None, self._card)
            line["points_done"] = [
                {"n": p["n"], "causal": causal, "speedup": p["speedup"]}
                for causal, key in ((False, "sweep"), (True, "sweep_causal"))
                for p in list(self._progress.get(key, []))
            ]
            print(json.dumps(line), flush=True)
            print("bench: watchdog budget exceeded", file=sys.stderr, flush=True)
            self._exit(3)

    def finish(self, line: dict) -> bool:
        """Print ``line`` unless the watchdog already fired."""
        with self._lock:
            if self._done:
                return False
            self._done = True
            self._timer.cancel()
            print(json.dumps(line), flush=True)
            return True


def run_sweep(sweep: Sequence[int], detail: dict, log: Callable[[str], None]) -> None:
    """The paired naive / flash sweep, appended point by point to
    ``detail["sweep"]`` (non-causal) and ``detail["sweep_causal"]``."""
    gen = torch.Generator(device="cuda")
    for n in sweep:
        b = amortizing_batch(n)
        gen.manual_seed(42)
        q, k, v = make_qkv(gen, (b, 1, n, 64))
        qh, kh, vh = (x.bfloat16() for x in (q, k, v))
        for causal in (False, True):
            pair = measure_kernel_pair(
                functools.partial(naive_attention, causal=causal), (q, k, v),
                functools.partial(flash_attention_mxu, causal=causal), (qh, kh, vh),
                repeats=5 if n <= 2048 else 3,
            )
            t_naive, t_flash, sp = pair["a_s"], pair["b_s"], pair["ratio"]
            flops = attention_flops(b, 1, n, n, 64, causal=causal)
            rs = pair["ratio_samples"]
            detail["sweep_causal" if causal else "sweep"].append({
                "n": n,
                "batch": b,
                "naive_ms": t_naive * 1e3,
                "flash_ms": t_flash * 1e3,
                "speedup": sp,
                "speedup_min": rs[0],
                "speedup_max": rs[-1],
                "ratio_samples": rs,
                "flash_tflops": flops / t_flash / 1e12,
                "naive_tflops": attention_flops(b, 1, n, n, 64) / t_naive / 1e12,
            })
            log(f"N={n} B={b}{' causal' if causal else ''}: naive {t_naive * 1e3:.4f} ms, "
                f"flash {t_flash * 1e3:.4f} ms, speedup {sp:.2f}x "
                f"(flash {flops / t_flash / 1e12:.1f} TF/s)")


def run_high_occupancy(spec: ChipSpec, log: Callable[[str], None]) -> dict:
    """B16 H8 N2048 causal bf16: forward and backward through the routers
    (the triangular kernels), then the 128-row backward spot check."""
    b, h, n, d = HIGH_OCCUPANCY
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    q, k, v = make_qkv(gen, (b, h, n, d), dtype=torch.bfloat16)
    do = q * 0.01
    fwd = functools.partial(flash_attention_fwd, causal=True, save_lse=True)
    t_fwd = measure(fwd, (q, k, v), iters=20)["median_s"]
    o, lse = fwd(q, k, v)
    t_bwd = measure(functools.partial(flash_attention_bwd_auto, causal=True),
                    (q, k, v, o, do, lse), iters=20)["median_s"]
    f_fwd = attention_flops(b, h, n, n, d, causal=True)
    f_bwd = attention_flops(b, h, n, n, d, causal=True, backward=True)
    bts = attention_bytes(b, h, n, n, d, 2)
    # The backward reads q, k, v, o, dO and writes dQ, dK, dV (8 tensors)
    # plus the fp32 lse and delta rows, as the JAX bench counts it.
    bts_bwd = 8 * b * h * n * d * 2 + 2 * b * h * n * 4
    out = {
        "shape": [b, h, n, d],
        "fwd_ms": t_fwd * 1e3,
        "bwd_ms": t_bwd * 1e3,
        "fwd_tflops": f_fwd / t_fwd / 1e12,
        "bwd_tflops": f_bwd / t_bwd / 1e12,
        "fwd_roofline": roofline_fraction(t_fwd, f_fwd, bts, spec),
        "bwd_roofline": roofline_fraction(t_bwd, f_bwd, bts_bwd, spec),
    }
    log(f"high-occupancy B{b} H{h} N{n}: fwd {out['fwd_ms']:.4f} ms "
        f"({out['fwd_tflops']:.1f} TF/s, {out['fwd_roofline']:.1%} of roofline), "
        f"bwd {out['bwd_ms']:.4f} ms ({out['bwd_tflops']:.1f} TF/s, "
        f"{out['bwd_roofline']:.1%} of roofline)")

    # A 128-row slice of the timed tensors against the oracle gradient,
    # so the bench and the ladder cannot drift apart (main.mm:1087-1195).
    ns = SPOT_CHECK_ROWS
    qs, ks, vs, dos = (x[:1, :2, :ns].contiguous() for x in (q, k, v, do))
    os_, lses = fwd(qs, ks, vs)
    got = flash_attention_bwd_auto(qs, ks, vs, os_, dos, lses, causal=True)
    want = attention_reference_bwd(qs, ks, vs, dos, causal=True)
    errs = [float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)]
    diff = max(errs)
    rel = {name: e / float(w.float().abs().max())
           for name, e, w in zip(("dq", "dk", "dv"), errs, want)}
    out["bwd_spot_verify_max_diff"] = diff
    out["bwd_spot_verify_rel_diff"] = rel
    out["bwd_spot_verify_pass"] = diff < SPOT_CHECK_TOL
    log(f"bwd spot-verify (N={ns} slice vs oracle): max diff {diff:.2e} "
        f"({'PASS' if diff < SPOT_CHECK_TOL else 'FAIL'} @ {SPOT_CHECK_TOL:g}); relative to "
        f"max|oracle|: " + ", ".join(f"{k} {e:.2e}" for k, e in rel.items()))
    return out


def run_bench(
    sweep: Sequence[int] = SWEEP,
    *,
    spec: ChipSpec,
    log: Callable[[str], None],
    detail: Optional[dict] = None,
) -> dict:
    """The sweep, its geomeans and the high-occupancy phase; ``detail`` (a
    dict the caller may watch) fills as the points are measured."""
    detail = {} if detail is None else detail
    detail.update(sweep=[], sweep_causal=[])
    before = kernel_launches()
    run_sweep(sweep, detail, log)
    detail["geomean_speedup"] = geomean([p["speedup"] for p in detail["sweep"]])
    detail["geomean_speedup_causal"] = geomean([p["speedup"] for p in detail["sweep_causal"]])
    detail["geomean_band"] = [
        geomean([p["speedup_min"] for p in detail["sweep"]]),
        geomean([p["speedup_max"] for p in detail["sweep"]]),
    ]
    log(f"geomean: non-causal {detail['geomean_speedup']:.2f}x (band "
        f"{detail['geomean_band'][0]:.2f}-{detail['geomean_band'][1]:.2f}), causal "
        f"{detail['geomean_speedup_causal']:.2f}x")
    detail["high_occupancy"] = run_high_occupancy(spec, log)
    after = kernel_launches()
    detail["launches"] = {name: after[name] - before[name] for name in after}
    return detail


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--detail", default=str(DETAIL_PATH))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    spec = detect_chip()

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    log(f"bench on {torch.cuda.get_device_name(0)} ({card})")
    detail: dict = {"card": card}
    watchdog = Watchdog(BUDGET_S, card, detail)
    t0 = time.perf_counter()
    run_bench(SWEEP, spec=spec, log=log, detail=detail)
    detail["seconds"] = time.perf_counter() - t0
    path = Path(args.detail)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(detail, indent=2))
    log(f"launches: {detail['launches']}; detail in {path}")
    watchdog.finish(result_line(detail["geomean_speedup"], card))
    return 0 if detail["high_occupancy"]["bwd_spot_verify_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
