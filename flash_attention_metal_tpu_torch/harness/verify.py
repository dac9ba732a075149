"""Verification ladder of the port.

Counterpart of ``flash_attention_metal_tpu/harness/verify.py``: each rung is
a max-abs difference at the reference's tolerance, and the rungs chain as
there: fp32 kernels anchor to the golden oracle, upper rungs difference
against the verified naive rung, causal and backward rungs get their own
fixtures.  One ``[PASS]``/``[FAIL]`` line per rung, in the same format.

The rungs whose kernels are ported run (1, 3, 4, 5, 5-causal, 6, 7, 7b,
7c); the others print a ``[SKIP]`` line naming what they wait for and are
never counted as passes.  ``device="cpu"`` runs every kernel's plain
version (the tests do); the default runs the CUDA kernels.

    python -m flash_attention_metal_tpu_torch.harness.verify [--n 1024] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, List

import torch

from ..kernels import (
    flash_attention_bwd,
    flash_attention_bwd_tri,
    flash_attention_fwd,
    flash_attention_mxu,
    flash_attention_tri,
    flash_attention_v2,
    naive_attention,
)
from ..reference import attention_reference, attention_reference_bwd, make_qkv

# The reference tolerance ladder (SURVEY.md, H4).
TOL_FP32 = 1e-3  # main.mm:239,253,292
TOL_V3 = 5e-3  # main.mm:375
TOL_HALF = 1e-2  # main.mm:452,591
TOL_BWD = 1e-1  # main.mm:1191

# Rungs of the JAX ladder that wait for a kernel or a feature of the port.
SKIPPED_RUNG_2 = (
    "flash_v1 vs naive (fp32)", "kernels/flash_v1.py not ported (ROADMAP Queue B 1)",
)
SKIPPED_UPPER_RUNGS = (
    ("flash_quant int8-KV causal vs causal oracle", "not ported (ROADMAP Queue B 3)"),
    ("flash_quant fp8-KV causal vs causal oracle", "not ported (ROADMAP Queue B 3)"),
    ("flash MQA (native head-fold) vs oracle",
     "not in this slice's ladder (ROADMAP Queue A item 2)"),
    ("flash sliding-window vs oracle", "not ported (ROADMAP Queue A item 5)"),
    ("flash block-sparse mask vs oracle", "not ported (ROADMAP Queue B 5)"),
    ("flash paged-KV prefill vs causal oracle", "not ported (ROADMAP Queue B 4)"),
    ("flash paged-KV decode chunk vs causal oracle", "not ported (ROADMAP Queue B 4)"),
    ("flash softcap causal vs oracle", "not ported (ROADMAP Queue A item 5)"),
    ("flash ALiBi causal vs oracle", "not ported (ROADMAP Queue A item 5)"),
    ("flash_quant int8-KV softcap+ALiBi vs oracle", "not ported (ROADMAP Queue B 3)"),
    ("flash paged-KV softcap+ALiBi vs oracle", "not ported (ROADMAP Queue B 4)"),
    ("softcap backward (dQ,dK,dV) vs oracle", "not ported (ROADMAP Queue A item 5)"),
    ("ALiBi backward (dQ,dK,dV) vs oracle", "not ported (ROADMAP Queue A item 5)"),
    ("ALiBi backward d_slopes vs oracle (relative)", "not ported (ROADMAP Queue A item 5)"),
    ("GQA-fold backward dQ vs oracle", "not in this slice's ladder (ROADMAP Queue A item 2)"),
    ("GQA-fold backward dK,dV (group-summed in-kernel) vs oracle",
     "not in this slice's ladder (ROADMAP Queue A item 2)"),
    ("flash dropout (p=0.2) causal vs oracle", "not ported (ROADMAP Queue A item 5)"),
    ("flash dropout backward (dQ,dK,dV) vs oracle", "not ported (ROADMAP Queue A item 5)"),
)


@dataclasses.dataclass
class RungResult:
    name: str
    max_diff: float
    tolerance: float
    has_nan: bool

    @property
    def passed(self) -> bool:
        return (self.max_diff < self.tolerance) and not self.has_nan

    def line(self) -> str:
        status = "PASS" if self.passed else "FAIL"
        nan = " [NaN!]" if self.has_nan else ""
        return (
            f"[{status}] {self.name}: max diff {self.max_diff:.3e} "
            f"(tol {self.tolerance:.0e}){nan}"
        )


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _skip(name: str, why: str) -> str:
    return f"[SKIP] {name}: {why}"


def run_ladder(
    n: int = 1024,
    head_dim: int = 64,
    batch: int = 1,
    heads: int = 2,
    *,
    device="cuda",
    log: Callable[[str], None] = print,
) -> List[RungResult]:
    """Run the ported rungs on ``device``; returns their results."""
    gen = torch.Generator(device=device)
    gen.manual_seed(42)  # seed parity with main.mm:25
    shape = (batch, heads, n, head_dim)
    q, k, v = make_qkv(gen, shape)
    results: List[RungResult] = []

    def rung(name, got, want, tol):
        r = RungResult(name, _diff(got, want), tol, bool(torch.isnan(got).any()))
        results.append(r)
        log(r.line())

    oracle = attention_reference(q, k, v)

    # Rung 1: naive vs oracle (main.mm:232-242).
    nv = naive_attention(q, k, v)
    rung("naive vs oracle (fp32)", nv, oracle, TOL_FP32)

    # Rung 2: the V1 kernel waits for the next slice.
    log(_skip(*SKIPPED_RUNG_2))

    # Rung 3: V2 (fp32) vs naive (main.mm:277-295): the lean kernel.
    rung("flash_v2 vs naive (fp32)", flash_attention_v2(q, k, v), nv, TOL_FP32)

    # Rung 4: V3 parity, fp16 inputs at 5e-3 (main.mm:375): the fp32
    # route on fp16-rounded inputs.
    q16, k16, v16 = (x.half() for x in (q, k, v))
    rung("flash_mxu fp16 vs naive (V3 parity)", flash_attention_mxu(q16, k16, v16), nv, TOL_V3)

    # Rung 5: bf16 vs naive (main.mm:443-455).
    qh, kh, vh = (x.bfloat16() for x in (q, k, v))
    rung("flash_mxu bf16 vs naive", flash_attention_mxu(qh, kh, vh), nv, TOL_HALF)

    # Rung 5, causal: the triangular kernel vs the causal oracle.
    oracle_c = attention_reference(q, k, v, causal=True)
    mxc = flash_attention_mxu(qh, kh, vh, causal=True)
    rung("flash_mxu bf16 causal vs causal oracle", mxc, oracle_c, TOL_HALF)

    # Rung 6: fp32 backward (the split pair, from the triangular forward's
    # o and lse) vs the oracle gradient (main.mm:1087-1195).
    gen.manual_seed(7)
    do = torch.randn(shape, generator=gen, device=device) * 0.1
    o_f, lse = flash_attention_fwd(q, k, v, causal=True, save_lse=True)
    dq, dk, dv = flash_attention_bwd(q, k, v, o_f, do, lse, causal=True)
    dq_r, dk_r, dv_r = attention_reference_bwd(q, k, v, do, causal=True)
    rung("backward dQ vs oracle (fp32, causal)", dq, dq_r, TOL_FP32)
    rung("backward dK vs oracle (fp32, causal)", dk, dk_r, TOL_FP32)
    rung("backward dV vs oracle (fp32, causal)", dv, dv_r, TOL_FP32)

    # Rung 7: bf16 backward with the 0.01 downscale fixture (main.mm:951-954).
    doh = (do * 0.1).bfloat16()
    oh, lse_h = flash_attention_fwd(qh, kh, vh, causal=True, save_lse=True)
    dqh, dkh, dvh = flash_attention_bwd(qh, kh, vh, oh, doh, lse_h, causal=True)
    dq_rh, dk_rh, dv_rh = attention_reference_bwd(qh, kh, vh, doh, causal=True)
    rung("backward dQ vs oracle (bf16, causal)", dqh, dq_rh, TOL_BWD)
    rung("backward dK vs oracle (bf16, causal)", dkh, dk_rh, TOL_BWD)
    rung("backward dV vs oracle (bf16, causal)", dvh, dv_rh, TOL_BWD)

    # Rung 7b: the fused triangular backward against the same gradient.
    dkv_r = torch.stack([dk_rh.float(), dv_rh.float()])
    dqt, dkt, dvt = flash_attention_bwd_tri(qh, kh, vh, oh, doh, lse_h)
    rung("tri fused backward dQ vs oracle (bf16)", dqt, dq_rh, TOL_BWD)
    rung("tri fused backward dK,dV vs oracle (bf16)", torch.stack([dkt, dvt]), dkv_r, TOL_BWD)

    # Rung 7c: the JAX rung of the transposed-output modes, called in the
    # same form (the port ignores the Mosaic tile and layout arguments).
    opv, _ = flash_attention_tri(
        qh, kh, vh, save_lse=True, pv_transposed=True, block_q=512, block_k=512
    )
    rung("tri pvt forward vs causal oracle (bf16)", opv, oracle_c, TOL_HALF)
    dqp, dkp, dvp = flash_attention_bwd_tri(
        qh, kh, vh, oh, doh, lse_h, pv_transposed=True, block_q=512, block_k=512
    )
    rung("tri pvt backward dQ vs oracle (bf16)", dqp, dq_rh, TOL_BWD)
    rung("tri pvt backward dK,dV vs oracle (bf16)", torch.stack([dkp, dvp]), dkv_r, TOL_BWD)

    # Rungs 8 and up: not ported yet.
    for name, why in SKIPPED_UPPER_RUNGS:
        log(_skip(name, why))
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=1024)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("== flash_attention_metal_tpu_torch verification ladder ==")
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else args.device
    print(f"device: {where}")
    results = run_ladder(args.n, device=args.device)
    ok = all(r.passed for r in results)
    print(f"== {'ALL PASS' if ok else 'FAILURES PRESENT'} "
          f"({sum(r.passed for r in results)}/{len(results)}) ==")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
