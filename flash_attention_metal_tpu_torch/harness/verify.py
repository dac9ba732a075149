"""Verification ladder of the port.

Counterpart of ``flash_attention_metal_tpu/harness/verify.py``: each rung is
a max-abs difference at the reference's tolerance, and the rungs chain as
there: fp32 kernels anchor to the golden oracle, upper rungs difference
against the verified naive rung, causal and backward rungs get their own
fixtures.  One ``[PASS]``/``[FAIL]`` line per rung, in the same format.

The rungs whose kernels are ported run (1-7c, 8 int8 and fp8, 9, 12
prefill and decode chunk, 18); the others print a ``[SKIP]`` line naming
the ``ROADMAP.md`` item they wait for and are never counted as passes.
``device="cpu"`` runs every kernel's plain version (the tests do); the
default runs the CUDA kernels.

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
    flash_attention_paged,
    flash_attention_quant,
    flash_attention_tri,
    flash_attention_v1,
    flash_attention_v2,
    naive_attention,
    quantize_kv,
)
from ..ops.attention import flash_attention
from ..reference import attention_reference, attention_reference_bwd, make_qkv

# The reference tolerance ladder (SURVEY.md, H4).
TOL_FP32 = 1e-3  # main.mm:239,253,292
TOL_V3 = 5e-3  # main.mm:375
TOL_HALF = 1e-2  # main.mm:452,591
TOL_BWD = 1e-1  # main.mm:1191
TOL_QUANT_INT8 = 3e-2  # int8 KV rung: 7 effective mantissa bits
TOL_QUANT_FP8 = 5e-2  # fp8(e4m3) KV rung: 3 mantissa bits -> ~2x int8 error
# Page size of the paged rung (the JAX rung's): the port's paged kernel
# needs pages of whole 64-row tiles, which 128-row pages are.
PAGED_RUNG_PAGE = 128

# The V1, 8-bit KV, MQA, paged-KV and GQA-backward rungs (2, 8, 9, 12 and
# 18), by their JAX names.
RUNGS_2_8_9_12_18 = (
    "flash_v1 vs naive (fp32)",
    "flash_quant int8-KV causal vs causal oracle",
    "flash_quant fp8-KV causal vs causal oracle",
    "flash MQA (native head-fold) vs oracle",
    "flash paged-KV prefill vs causal oracle",
    "flash paged-KV decode chunk vs causal oracle",
    "GQA-fold backward dQ vs oracle",
    "GQA-fold backward dK,dV (group-summed in-kernel) vs oracle",
)

# Rungs of the JAX ladder that wait for a feature or a kernel of the port,
# by the ROADMAP.md item that holds it.
_FEATURES = "not ported (ROADMAP.md Queue A item 5: op features)"
SKIPPED_SLIDING_WINDOW = ("flash sliding-window vs oracle", _FEATURES)
SKIPPED_BLOCK_SPARSE = (
    "flash block-sparse mask vs oracle",
    "not ported (ROADMAP.md Queue B item 3: block-sparse, the next slice)",
)
SKIPPED_TRANSFORM_RUNGS = (
    ("flash softcap causal vs oracle", _FEATURES),
    ("flash ALiBi causal vs oracle", _FEATURES),
    ("flash_quant int8-KV softcap+ALiBi vs oracle", _FEATURES),
    ("flash paged-KV softcap+ALiBi vs oracle", _FEATURES),
    ("softcap backward (dQ,dK,dV) vs oracle", _FEATURES),
    ("ALiBi backward (dQ,dK,dV) vs oracle", _FEATURES),
    ("ALiBi backward d_slopes vs oracle (relative)", _FEATURES),
)
SKIPPED_DROPOUT_RUNGS = (
    ("flash dropout (p=0.2) causal vs oracle", _FEATURES),
    ("flash dropout backward (dQ,dK,dV) vs oracle", _FEATURES),
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

    # Rung 2: V1 vs naive, differential (main.mm:245-256).
    rung("flash_v1 vs naive (fp32)", flash_attention_v1(q, k, v), nv, TOL_FP32)

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

    # Rung 8: the 8-bit KV forward against the causal oracle.
    for qdtype, qname, qtol in (
        (torch.int8, "int8", TOL_QUANT_INT8),
        (torch.float8_e4m3fn, "fp8", TOL_QUANT_FP8),
    ):
        oq = flash_attention_quant(qh, quantize_kv(kh, vh, dtype=qdtype), causal=True)
        rung(f"flash_quant {qname}-KV causal vs causal oracle", oq, oracle_c, qtol)

    # Rung 9: MQA (one KV head under every q-head) through the op.
    kg, vg = kh[:, :1], vh[:, :1]
    og = flash_attention(qh, kg, vg, causal=True)
    oracle_g = attention_reference(
        q, kg.float().expand(k.shape), vg.float().expand(v.shape), causal=True)
    rung("flash MQA (native head-fold) vs oracle", og, oracle_g, TOL_HALF)

    # Rungs 10 and 11: sliding window and block-sparse masks, not ported.
    log(_skip(*SKIPPED_SLIDING_WINDOW))
    log(_skip(*SKIPPED_BLOCK_SPARSE))

    # Rung 12: paged KV through a shuffled page table (page 0 unused):
    # masking is in logical positions, so the output must match the causal
    # oracle wherever the pages lie.  A full prefill and a decode chunk
    # (the last 128 rows at offset n - 128).
    ps = PAGED_RUNG_PAGE
    pages_per = n // ps
    gen.manual_seed(11)
    perm = (torch.randperm(batch * pages_per, generator=gen, device=device) + 1).reshape(
        batch, pages_per)
    pools = []
    for x in (kh, vh):
        pool = torch.zeros((1 + batch * pages_per, heads, ps, head_dim), dtype=x.dtype,
                           device=device)
        pool[perm.reshape(-1)] = x.reshape(batch, heads, pages_per, ps, head_dim).transpose(
            1, 2).reshape(-1, heads, ps, head_dim)
        pools.append(pool)
    table = perm.to(torch.int32)
    op_full = flash_attention_paged(
        qh, *pools, table, torch.zeros((batch,), dtype=torch.int32, device=device))
    rung("flash paged-KV prefill vs causal oracle", op_full, oracle_c, TOL_HALF)
    op_dec = flash_attention_paged(
        qh[:, :, n - ps:].contiguous(), *pools, table,
        torch.full((batch,), n - ps, dtype=torch.int32, device=device))
    rung("flash paged-KV decode chunk vs causal oracle", op_dec, oracle_c[:, :, n - ps:],
         TOL_HALF)

    # Rungs 13-17: softcap and ALiBi, forward and backward, not ported.
    for name, why in SKIPPED_TRANSFORM_RUNGS:
        log(_skip(name, why))

    # Rung 18: the GQA backward (one KV head) through the op's autograd,
    # against the broadcast oracle's gradient.  The JAX rung runs the
    # row-fold backward (q-heads folded into rows, pos_div); the port's
    # backward kernels take GQA natively and sum the group's dK/dV in fp32,
    # so the same rung exercises another mechanism.
    kg2, vg2 = k[:, :1], v[:, :1]
    leaves = [t.clone().requires_grad_(True) for t in (q, kg2, vg2)]
    g_gq = torch.autograd.grad((flash_attention(*leaves, causal=True) * do).sum(), leaves)
    leaves = [t.clone().requires_grad_(True) for t in (q, kg2, vg2)]
    o_ref = attention_reference(leaves[0], leaves[1].expand(q.shape), leaves[2].expand(q.shape),
                                causal=True)
    g_gq_r = torch.autograd.grad((o_ref * do).sum(), leaves)
    rung("GQA-fold backward dQ vs oracle", g_gq[0], g_gq_r[0], TOL_FP32)
    rung("GQA-fold backward dK,dV (group-summed in-kernel) vs oracle",
         torch.stack(g_gq[1:]), torch.stack(g_gq_r[1:]), TOL_FP32)

    # Rungs 24-25: in-kernel dropout, not ported.
    for name, why in SKIPPED_DROPOUT_RUNGS:
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
