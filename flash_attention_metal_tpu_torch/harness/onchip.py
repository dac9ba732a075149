"""Kernel checks, the kernel sweep and the decode profile.

Shared by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``, and runnable on
its own on a CUDA card:

    python -m flash_attention_metal_tpu_torch.harness.onchip sweep
    python -m flash_attention_metal_tpu_torch.harness.onchip profile [serving|train] [--mode M]

``sweep`` times the forward kernel against slot length (decode) and chunk
offset (prefill).  ``profile`` (``serving``, the default) traces steady
decode steps and a prefill of the served FlashLM with ``torch.profiler``
and splits their wall time into device-busy time, by kernel, and idle time
(``--mode``: the KV cache, a ``serving.SERVING_MODES`` name, dense by default);
``profile train`` does the same for ``Trainer.step`` at the
``train_bench.json`` width.  Every line it prints carries the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..config import default_scale
from ..kernels.flash_bwd import (
    bwd_delta,
    dq_workspace_shape,
    flash_attention_bwd,
    flash_attention_bwd_fused,
    flash_attention_bwd_fused_plain,
    flash_attention_bwd_plain,
    flash_bwd_fused,
)
from ..kernels.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_fwd_lean,
    flash_fwd_lean_plain,
)
from ..kernels.flash_tri import (
    flash_attention_bwd_tri,
    flash_attention_bwd_tri_plain,
    flash_attention_tri,
    flash_attention_tri_plain,
)
from ..kernels.flash_v1 import flash_attention_v1, flash_attention_v1_plain, v1_route
from ..kernels.naive import naive_attention, naive_attention_plain
from ..kernels.paged import (
    flash_attention_paged,
    flash_attention_paged_plain,
    flash_attention_paged_quant,
)
from ..kernels.quant import flash_attention_quant, flash_attention_quant_plain, quantize_kv
from ..runtime import decode as decode_mod
from ..runtime.kv_cache import as_bytes
from ..utils.roofline import kv_cache_bytes, visible_pairs
from ..utils.timing import device_ms, wall_ms
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


def high_occupancy_bwd_inputs(gen: torch.Generator) -> tuple:
    """``bwd_inputs`` at the benchmark's high-occupancy shape (bf16, equal
    heads, causal), which the autotuner also races."""
    q, k, v = ladder_inputs(HIGH_OCC, HIGH_OCC, torch.bfloat16, gen)
    do = ladder_inputs(HIGH_OCC, HIGH_OCC, torch.bfloat16, gen)[0]
    return bwd_inputs((q, k, v, do, torch.zeros((HIGH_OCC[0],), dtype=torch.int32, device="cuda")))


def bwd_kernel_errors(inputs: tuple, fused: bool = False) -> Dict[str, Tuple[float, float]]:
    """``{"dq", "dk", "dv"}: (max-abs error, normalised error)`` of the
    backward kernels (the split pair, or with ``fused`` the fused kernel)
    against their fp32 plain version on the same inputs; the normalised
    error (``BWD_TOL``'s measure) divides by the plain gradient's max-abs.
    The fused kernel gets the largest offset as its bound, as the op gives
    it its int offset, so its dQ workspace is packed as on the main path."""
    q, k, v, o, do, lse, off = inputs
    scale = default_scale(q.shape[-1])
    kernel, plain = ((flash_attention_bwd_fused, flash_attention_bwd_fused_plain) if fused
                     else (flash_attention_bwd, flash_attention_bwd_plain))
    bound = {"q_offset_max": int(off.max())} if fused else {}
    got = kernel(q, k, v, o, do, lse, off, sm_scale=scale, causal=True, **bound)
    want = plain(
        q.float(), k.float(), v.float(), o.float(), do.float(), lse, off,
        sm_scale=scale, causal=True,
    )
    torch.cuda.synchronize()
    errors = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w).abs().max().item()
        errors[name] = (err, err / w.abs().max().item())
    return errors


def fused_workspace_bytes(inputs: tuple, off_bound: int) -> Tuple[int, int]:
    """``(allocated, written)`` bytes of the fused kernel's dQ workspace in
    one call on ``bwd_inputs`` at ``off_bound`` (causal): the allocator's
    peak over a call less its three outputs, and the slots of a NaN-filled
    workspace that a second call overwrote."""
    q, k, v, o, do, lse, off = inputs
    delta = bwd_delta(o, do, None)
    kw = dict(sm_scale=default_scale(q.shape[-1]), causal=True, off_bound=off_bound)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    outputs = flash_bwd_fused(q, k, v, do, lse, delta, off, **kw)
    torch.cuda.synchronize()
    out_bytes = sum(t.numel() * t.element_size() for t in outputs)
    allocated = torch.cuda.max_memory_allocated() - base - out_bytes
    del outputs
    ws = torch.full(dq_workspace_shape(q.shape[0], q.shape[1], q.shape[2], k.shape[2], off_bound),
                    float("nan"), device=q.device)
    flash_bwd_fused(q, k, v, do, lse, delta, off, workspace=ws, **kw)
    written = int((~torch.isnan(ws).all(dim=-1).all(dim=-1)).sum())
    return allocated, written * ws[0].numel() * ws.element_size()


def _fwd_errors(got, want) -> Tuple[float, float]:
    """Max-abs errors of ``o`` and of the lse (0 without one) against the
    plain version's.  The lse error is inf when the two disagree on which
    rows see no column (``lse = -inf``).  A NaN anywhere reads as NaN, which
    fails every ``<=`` check."""
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        return (got.float() - want).abs().max().item(), 0.0
    (o, lse), (o_ref, lse_ref) = got, want
    err = (o.float() - o_ref).abs().max().item()
    finite = torch.isfinite(lse_ref)
    if not torch.equal(finite, torch.isfinite(lse)):
        return err, float("inf")
    return err, (lse[finite] - lse_ref[finite]).abs().max().item()


def kernel_error(case: tuple) -> Tuple[float, float]:
    """Max-abs errors of the general kernel's ``o`` and ``lse`` against the
    fp32 plain version on one ``path_cases`` entry (see ``_fwd_errors``)."""
    q, k, v, off, pos_div = case
    kw = dict(causal=True, pos_div=pos_div, save_lse=True)
    got = flash_attention_fwd(q, k, v, off, **kw)
    want = flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), off, sm_scale=default_scale(q.shape[-1]), **kw
    )
    return _fwd_errors(got, want)


# ---------------------------------------------------------------------------
# The kernel ladder's kernels (naive, lean, triangular) at the benchmark's
# and the verification ladder's shapes.
# ---------------------------------------------------------------------------

# Shapes the benchmark gives the kernels: a sweep point (B * N^2 = 2^23),
# the sweep's shortest point, the high-occupancy phase, the ladder's rungs.
SWEEP_1024 = (8, 1, 1024, 64)
SWEEP_128 = (512, 1, 128, 64)
HIGH_OCC = (16, 8, 2048, 64)
LADDER = (1, 2, 1024, 64)
# The spike fixture: every query row has a large first component and key
# column SPIKE_COL a larger one, so each row that sees that column scores
# it ~100 (natural log units) above the rest: ~144 in the kernels' log2
# units, past the range of exp2 in fp32.  A kernel that takes a row's max
# over only part of the row, or forgets to rescale when the max jumps in a
# later KV tile, overflows or keeps stale sums there; on the ladder's flat
# fixture both are invisible (softmax is shift-invariant in exact
# arithmetic).
SPIKE_COL = 700


def spike_inputs(shape_q, shape_kv, dtype, gen, col: int = SPIKE_COL):
    """The ladder fixture with q[..., 0] = 8 and k[..., col, 0] = 100
    (both exact in bf16)."""
    q, k, v = ladder_inputs(shape_q, shape_kv, torch.float32, gen)
    q[..., 0] = 8.0
    k[..., col, 0] = 100.0
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _scale(q: torch.Tensor) -> float:
    return default_scale(q.shape[-1])


def _static(q_offset, q, k) -> int:
    return k.shape[2] - q.shape[2] if q_offset is None else q_offset


# Each forward kernel of the ladder: its wrapper, and its plain version
# called with the wrapper's keywords.
LADDER_FWD_KERNELS = {
    "naive": (
        naive_attention,
        lambda q, k, v, causal=False: naive_attention_plain(
            q, k, v, sm_scale=_scale(q), causal=causal),
    ),
    "flash_lean": (
        flash_fwd_lean,
        lambda q, k, v, q_offset=None, causal=False, save_lse=False: flash_fwd_lean_plain(
            q, k, v, _static(q_offset, q, k), sm_scale=_scale(q), causal=causal,
            save_lse=save_lse),
    ),
    "flash_tri": (
        flash_attention_tri,
        lambda q, k, v, q_offset=None, save_lse=False: flash_attention_tri_plain(
            q, k, v, _static(q_offset, q, k), sm_scale=_scale(q), save_lse=save_lse),
    ),
}


def ladder_fwd_cases(gen: torch.Generator) -> Dict[str, Tuple[str, tuple, dict]]:
    """``{name: (kernel, (q, k, v), keywords)}`` for the naive, lean and
    triangular forward kernels at the benchmark's and the ladder's shapes,
    on the ladder fixture, the peaked one (q x 8) and the spike one.  Every
    bf16 shape the bench gives a kernel also runs peaked: on the flat
    fixture the outputs are ~0.02 at N = 1024, so 1e-2 alone has little
    teeth there."""
    bf16, f32 = torch.bfloat16, torch.float32
    u = lambda shape, dtype, scale=1.0: ladder_inputs(shape, shape, dtype, gen, scale)  # noqa: E731
    return {
        "naive_fp32_n1024": ("naive", u(SWEEP_1024, f32), {}),
        "naive_fp32_n1024_causal": ("naive", u(SWEEP_1024, f32), dict(causal=True)),
        "naive_fp32_n128": ("naive", u(SWEEP_128, f32), {}),
        "lean_bf16_n1024": ("flash_lean", u(SWEEP_1024, bf16), dict(save_lse=True)),
        "lean_bf16_n128": ("flash_lean", u(SWEEP_128, bf16), dict(save_lse=True)),
        "lean_bf16_n128_peaked": (
            "flash_lean", u(SWEEP_128, bf16, PEAKED_Q_SCALE), dict(save_lse=True)),
        "lean_fp32_n1024": ("flash_lean", u(LADDER, f32), dict(save_lse=True)),
        "lean_bf16_causal_off100": (
            "flash_lean", ladder_inputs((2, 4, 900, 64), (2, 2, 1000, 64), bf16, gen),
            dict(causal=True, q_offset=100, save_lse=True)),
        "lean_bf16_n1024_peaked": (
            "flash_lean", u(SWEEP_1024, bf16, PEAKED_Q_SCALE), dict(save_lse=True)),
        "lean_bf16_n1024_spike": (
            "flash_lean", spike_inputs(SWEEP_1024, SWEEP_1024, bf16, gen), dict(save_lse=True)),
        "tri_bf16_b16h8n2048": ("flash_tri", u(HIGH_OCC, bf16), dict(save_lse=True)),
        "tri_bf16_b16h8n2048_peaked": (
            "flash_tri", u(HIGH_OCC, bf16, PEAKED_Q_SCALE), dict(save_lse=True)),
        "tri_fp32_n1024": ("flash_tri", u(LADDER, f32), dict(save_lse=True)),
        "tri_bf16_gqa_off300": (
            "flash_tri", ladder_inputs((2, 8, 1000, 64), (2, 4, 1300, 64), bf16, gen),
            dict(q_offset=300, save_lse=True)),
        "tri_bf16_n2048_peaked": (
            "flash_tri", u((2, 8, 2048, 64), bf16, PEAKED_Q_SCALE), dict(save_lse=True)),
        "tri_bf16_n2048_spike": (
            "flash_tri", spike_inputs((2, 8, 2048, 64), (2, 8, 2048, 64), bf16, gen),
            dict(save_lse=True)),
    }


def ladder_fwd_error(kernel: str, qkv: tuple, kw: dict) -> Tuple[float, float]:
    """Errors of one ladder forward kernel against its plain version on the
    same inputs in fp32 (see ``_fwd_errors``)."""
    wrapper, plain = LADDER_FWD_KERNELS[kernel]
    q, k, v = qkv
    return _fwd_errors(wrapper(q, k, v, **kw), plain(q.float(), k.float(), v.float(), **kw))


def tri_bwd_cases(gen: torch.Generator) -> Dict[str, tuple]:
    """``{name: (q, k, v, o, do, lse, q_offset)}`` for the triangular
    backward: the high-occupancy shape, a peaked and a ragged one with an
    offset (bf16), and the ladder's fp32 shape.  ``o`` and ``lse`` come from
    the triangular forward kernel."""
    cases = {}
    for name, shape_q, shape_kv, dtype, q_scale, off in (
        ("tri_bwd_bf16_b16h8n2048", HIGH_OCC, HIGH_OCC, torch.bfloat16, 1.0, 0),
        ("tri_bwd_bf16_n2048_peaked", (2, 8, 2048, 64), (2, 8, 2048, 64), torch.bfloat16,
         PEAKED_Q_SCALE, 0),
        ("tri_bwd_bf16_off300", (2, 4, 1000, 64), (2, 4, 1300, 64), torch.bfloat16, 1.0, 300),
        ("tri_bwd_fp32_n1024", LADDER, LADDER, torch.float32, 1.0, 0),
    ):
        q, k, v = ladder_inputs(shape_q, shape_kv, dtype, gen, q_scale)
        do = ladder_inputs(shape_q, shape_kv, dtype, gen)[0]
        o, lse = flash_attention_tri(q, k, v, q_offset=off, save_lse=True)
        cases[name] = (q, k, v, o, do, lse, off)
    return cases


def tri_bwd_errors(inputs: tuple) -> Dict[str, Tuple[float, float]]:
    """``{"dq", "dk", "dv"}: (max-abs error, normalised error)`` of the
    triangular backward against its fp32 plain version (``BWD_TOL``'s
    measure, as ``bwd_kernel_errors``)."""
    q, k, v, o, do, lse, off = inputs
    got = flash_attention_bwd_tri(q, k, v, o, do, lse, q_offset=off)
    want = flash_attention_bwd_tri_plain(
        q.float(), k.float(), v.float(), o.float(), do.float(), lse, off, sm_scale=_scale(q)
    )
    torch.cuda.synchronize()
    errors = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w).abs().max().item()
        errors[name] = (err, err / w.abs().max().item())
    return errors


# ---------------------------------------------------------------------------
# FlashAttention V1 (csrc/flash_v1.cu): the streaming and the folded kernel
# at the reference sweep's and the verification ladder's shapes.
# ---------------------------------------------------------------------------

# The folded kernel's rows hold at most 512 columns, so its spike column
# lies inside them, past the first 64-column chunk: a row max taken over
# one chunk misses it.
SPIKE_COL_SHORT = 100


def v1_kernel(shape) -> str:
    """The V1 kernel ``flash_attention_v1`` takes for ``[B, H, N, D]``
    self-attention: ``"flash_v1_folded"`` or ``"flash_v1"`` (streaming)."""
    return "flash_v1_folded" if v1_route(shape[0], shape[2], shape[2])[0] == "folded" else "flash_v1"


def v1_cases(gen: torch.Generator) -> Dict[str, Tuple[str, tuple, bool]]:
    """``{name: (kernel, (q, k, v), causal)}`` in fp32, as the sweep's
    FlashV1 column and ladder rung 2 run it: the sweep's N = 128 point (the
    folded kernel, 8 batch elements per block) and N = 1024 point (the
    streaming one) on the ladder, peaked (q x 8) and spike fixtures and
    causal, and the ladder's shape (streaming) non-causal and causal."""
    f32 = torch.float32
    cases = {}
    for tag, shape, col in (("n128", SWEEP_128, SPIKE_COL_SHORT), ("n1024", SWEEP_1024, SPIKE_COL)):
        kernel = v1_kernel(shape)
        cases[f"v1_fp32_{tag}"] = (kernel, ladder_inputs(shape, shape, f32, gen), False)
        cases[f"v1_fp32_{tag}_peaked"] = (
            kernel, ladder_inputs(shape, shape, f32, gen, PEAKED_Q_SCALE), False)
        cases[f"v1_fp32_{tag}_spike"] = (kernel, spike_inputs(shape, shape, f32, gen, col), False)
        cases[f"v1_fp32_{tag}_causal"] = (kernel, ladder_inputs(shape, shape, f32, gen), True)
    for causal in (False, True):
        cases[f"v1_fp32_ladder{'_causal' if causal else ''}"] = (
            v1_kernel(LADDER), ladder_inputs(LADDER, LADDER, f32, gen), causal)
    return cases


def v1_error(qkv: tuple, causal: bool) -> float:
    """Max-abs error of ``flash_attention_v1`` (the kernel its route takes)
    against the fp32 plain version on the same inputs (NaN if either is)."""
    q, k, v = qkv
    got = flash_attention_v1(q, k, v, causal=causal)
    want = flash_attention_v1_plain(q.float(), k.float(), v.float(), sm_scale=_scale(q),
                                    causal=causal)
    return _fwd_errors(got, want)[0]


# ---------------------------------------------------------------------------
# The 8-bit and paged caches' kernels (csrc/flash_fwd.cu) at the serving
# path's shapes.
# ---------------------------------------------------------------------------

# Page size of the serving engine's paged caches (DecodeEngine's default).
PAGE = 128
# The 8-bit formats the checks run (fp8 is e4m3 in DecodeEngine).
KV_8BIT = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}


def paged_layout(batch: int, n_kv: int, lengths: torch.Tensor, n_q: int, pos_div: int, gen):
    """``(perm, table, n_pages)`` for ``batch`` slots of ``n_kv`` tokens
    over a pool of ``n_pages = 1 + batch * n_kv / PAGE`` pages: ``perm
    [batch, n_kv / PAGE]`` places every logical page at a shuffled physical
    page (never page 0, as the allocator never grants it), and ``table`` is
    ``perm`` with the entries past each slot's last visible page set to 0,
    as unallocated entries are.  With an identity table, a kernel that read
    logical page j as physical page j would pass."""
    max_pages = n_kv // PAGE
    n_pages = 1 + batch * max_pages
    perm = (1 + torch.randperm(n_pages - 1, generator=gen, device="cuda")).reshape(batch, max_pages)
    live = ((n_q - 1) // pos_div + lengths.long()) // PAGE + 1
    table = torch.where(torch.arange(max_pages, device="cuda")[None, :] < live[:, None], perm, 0)
    return perm.to(torch.int32), table.to(torch.int32), n_pages


def to_pages(x: torch.Tensor, perm: torch.Tensor, n_pages: int) -> torch.Tensor:
    """Lay ``x [B, H_kv, N, ...]`` into a pool ``[n_pages, H_kv, PAGE, ...]``
    so that logical page ``j`` of slot ``b`` is physical page ``perm[b, j]``.
    Page 0, where the zeroed table entries past the diagonal point, holds
    NaN (the 0x7F byte: NaN in e4m3 and e5m2; int8 has none, but its scale
    page is NaN): a kernel that reads a page past a slot's diagonal turns
    its output NaN, which fails every check."""
    b, h, n = x.shape[:3]
    rest = x.shape[3:]
    pool = torch.empty((n_pages, h, PAGE, *rest), dtype=x.dtype, device=x.device)
    if x.element_size() == 1:
        pool.view(torch.uint8)[0] = 0x7F
    else:
        pool[0] = float("nan")
    pages = x.reshape(b, h, n // PAGE, PAGE, *rest).transpose(1, 2).reshape(-1, h, PAGE, *rest)
    as_bytes(pool)[perm.long().reshape(-1)] = as_bytes(pages)
    return pool


def kv_cases(gen: torch.Generator) -> Dict[str, Tuple[str, tuple, int]]:
    """``{name: (kernel, args, pos_div)}`` for ``KV_KERNELS`` at the serving
    path's shapes: folded decode (``DECODE_Q`` over ``DECODE_KV`` at
    ``decode_lengths()``) and a 512-row prefill chunk at offset 512; the
    ladder, peaked (q x 8) and spike fixtures; int8 and e4m3 for the 8-bit
    kernels, bf16 pools for the paged one, and fp32 q on the prefill shape.
    Every page table is shuffled, with page 0 (NaN) past each slot's
    diagonal (``paged_layout``, ``to_pages``)."""
    lengths = torch.from_numpy(decode_lengths()).to("cuda")
    shapes = {
        "decode": (DECODE_Q, DECODE_KV, lengths, 2),
        "prefill": (PREFILL_Q, PREFILL_KV, torch.tensor([512], dtype=torch.int32, device="cuda"), 1),
    }
    fixtures = {
        "": lambda sq, skv, dt: ladder_inputs(sq, skv, dt, gen),
        "_peaked": lambda sq, skv, dt: ladder_inputs(sq, skv, dt, gen, PEAKED_Q_SCALE),
        "_spike": lambda sq, skv, dt: spike_inputs(sq, skv, dt, gen),
    }
    runs = [(shape, fix, torch.bfloat16) for shape in shapes for fix in fixtures]
    runs.append(("prefill", "", torch.float32))
    cases = {}
    for shape, fix, dtype in runs:
        shape_q, shape_kv, off, pos_div = shapes[shape]
        q, k, v = fixtures[fix](shape_q, shape_kv, dtype)
        perm, table, n_pages = paged_layout(shape_kv[0], shape_kv[2], off, shape_q[2], pos_div, gen)
        tag = f"{shape}_{'fp32' if dtype == torch.float32 else 'bf16'}{fix}"
        formats = {"int8": KV_8BIT["int8"]} if dtype == torch.float32 else KV_8BIT
        for fmt, qdt in formats.items():
            qkv = quantize_kv(k, v, qdt)
            cases[f"quant_{fmt}_{tag}"] = ("flash_quant", (q, qkv, off), pos_div)
            pools = [to_pages(x, perm, n_pages)
                     for x in (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)]
            cases[f"paged_quant_{fmt}_{tag}"] = (
                "flash_paged_quant", (q, *pools, table, off), pos_div)
        pools = [to_pages(x, perm, n_pages) for x in (k, v)]
        cases[f"paged_{tag}"] = ("flash_paged", (q, *pools, table, off), pos_div)
    return cases


# Each kernel of csrc/flash_fwd.cu: its wrapper and its plain version, both
# called with a ``kv_cases`` entry's args and pos_div (the quant kernel
# with its lse).
KV_KERNELS = {
    "flash_quant": (
        lambda q, qkv, off, pos_div: flash_attention_quant(
            q, qkv, off, causal=True, pos_div=pos_div, save_lse=True),
        lambda q, qkv, off, pos_div: flash_attention_quant_plain(
            q.float(), qkv, off, sm_scale=_scale(q), causal=True, pos_div=pos_div,
            save_lse=True),
    ),
    "flash_paged": (
        lambda q, pk, pv, table, lengths, pos_div: flash_attention_paged(
            q, pk, pv, table, lengths, pos_div=pos_div),
        lambda q, pk, pv, table, lengths, pos_div: flash_attention_paged_plain(
            q.float(), pk.float(), pv.float(), table, lengths, sm_scale=_scale(q),
            pos_div=pos_div),
    ),
    "flash_paged_quant": (
        lambda q, pk, pv, pks, pvs, table, lengths, pos_div: flash_attention_paged_quant(
            q, pk, pv, pks, pvs, table, lengths, pos_div=pos_div),
        lambda q, pk, pv, pks, pvs, table, lengths, pos_div: flash_attention_paged_plain(
            q.float(), pk, pv, table, lengths, sm_scale=_scale(q), pos_div=pos_div,
            pool_k_scale=pks, pool_v_scale=pvs),
    ),
}


def kv_kernel_error(kernel: str, args: tuple, pos_div: int) -> Tuple[float, float]:
    """Errors of one ``csrc/flash_fwd.cu`` kernel against its plain version
    on the same 8-bit or paged data, in fp32 (see ``_fwd_errors``)."""
    wrapper, plain = KV_KERNELS[kernel]
    return _fwd_errors(wrapper(*args, pos_div), plain(*args, pos_div))


def fwd_work(q: torch.Tensor, k: torch.Tensor, offsets, pos_div: int = 1,
             save_lse: bool = False) -> Tuple[float, float]:
    """``(flops, bytes)`` one causal call of the dense forward kernel must
    do: 4 * D flops per visible (row, column) pair; each slot's K and V rows
    up to its last visible column read once, q read and o (and the lse)
    written once."""
    heads, n_q, head_dim = q.shape[1:]
    kv_heads, n_kv = k.shape[1], k.shape[2]
    offsets = [int(x) for x in offsets]
    pairs = heads * sum(visible_pairs(n_q, n_kv, off, pos_div) for off in offsets)
    rows = kv_heads * sum(min(n_kv, max(0, (n_q - 1) // pos_div + off + 1)) for off in offsets)
    nbytes = kv_cache_bytes(rows, head_dim, k.element_size()) + 2 * q.numel() * q.element_size()
    if save_lse:
        nbytes += 4 * q.numel() // head_dim
    return 4.0 * head_dim * pairs, nbytes


def kv_work(kernel: str, args: tuple, pos_div: int) -> Tuple[float, float]:
    """``(flops, bytes)`` one ``KV_KERNELS`` call must do on this data: 4 *
    D flops per visible (row, column) pair; each slot's K and V rows up to
    its last visible column read once (``kv_cache_bytes``: 1 byte per
    element and a 4-byte scale per row of an 8-bit cache), q read and o
    (and the quant kernel's lse) written once."""
    q, offsets = args[0], args[-1].tolist()
    heads, n_q, head_dim = q.shape[1:]
    if kernel == "flash_quant":
        kv_heads, n_kv, item = args[1].k_q.shape[1], args[1].seq_len, 1
    else:
        kv_heads, n_kv, item = args[1].shape[1], args[-2].shape[1] * PAGE, args[1].element_size()
    pairs = heads * sum(visible_pairs(n_q, n_kv, off, pos_div) for off in offsets)
    rows = kv_heads * sum(min(n_kv, (n_q - 1) // pos_div + off + 1) for off in offsets)
    nbytes = kv_cache_bytes(rows, head_dim, item, scaled=kernel != "flash_paged")
    nbytes += 2 * q.numel() * q.element_size()
    if kernel == "flash_quant":
        nbytes += 4 * q.numel() // head_dim
    return 4.0 * head_dim * pairs, nbytes


def sdpa_ms(q, k, v, *, causal: bool = False, mask=None, backward_of=None) -> Tuple[float, str]:
    """The library yardstick: ``F.scaled_dot_product_attention`` on the
    same inputs, its device ms and the backend it was pinned to.

    bf16 without a mask runs the flash backend, fp32 or an explicit mask
    (needed where the diagonal is not top-left aligned) the memory-efficient
    one.  GQA K/V are repeated to q's heads before the timed call.  With
    ``backward_of=do`` the time is SDPA's backward from
    ``torch.autograd.grad`` with that cotangent (dQ, dK and dV together).
    The port never calls SDPA; it is timed here only.
    """
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(group, dim=1) for x in (k, v))
    fast = q.dtype == torch.bfloat16 and mask is None
    backend = SDPBackend.FLASH_ATTENTION if fast else SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        if backward_of is None:
            ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal))
        else:
            q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=causal)
            ms = device_ms(lambda: torch.autograd.grad(o, (q, k, v), backward_of, retain_graph=True))
    return ms, backend.name


def steady_decode(eng, lengths: torch.Tensor) -> Callable[[], None]:
    """One ``decode_and_sample`` step with every slot busy at ``lengths``
    (a paged engine's slots are granted their pages first)."""
    active = torch.ones(len(eng.slots), dtype=torch.bool, device=eng.device)
    if eng._allocator is not None:
        for slot, n in enumerate(lengths.tolist()):
            eng.cache = eng._allocator.grow(eng.cache, slot, n + 1)

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
    slot 0, which is then freed again (a paged engine's slot keeps the
    pages it is granted here)."""
    tokens = torch.arange(1, n + 1, dtype=torch.int32, device=eng.device)
    if eng._allocator is not None:
        eng.cache = eng._allocator.grow(eng.cache, 0, n)

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
    parser.add_argument("--mode", choices=sorted(serving.SERVING_MODES), default="dense",
                        help="the KV cache the serving profile decodes from")
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
        **serving.FLASHLM_D2048, max_batch=8, max_len=2048, seed=SEED, device="cuda",
        **serving.SERVING_MODES[args.mode][0],
    )
    profile_serving(eng, f"{args.mode} cache; {stamp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
