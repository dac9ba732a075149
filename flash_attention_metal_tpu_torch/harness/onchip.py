"""Kernel checks, the kernel sweep and the decode profile.

Shared by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``, and runnable on
its own on a CUDA card:

    python -m flash_attention_metal_tpu_torch.harness.onchip sweep
    python -m flash_attention_metal_tpu_torch.harness.onchip profile [serving|train] [--mode M]
    python -m flash_attention_metal_tpu_torch.harness.onchip kernels [--csrc DIR]
    python -m flash_attention_metal_tpu_torch.harness.onchip v1_tiles
    python -m flash_attention_metal_tpu_torch.harness.onchip decode_splits
    python -m flash_attention_metal_tpu_torch.harness.onchip sparse_splits
    python -m flash_attention_metal_tpu_torch.harness.onchip ptxas [--csrc DIR]

``sweep`` times the forward kernel against slot length (decode) and chunk
offset (prefill).  ``profile`` (``serving``, the default) traces steady
decode steps and a prefill of the served FlashLM with ``torch.profiler``
and splits their wall time into device-busy time, by kernel, and idle time
(``--mode``: the KV cache, a ``serving.SERVING_MODES`` name, dense by default);
``profile train`` does the same for ``Trainer.step`` at the
``train_bench.json`` width.  ``kernels`` times the forward kernels (the
general and lean kernels, folded decode, fp32, the 8-bit and paged
caches' kernels), the backward kernels (the split pair in bf16 and fp32,
the fused kernel), naive, both V1 kernels, the triangular forward and
backward (with the backward's workspace bytes) and the three block-sparse
kernels, built from the package's
``csrc/`` or, with ``--csrc``, through another tree's wrappers and
sources: two versions compared on one card, in turns.  ``v1_tiles`` times
each V1 kernel at every Q-tile height it takes, at every point of the
benchmark's sweep (and at head dim 128 at N = 128 and 1024), beside the
height ``v1_tile_rows`` picks.  ``decode_splits`` times the decode kernels
(``csrc/flash_decode.cuh``) and the folded grid of verify windows
(``csrc/flash_fold_sm90.cu``) at every KV chunk of their split grids, beside
the chunk ``decode_kv_chunk`` picks.  ``sparse_splits`` times the bf16
block-sparse dK/dV kernel at every chunk cap of its plan, beside the cap
``dkv_chunk_cap`` picks.  Every line it prints carries the card's name and
power limit.  ``ptxas`` needs ``nvcc`` but no card: it compiles
``flash_fwd.cu`` and ``flash_mask.cu`` of ``csrc/`` (another tree's with
``--csrc``) with the build's flags and ``-Xptxas -v`` and prints each
kernel's registers, spills and stack, one JSON line a kernel.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SegmentIds, default_scale
from ..kernels._common import keep_factors, pack_dropout_seed
from ..kernels.flash_bwd import (
    bwd_delta,
    dq_workspace_shape,
    dslope_term_sizes,
    flash_attention_bwd,
    flash_attention_bwd_fused,
    flash_attention_bwd_fused_plain,
    flash_attention_bwd_plain,
    flash_bwd_fused,
)
from ..kernels.flash_fwd import (
    check_dropout,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_fwd_general,
    flash_fwd_lean,
    flash_fwd_lean_plain,
    plain_visible,
)
from ..kernels.flash_tri import (
    flash_attention_bwd_tri,
    flash_attention_bwd_tri_plain,
    flash_attention_tri,
    flash_attention_tri_plain,
    flash_tri_bwd,
)
from ..kernels.flash_v1 import (
    BLOCK_SMEM_MAX,
    flash_attention_v1,
    flash_attention_v1_plain,
    flash_v1_folded,
    flash_v1_stream,
    v1_route,
    v1_smem_bytes,
    v1_tile_rows,
)
from ..kernels.naive import naive_attention, naive_attention_plain
from ..kernels.paged import (
    flash_attention_paged,
    flash_attention_paged_plain,
    flash_attention_paged_quant,
)
from ..kernels.quant import (
    KV_ROUTE_KERNELS,
    KV_ROUTE_WALKS,
    dequantize_kv,
    flash_attention_quant,
    flash_attention_quant_plain,
    quantize_kv,
)
from ..models import transformer
from ..runtime import decode as decode_mod
from ..runtime.kv_cache import as_bytes
from ..utils.roofline import kv_cache_bytes, visible_kv_rows, visible_pairs
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
# The same prefill chunk at head dim 128 (the forward kernels take 64 and 128).
PREFILL_D128_Q, PREFILL_D128_KV = (1, 16, 512, 128), (1, 8, 2048, 128)
DECODE_Q, DECODE_KV = (8, 8, 2, 64), (8, 8, 2048, 64)
# The training step's attention (train_bench.json: batch 4, seq 2048,
# 16 q-heads over 8 KV heads), and its fp32 case at N = 512.
TRAIN_Q, TRAIN_KV = (4, 16, 2048, 64), (4, 8, 2048, 64)
TRAIN_FP32_Q, TRAIN_FP32_KV = (4, 16, 512, 64), (4, 8, 512, 64)
# The same attention at head dim 128, and the decode case's.
TRAIN_D128_Q, TRAIN_D128_KV = (4, 16, 2048, 128), (4, 8, 2048, 128)
DECODE_D128_Q, DECODE_D128_KV = (8, 8, 2, 128), (8, 8, 2048, 128)
# Unfolded decode (pos_div 1) of a model without GQA: a token of 16 heads
# over as many KV heads.
DECODE_MHA_Q, DECODE_MHA_KV = (8, 16, 1, 64), (8, 16, 2048, 64)
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
    the ladder fixture, then one fp32 case, then bf16 on the peaked one,
    then the prefill chunk at head dim 128.
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
    cases["prefill_bf16_d128_off512"] = (
        *ladder_inputs(PREFILL_D128_Q, PREFILL_D128_KV, bf16, gen), torch.tensor([512]), 1)
    return {
        name: (q, k, v, off.to("cuda", torch.int32), pos_div)
        for name, (q, k, v, off, pos_div) in cases.items()
    }


def train_cases(gen: torch.Generator) -> Dict[str, tuple]:
    """``{name: (q, k, v, do, q_offset)}`` at the training step's shapes:
    causal self-attention (offset 0), bf16 on the ladder, peaked and spike
    fixtures, and fp32 at N = 512.  ``do`` is uniform(-1, 1) too."""
    cases = {}
    for name, shape_q, shape_kv, dtype, fixture in (
        ("train_bf16", TRAIN_Q, TRAIN_KV, torch.bfloat16, "ladder"),
        ("train_bf16_peaked", TRAIN_Q, TRAIN_KV, torch.bfloat16, "peaked"),
        ("train_bf16_spike", TRAIN_Q, TRAIN_KV, torch.bfloat16, "spike"),
        ("train_fp32_n512", TRAIN_FP32_Q, TRAIN_FP32_KV, torch.float32, "ladder"),
    ):
        if fixture == "spike":
            q, k, v = spike_inputs(shape_q, shape_kv, dtype, gen)
        else:
            scale = PEAKED_Q_SCALE if fixture == "peaked" else 1.0
            q, k, v = ladder_inputs(shape_q, shape_kv, dtype, gen, scale)
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


def workspace_bytes(launch: Callable, q: torch.Tensor) -> Tuple[int, int]:
    """``(allocated, written)`` bytes of a backward's dQ workspace
    (``dq_workspace_shape``): the bytes requested from the allocator at its
    peak over one ``launch()`` less the three outputs it returns, and the
    accumulator bytes of a NaN-filled workspace that ``launch(workspace=...)``
    overwrote (a Q step that sees one KV tile writes dQ directly and leaves
    its rows).  Requested, not allocated, bytes: the caching allocator hands
    out a cached block whole when it is less than 1 MiB larger than the
    request, so its block bytes depend on what earlier code freed (a
    32.25 MiB block once read 245,756 bytes over the workspace)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    outputs = launch()
    torch.cuda.synchronize()
    out_bytes = sum(t.numel() * t.element_size() for t in outputs)
    allocated = torch.cuda.memory_stats()["requested_bytes.all.peak"] - base - out_bytes
    del outputs
    ws = torch.full(dq_workspace_shape(*q.shape), float("nan"), device=q.device)
    launch(workspace=ws)
    written = int((~torch.isnan(ws[:q.numel()])).sum())
    return allocated, written * ws.element_size()


def fused_workspace_bytes(inputs: tuple, off_bound: int) -> Tuple[int, int]:
    """``workspace_bytes`` of the fused kernel on ``bwd_inputs`` at
    ``off_bound`` (causal)."""
    q, k, v, o, do, lse, off = inputs
    delta = bwd_delta(o, do, None)
    kw = dict(sm_scale=default_scale(q.shape[-1]), causal=True, off_bound=off_bound)
    return workspace_bytes(
        lambda **ws: flash_bwd_fused(q, k, v, do, lse, delta, off, **kw, **ws), q)


def tri_workspace_bytes(inputs: tuple) -> Tuple[int, int]:
    """``workspace_bytes`` of the triangular backward on a ``tri_bwd_cases``
    entry."""
    q, k, v, o, do, lse, off = inputs
    delta = bwd_delta(o, do, None)
    return workspace_bytes(
        lambda **ws: flash_tri_bwd(q, k, v, do, lse, delta, off, sm_scale=_scale(q), **ws), q)


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
# Head dim 128 at the sweep's points and a triangular shape.
SWEEP_1024_D128 = (8, 1, 1024, 128)
SWEEP_128_D128 = (512, 1, 128, 128)
TRI_D128 = (2, 8, 2048, 128)
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
        # head dim 128
        "lean_bf16_n1024_d128": ("flash_lean", u(SWEEP_1024_D128, bf16), dict(save_lse=True)),
        "tri_bf16_n2048_d128": ("flash_tri", u(TRI_D128, bf16), dict(save_lse=True)),
        # naive on the fixtures that catch a partial row max (spike) or a
        # wrong exp (peaked), rows that see nothing (causal, n_q > n_kv:
        # mean(V)), and head dim 128
        "naive_fp32_n1024_peaked": ("naive", u(SWEEP_1024, f32, PEAKED_Q_SCALE), {}),
        "naive_fp32_n1024_spike": (
            "naive", spike_inputs(SWEEP_1024, SWEEP_1024, f32, gen), dict(causal=True)),
        "naive_fp32_causal_q_longer": (
            "naive", ladder_inputs((2, 2, 1000, 64), (2, 2, 700, 64), f32, gen),
            dict(causal=True)),
        "naive_fp32_n1024_d128_spike": (
            "naive", spike_inputs(SWEEP_1024_D128, SWEEP_1024_D128, f32, gen), {}),
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
# The 8-bit formats the checks run (fp8 is e4m3 in DecodeEngine), and at
# the prefill chunk, whose wgmma path picks the format at run time, e5m2 too.
KV_8BIT = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}
KV_8BIT_PREFILL = {**KV_8BIT, "e5m2": torch.float8_e5m2}


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


def skewed_lengths() -> np.ndarray:
    """One slot at 2047 (the whole cache), seven at 64: the decode step
    whose time one long slot sets without a split."""
    return np.array([2047] + [64] * 7, dtype=np.int32)


# The decode grid's edges (csrc/flash_decode.cuh splits the KV walk of decode
# calls): skewed slots, every slot at length 0 (all splits but the first
# empty), a row of 1920 columns (not a whole number of the serving shape's
# 256-column chunks), and head dim 128 over 128-row pages.
DECODE_N1920_KV = (8, 8, 1920, 64)
KV_EDGE_FIXTURES = {"decode_skewed": ("", "_peaked"), "decode_empty": ("",),
                    "decode_n1920": ("",), "decode_d128": ("", "_peaked")}


def kv_cases(gen: torch.Generator) -> Dict[str, Tuple[str, tuple, int]]:
    """``{name: (kernel, args, pos_div)}`` for ``KV_KERNELS`` at the serving
    path's shapes: folded decode (``DECODE_Q`` over ``DECODE_KV`` at
    ``decode_lengths()``) and a 512-row prefill chunk at offset 512; the
    ladder, peaked (q x 8) and spike fixtures; int8 and e4m3 for the 8-bit
    kernels (e5m2 too at the bf16 prefill), bf16 pools for the paged one,
    and fp32 q on the prefill shape; then the split's edges in bf16
    (``KV_EDGE_FIXTURES``).
    Every page table is shuffled, with page 0 (NaN) past each slot's
    diagonal (``paged_layout``, ``to_pages``)."""
    lengths = torch.from_numpy(decode_lengths()).to("cuda")
    shapes = {
        "decode": (DECODE_Q, DECODE_KV, lengths, 2),
        "prefill": (PREFILL_Q, PREFILL_KV, torch.tensor([512], dtype=torch.int32, device="cuda"), 1),
        "decode_skewed": (DECODE_Q, DECODE_KV, torch.from_numpy(skewed_lengths()).to("cuda"), 2),
        "decode_empty": (DECODE_Q, DECODE_KV, torch.zeros_like(lengths), 2),
        "decode_n1920": (DECODE_Q, DECODE_N1920_KV, lengths.clamp(max=DECODE_N1920_KV[2] - 1), 2),
        "decode_d128": (DECODE_D128_Q, DECODE_D128_KV, lengths, 2),
    }
    fixtures = {
        "": lambda sq, skv, dt: ladder_inputs(sq, skv, dt, gen),
        "_peaked": lambda sq, skv, dt: ladder_inputs(sq, skv, dt, gen, PEAKED_Q_SCALE),
        "_spike": lambda sq, skv, dt: spike_inputs(sq, skv, dt, gen),
    }
    runs = [(shape, fix, torch.bfloat16) for shape in ("decode", "prefill") for fix in fixtures]
    runs.append(("prefill", "", torch.float32))
    runs += [(shape, fix, torch.bfloat16) for shape, fixes in KV_EDGE_FIXTURES.items()
             for fix in fixes]
    cases = {}
    for shape, fix, dtype in runs:
        shape_q, shape_kv, off, pos_div = shapes[shape]
        q, k, v = fixtures[fix](shape_q, shape_kv, dtype)
        perm, table, n_pages = paged_layout(shape_kv[0], shape_kv[2], off, shape_q[2], pos_div, gen)
        tag = f"{shape}_{'fp32' if dtype == torch.float32 else 'bf16'}{fix}"
        formats = ({"int8": KV_8BIT["int8"]} if dtype == torch.float32
                   else KV_8BIT_PREFILL if shape == "prefill" else KV_8BIT)
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


def kv_d128_cases(gen: torch.Generator) -> Dict[str, Tuple[str, tuple, int]]:
    """``kv_cases``' folded decode at head dim 128 (``DECODE_D128_Q`` over
    ``DECODE_D128_KV``), bf16 q on the ladder fixture: int8 for the quant
    and paged-quant kernels, a bf16 pool for the paged one."""
    lengths = torch.from_numpy(decode_lengths()).to("cuda")
    q, k, v = ladder_inputs(DECODE_D128_Q, DECODE_D128_KV, torch.bfloat16, gen)
    b, _, n_kv, _ = DECODE_D128_KV
    perm, table, n_pages = paged_layout(b, n_kv, lengths, DECODE_D128_Q[2], 2, gen)
    qkv = quantize_kv(k, v, KV_8BIT["int8"])
    quant_pools = [to_pages(x, perm, n_pages) for x in (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)]
    return {
        "quant_int8_decode_bf16_d128": ("flash_quant", (q, qkv, lengths), 2),
        "paged_decode_bf16_d128": (
            "flash_paged", (q, *(to_pages(x, perm, n_pages) for x in (k, v)), table, lengths), 2),
        "paged_quant_int8_decode_bf16_d128": (
            "flash_paged_quant", (q, *quant_pools, table, lengths), 2),
    }


def kv_prefill_d128_cases(gen: torch.Generator) -> Dict[str, Tuple[str, tuple, int]]:
    """``kv_cases``' 512-row prefill chunk at offset 512 at head dim 128
    (``PREFILL_D128_Q`` over ``PREFILL_D128_KV``), bf16 q on the ladder
    fixture: int8 for the quant and paged-quant kernels, a bf16 pool for
    the paged one."""
    off = torch.tensor([512], dtype=torch.int32, device="cuda")
    q, k, v = ladder_inputs(PREFILL_D128_Q, PREFILL_D128_KV, torch.bfloat16, gen)
    perm, table, n_pages = paged_layout(PREFILL_D128_KV[0], PREFILL_D128_KV[2], off,
                                        PREFILL_D128_Q[2], 1, gen)
    qkv = quantize_kv(k, v, KV_8BIT["int8"])
    quant_pools = [to_pages(x, perm, n_pages) for x in (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)]
    return {
        "quant_int8_prefill_bf16_d128": ("flash_quant", (q, qkv, off), 1),
        "paged_prefill_bf16_d128": (
            "flash_paged", (q, *(to_pages(x, perm, n_pages) for x in (k, v)), table, off), 1),
        "paged_quant_int8_prefill_bf16_d128": (
            "flash_paged_quant", (q, *quant_pools, table, off), 1),
    }


def kv_prefill_d128_matrix(gen: torch.Generator) -> Dict[str, Tuple[str, tuple, int]]:
    """``kv_prefill_d128_cases``' prefill chunk on every fixture (ladder,
    peaked, spike) and 8-bit format (int8, e4m3, e5m2), bf16 q: the wgmma
    prefill of the three kernels at head dim 128 (``kv_cases`` holds head
    dim 64).  Shuffled tables, page 0 NaN."""
    off = torch.tensor([512], dtype=torch.int32, device="cuda")
    b, _, n_kv, _ = PREFILL_D128_KV
    fixtures = {
        "": lambda: ladder_inputs(PREFILL_D128_Q, PREFILL_D128_KV, torch.bfloat16, gen),
        "_peaked": lambda: ladder_inputs(PREFILL_D128_Q, PREFILL_D128_KV, torch.bfloat16, gen,
                                         PEAKED_Q_SCALE),
        "_spike": lambda: spike_inputs(PREFILL_D128_Q, PREFILL_D128_KV, torch.bfloat16, gen),
    }
    cases = {}
    for fix, make in fixtures.items():
        q, k, v = make()
        perm, table, n_pages = paged_layout(b, n_kv, off, PREFILL_D128_Q[2], 1, gen)
        tag = f"prefill_bf16{fix}_d128"
        for fmt, qdt in KV_8BIT_PREFILL.items():
            qkv = quantize_kv(k, v, qdt)
            cases[f"quant_{fmt}_{tag}"] = ("flash_quant", (q, qkv, off), 1)
            pools = [to_pages(x, perm, n_pages)
                     for x in (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)]
            cases[f"paged_quant_{fmt}_{tag}"] = ("flash_paged_quant", (q, *pools, table, off), 1)
        cases[f"paged_{tag}"] = (
            "flash_paged", (q, *(to_pages(x, perm, n_pages) for x in (k, v)), table, off), 1)
    return cases


# Each kernel of csrc/flash_fwd.cu: its wrapper and its plain version, both
# called with a ``kv_cases`` entry's args and pos_div (the quant kernel
# with its lse), and optionally a window and its sinks.
KV_KERNELS = {
    "flash_quant": (
        lambda q, qkv, off, pos_div, **win: flash_attention_quant(
            q, qkv, off, causal=True, pos_div=pos_div, save_lse=True, **win),
        lambda q, qkv, off, pos_div, **win: flash_attention_quant_plain(
            q.float(), qkv, off, sm_scale=_scale(q), causal=True, pos_div=pos_div,
            save_lse=True, **win),
    ),
    "flash_paged": (
        lambda q, pk, pv, table, lengths, pos_div, **win: flash_attention_paged(
            q, pk, pv, table, lengths, pos_div=pos_div, **win),
        lambda q, pk, pv, table, lengths, pos_div, **win: flash_attention_paged_plain(
            q.float(), pk.float(), pv.float(), table, lengths, sm_scale=_scale(q),
            pos_div=pos_div, **win),
    ),
    "flash_paged_quant": (
        lambda q, pk, pv, pks, pvs, table, lengths, pos_div, **win: flash_attention_paged_quant(
            q, pk, pv, pks, pvs, table, lengths, pos_div=pos_div, **win),
        lambda q, pk, pv, pks, pvs, table, lengths, pos_div, **win: flash_attention_paged_plain(
            q.float(), pk, pv, table, lengths, sm_scale=_scale(q), pos_div=pos_div,
            pool_k_scale=pks, pool_v_scale=pvs, **win),
    ),
}


def kv_kernel_error(kernel: str, args: tuple, pos_div: int, **win) -> Tuple[float, float]:
    """Errors of one ``csrc/flash_fwd.cu`` kernel against its plain version
    on the same 8-bit or paged data, in fp32 (see ``_fwd_errors``);
    ``win``: a window and its sinks."""
    wrapper, plain = KV_KERNELS[kernel]
    return _fwd_errors(wrapper(*args, pos_div, **win), plain(*args, pos_div, **win))


# ---------------------------------------------------------------------------
# The sliding window with attention sinks, and segment ids: the forward
# (row 1: the wgmma kernel, the fp32 template and the decode grid), the
# split pair and the fused backward (rows 5-7), and the cache kernels
# (rows 11-13), against their plain versions.
# ---------------------------------------------------------------------------

# The windowed FlashLM's attention (ModelConfig.attn_window, attn_sinks).
WINDOW, SINKS = 512, 4
# Segment starts in position space, per batch (ragged: starts inside tiles,
# one across a 64-column edge, a batch of one segment).
SEGMENT_CUTS = ((300, 1000, 1700), (63, 1500), (), (7, 777, 2000))


def segment_ids(batch: int, n_q: int, n_kv: int, offsets, cuts=SEGMENT_CUTS) -> SegmentIds:
    """Segment ids on the card for rows at positions ``r + offsets[b]`` and
    columns ``c``: a new segment at each cut, so that a row shares its own
    position's id (every causal row sees its diagonal)."""
    def ids(b, n, start):
        pos = torch.arange(n, device="cuda") + start
        return sum((pos >= c).int() for c in cuts[b % len(cuts)]) + torch.zeros_like(pos).int()
    offsets = [int(x) for x in offsets]
    return SegmentIds(torch.stack([ids(b, n_q, offsets[b]) for b in range(batch)]).int(),
                      torch.stack([ids(b, n_kv, 0) for b in range(batch)]).int())


def _fixture(shape_q, shape_kv, dtype, gen, fixture):
    if fixture == "spike":
        return spike_inputs(shape_q, shape_kv, dtype, gen)
    if fixture == "negative":
        # Every score far below zero (~-150 log2 units): a split or state
        # whose max is taken as 0 instead of -inf underflows every weight.
        def u(shape, lo, hi):
            x = torch.rand(shape, generator=gen, device="cuda", dtype=torch.float32)
            return (lo + (hi - lo) * x).to(dtype)
        return u(shape_q, 12.0, 24.0), u(shape_kv, -1.0, -0.5), u(shape_kv, -1.0, 1.0)
    return ladder_inputs(shape_q, shape_kv, dtype, gen,
                         PEAKED_Q_SCALE if fixture == "peaked" else 1.0)


# (name, q shape, kv shape, dtype, fixture, offsets (None: decode lengths),
# pos_div, features).  Training shape: the window of the windowed FlashLM on
# the ladder, peaked and spike fixtures, a window ending mid-tile with a
# partial sink tile far left of it, a window of 16 (a column more or less
# moves every row), segment ids causal and not, and with
# the window; head dim 128; fp32 at N 512; the prefill chunk; folded
# decode, with a window of 64 whose row leaves every split but its last
# and the first (the sinks') wholly outside.
WINDOW_FWD_CASES = (
    ("train_w512_bf16", TRAIN_Q, TRAIN_KV, "bf16", "ladder", 0, 1, dict(window=WINDOW, sinks=SINKS)),
    ("train_w512_bf16_peaked", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1,
     dict(window=WINDOW, sinks=SINKS)),
    ("train_w512_bf16_spike", TRAIN_Q, TRAIN_KV, "bf16", "spike", 0, 1,
     dict(window=WINDOW, sinks=SINKS)),
    ("train_w500_s70_bf16", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1, dict(window=500, sinks=70)),
    ("train_w16_bf16_peaked", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1, dict(window=16)),
    ("train_seg_bf16", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1, dict(segments=True)),
    ("train_seg_full_bf16", TRAIN_Q, TRAIN_KV, "bf16", "ladder", 0, 1,
     dict(segments=True, causal=False)),
    ("train_seg_w512_bf16", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1,
     dict(segments=True, window=WINDOW, sinks=SINKS)),
    ("train_w512_bf16_d128", TRAIN_D128_Q, TRAIN_D128_KV, "bf16", "ladder", 0, 1,
     dict(window=WINDOW, sinks=SINKS)),
    ("train_w512_bf16_peaked_d128", TRAIN_D128_Q, TRAIN_D128_KV, "bf16", "peaked", 0, 1,
     dict(window=WINDOW, sinks=SINKS)),
    ("train_seg_w512_bf16_d128", TRAIN_D128_Q, TRAIN_D128_KV, "bf16", "peaked", 0, 1,
     dict(segments=True, window=WINDOW, sinks=SINKS)),
    ("fp32_n512_w100", TRAIN_FP32_Q, TRAIN_FP32_KV, "fp32", "peaked", 0, 1,
     dict(window=100, sinks=SINKS)),
    ("fp32_n512_seg_w100", TRAIN_FP32_Q, TRAIN_FP32_KV, "fp32", "ladder", 0, 1,
     dict(segments=True, window=100, sinks=70)),
    ("prefill_w512_bf16_off512", PREFILL_Q, PREFILL_KV, "bf16", "peaked", 512, 1,
     dict(window=WINDOW, sinks=SINKS)),
    ("decode_w512_bf16", DECODE_Q, DECODE_KV, "bf16", "ladder", None, 2,
     dict(window=WINDOW, sinks=SINKS)),
    ("decode_w64_bf16_peaked", DECODE_Q, DECODE_KV, "bf16", "peaked", None, 2,
     dict(window=64, sinks=SINKS)),
    ("decode_w64_bf16_negative", DECODE_Q, DECODE_KV, "bf16", "negative", None, 2,
     dict(window=64, sinks=SINKS)),
    ("decode_w512_bf16_d128", DECODE_D128_Q, DECODE_D128_KV, "bf16", "peaked", None, 2,
     dict(window=WINDOW, sinks=SINKS)),
    ("decode_w100_fp32", DECODE_Q, DECODE_KV, "fp32", "peaked", None, 2, dict(window=100, sinks=70)),
)
_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def window_fwd_cases(gen: torch.Generator, names=None, table=WINDOW_FWD_CASES) -> Dict[str, tuple]:
    """``{name: (q, k, v, q_offset, pos_div, features)}`` of
    ``WINDOW_FWD_CASES`` (or ``table``: all, or ``names``); ``features``
    holds ``causal`` and the wrapper's window, sinks, segment ids, softcap,
    ALiBi slopes (``alibi``: an ``alibi_slopes`` kind) and dropout
    (``dropout``: the rate, with ``seed`` and ``drop_offsets`` packed into
    ``dropout_seed`` on the card).  An offset is an int for every batch, a
    tuple per batch or None (the decode lengths)."""
    cases = {}
    for name, sq, skv, dt, fixture, off, pos_div, feats in table:
        if names is not None and name not in names:
            continue
        q, k, v = _fixture(sq, skv, _DTYPES[dt], gen, fixture)
        offs = (torch.from_numpy(decode_lengths()) if off is None
                else torch.tensor(off, dtype=torch.int32) if isinstance(off, tuple)
                else torch.full((sq[0],), off, dtype=torch.int32))
        feats = dict(feats)
        feats.setdefault("causal", True)
        if feats.pop("segments", False):
            feats["segment_ids"] = segment_ids(sq[0], sq[2], skv[2], offs)
        if "alibi" in feats:
            feats["alibi_slopes"] = alibi_slopes(feats.pop("alibi"), sq[1])
        if "dropout" in feats:
            feats["dropout_rate"] = feats.pop("dropout")
            feats["dropout_seed"] = pack_dropout_seed(
                feats.pop("seed", DROP_SEED), feats.pop("drop_offsets", None)).to("cuda")
        cases[name] = (q, k, v, offs.to("cuda", torch.int32), pos_div, feats)
    return cases


def plain_features(feats: dict, device) -> dict:
    """A case's features as the plain versions take them: the entries'
    ``dropout_*`` keywords as one checked ``Dropout`` (``drop``), left out
    without dropout."""
    feats = dict(feats)
    drop = check_dropout(feats.pop("dropout_rate", 0.0), feats.pop("dropout_seed", None),
                         feats.pop("dropout_offsets", None), feats.pop("dropout_heads", None),
                         device)
    return feats if drop is None else {**feats, "drop": drop}


def window_fwd_error(case: tuple) -> Tuple[float, float]:
    """``kernel_error`` of the general forward under a case's features."""
    q, k, v, off, pos_div, feats = case
    got = flash_attention_fwd(q, k, v, off, pos_div=pos_div, save_lse=True, **feats)
    want = flash_attention_fwd_plain(q.float(), k.float(), v.float(), off,
                                     sm_scale=default_scale(q.shape[-1]), pos_div=pos_div,
                                     save_lse=True, **plain_features(feats, q.device))
    return _fwd_errors(got, want)


# (name, forward case, fused too): the backward checks.
WINDOW_BWD_CASES = (
    ("train_w512_bf16", True), ("train_w512_bf16_peaked", True), ("train_w512_bf16_spike", False),
    ("train_w500_s70_bf16", True), ("train_seg_bf16", True), ("train_seg_full_bf16", False),
    ("train_seg_w512_bf16", True), ("train_w512_bf16_d128", True),
    ("train_w512_bf16_peaked_d128", False), ("train_seg_w512_bf16_d128", True),
    ("fp32_n512_w100", True), ("fp32_n512_seg_w100", True),
)


def window_bwd_inputs(case: tuple, gen: torch.Generator) -> tuple:
    """``(q, k, v, o, do, lse, q_offset, features)``: a forward case with
    the forward kernel's ``o`` and ``lse`` and a uniform(-1, 1) ``do``."""
    q, k, v, off, _, feats = case
    do = ladder_inputs(q.shape, k.shape, q.dtype, gen)[0]
    o, lse = flash_attention_fwd(q, k, v, off, save_lse=True, **feats)
    return q, k, v, o, do, lse, off, feats


def window_bwd_errors(inputs: tuple, fused: bool = False) -> Dict[str, Tuple[float, float]]:
    """``bwd_kernel_errors`` under the inputs' features; under ALiBi also
    ``d_slopes``, read two ways: normalised as the other gradients are (by
    the plain version's max-abs entry), and as ``d_slopes_head``, each
    head's error over the size of its own terms (``dslope_term_sizes``:
    the sum of |dS * distance| over the head's pairs), held at
    ``DSLOPE_HEAD_TOL`` (``bwd_limit``).  A head's entry is a sum that
    cancels (dS sums to 0 over a row), so the first measure alone lets a
    head whose sum is small beside the largest one err by as much as that
    one may, and a per-entry measure (ladder rung 17's ``|d| + 1``) holds
    a small sum to the rounding of terms far larger than it: the fp32
    kernel read up to 2.4e-5 of ``|d| + 1`` on the peaked fixture, where
    its plain version is no closer to the exact sum (the CPU tests hold
    both against float64)."""
    q, k, v, o, do, lse, off, feats = inputs
    scale = default_scale(q.shape[-1])
    kernel, plain = ((flash_attention_bwd_fused, flash_attention_bwd_fused_plain) if fused
                     else (flash_attention_bwd, flash_attention_bwd_plain))
    bound = {"q_offset_max": int(off.max())} if fused else {}
    got = kernel(q, k, v, o, do, lse, off, sm_scale=scale, **bound, **feats)
    plain_in = (q.float(), k.float(), v.float(), o.float(), do.float(), lse, off)
    feats = plain_features(feats, q.device)
    want = plain(*plain_in, sm_scale=scale, **feats)
    torch.cuda.synchronize()
    errors = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w).abs().max().item()
        errors[name] = (err, err / max(w.abs().max().item(), 1e-30))
    if len(want) > 3:
        err = (got[3].float() - want[3]).abs()
        sizes = dslope_term_sizes(*plain_in, sm_scale=scale, **feats)
        worst = err.max().item()
        errors["d_slopes"] = (worst, worst / max(want[3].abs().max().item(), 1e-30))
        errors["d_slopes_head"] = (worst, (err / sizes.clamp_min(1e-30)).max().item())
    return errors


# d_slopes head by head (``window_bwd_errors``' ``d_slopes_head``): each
# head's error over the size of its terms.  The bf16 kernels too sum it in
# fp32 from dS that is never rounded to bf16, and the kernel and its plain
# version rebuild P from the same lse, so it reads near fp32 rounding: on
# the H100 every case of XF_BWD_CASES read at most 3.3e-7 (bf16) and
# 1.3e-8 (fp32), the far fp32 rows 5.6e-9 (PERF.md §6).  The bounds sit
# 30x and 77x above that, far below the bf16 gradients' 1e-2, which would
# let the steepest head's d_slopes (a small sum of large terms) err by 7x
# its own value.
DSLOPE_HEAD_TOL = {torch.bfloat16: 1e-5, torch.float32: 1e-6}


def bwd_limit(key: str, dtype: torch.dtype) -> float:
    """The bound of a ``window_bwd_errors`` entry's normalised error."""
    return (DSLOPE_HEAD_TOL if key == "d_slopes_head" else BWD_TOL)[dtype]


def dslope_heads(inputs: tuple) -> Tuple[List[float], List[float], List[float]]:
    """Per q-head, the kernel's ``d_slopes``, the plain version's and the
    size of its terms (``dslope_term_sizes``) on ``window_bwd_inputs``
    under ALiBi: what ``window_bwd_errors`` reads, head by head."""
    q, k, v, o, do, lse, off, feats = inputs
    scale = default_scale(q.shape[-1])
    got = flash_attention_bwd(q, k, v, o, do, lse, off, sm_scale=scale, **feats)[3]
    plain_in = (q.float(), k.float(), v.float(), o.float(), do.float(), lse, off)
    feats = plain_features(feats, q.device)
    want = flash_attention_bwd_plain(*plain_in, sm_scale=scale, **feats)[3]
    sizes = dslope_term_sizes(*plain_in, sm_scale=scale, **feats)
    return got.tolist(), want.tolist(), sizes.tolist()


def window_mask(n_q: int, n_kv: int, offsets: torch.Tensor, window: int, sinks: int,
                pos_div: int = 1) -> torch.Tensor:
    """SDPA's boolean mask of a windowed call, ``[B, 1, N_q, N_kv]`` on the
    card: row ``r`` of batch ``b`` at position ``r // pos_div +
    offsets[b]`` sees ``c <= p`` with ``c > p - window`` or ``c < sinks``."""
    pos = (torch.arange(n_q, device="cuda") // pos_div)[None, :, None] + offsets.to(
        "cuda", torch.int64)[:, None, None]
    col = torch.arange(n_kv, device="cuda")
    return ((col <= pos) & ((col > pos - window) | (col < sinks)))[:, None]


# The cache kernels' windowed checks: (kv_cases entry, window, sinks).  The
# decode cases at the windowed FlashLM's window, one of 64 whose rows leave
# the middle splits wholly outside, sinks far left of the window; the
# prefill chunk; fp32 q.
WINDOW_KV_CASES = tuple(
    (f"{kernel}_{tag}", window, sinks)
    for kernel in ("quant_int8", "paged", "paged_quant_int8")
    for tag, window, sinks in (("decode_bf16", WINDOW, SINKS), ("decode_bf16_peaked", 64, SINKS),
                               ("decode_bf16_spike", 300, 70), ("prefill_bf16", WINDOW, SINKS),
                               ("prefill_bf16_peaked", 100, 70), ("prefill_fp32", WINDOW, SINKS),
                               ("decode_skewed_bf16", 64, 0))
) + tuple((f"{kernel}_decode_bf16_d128", WINDOW, SINKS)
          for kernel in ("quant_int8", "paged", "paged_quant_int8"))


# ---------------------------------------------------------------------------
# The score transforms: the tanh softcap and ALiBi on the forward (row 1:
# the wgmma kernel, the fp32 template and the decode grid), the split pair
# (rows 5-6) and the cache kernels (rows 11-13), against their plain
# versions.
# ---------------------------------------------------------------------------

# The capped ALiBi FlashLM's softcap (ModelConfig.attn_softcap, the JAX
# tests' 30; Gemma-2 caps its attention logits at 50, its final logits at 30).
SOFTCAP = 30.0


def alibi_slopes(kind: str, heads: int) -> torch.Tensor:
    """fp32 ``[heads]`` slopes on the card: ``"std"`` the standard schedule
    ``2^(-8 i / H)`` (ModelConfig.attn_alibi's), ``"large"`` 0.25 to 1 (a
    column 64 back weighs ~e^-16 to e^-64: the bias decides the softmax),
    ``"small"`` the standard ones over 256 (the bias a perturbation)."""
    std = transformer.alibi_slopes(heads, "cuda")
    return {"std": std, "large": torch.linspace(0.25, 1.0, heads, device="cuda"),
            "small": std / 256}[kind]


# Unfolded decode (ALiBi takes no GQA row fold): a token of each of 16
# q-heads over the 8 KV heads' cache.
XF_DECODE_Q, XF_DECODE_D128_Q = (8, 16, 1, 64), (8, 16, 1, 128)
# Per-batch offsets of a training-shape case (a row's ALiBi distance and
# its diagonal move with them): the rows of the last batch sit up to 1500
# positions past the cache's end, so under a window of 100 they see only
# the sinks, ~1500-3500 columns away.  Such rows score in the hundreds to
# thousands of log2 units, where fp32 resolves 6e-5 to 2e-4: an fp32
# kernel and its plain version differ there by ~1e-4 relative in P and the
# lse (the stored lse, the slope's rounding times the distance), above the
# fp32 bound of 1e-5, so the fp32 case of XF_FWD_CASES takes offsets of 0
# or less, whose rows all see their own neighbourhood (or nothing); the
# far rows are held in bf16 here, and in fp32 at a limit scaled to their
# lse (XF_FAR_FP32).
XF_OFFSETS = (0, 100, 517, 1500)
XF_NEAR_OFFSETS = (0, -17, -64, -100)
_CAP, _BOTH = dict(softcap=SOFTCAP), dict(softcap=SOFTCAP, alibi="std")
# (name, q shape, kv shape, dtype, fixture, offsets, pos_div, features), as
# WINDOW_FWD_CASES.  Training shape: cap 30 and 20 (tanh held against the
# bound where the scores are peaked), cap 0.5 (every score saturated),
# ALiBi with the standard, large and small slopes, both (the capped ALiBi
# FlashLM's), both composed with the window and sinks, with segment ids,
# not causal, and with per-batch offsets; head dim 128; fp32 at N 512; the
# prefill chunk at offset 512; decode folded (softcap only) and unfolded.
XF_FWD_CASES = (
    ("train_cap30_bf16", TRAIN_Q, TRAIN_KV, "bf16", "ladder", 0, 1, _CAP),
    ("train_cap30_bf16_peaked", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1, _CAP),
    ("train_cap20_bf16_peaked", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1, dict(softcap=20.0)),
    ("train_cap05_bf16_peaked", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1, dict(softcap=0.5)),
    ("train_alibi_bf16", TRAIN_Q, TRAIN_KV, "bf16", "ladder", 0, 1, dict(alibi="std")),
    ("train_alibi_large_bf16_peaked", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1,
     dict(alibi="large")),
    ("train_alibi_small_bf16_spike", TRAIN_Q, TRAIN_KV, "bf16", "spike", 0, 1, dict(alibi="small")),
    ("train_both_bf16_peaked", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1, _BOTH),
    ("train_cap05_alibi_bf16_peaked", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1,
     dict(softcap=0.5, alibi="std")),
    ("train_both_bf16_spike", TRAIN_Q, TRAIN_KV, "bf16", "spike", 0, 1, _BOTH),
    ("train_both_w512_bf16", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1,
     dict(_BOTH, window=WINDOW, sinks=SINKS)),
    ("train_both_seg_bf16", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1, dict(_BOTH, segments=True)),
    ("train_both_full_bf16", TRAIN_Q, TRAIN_KV, "bf16", "ladder", XF_OFFSETS, 1,
     dict(_BOTH, causal=False)),
    ("train_both_offs_bf16", TRAIN_Q, TRAIN_KV, "bf16", "peaked", XF_OFFSETS, 1, _BOTH),
    ("train_both_bf16_d128", TRAIN_D128_Q, TRAIN_D128_KV, "bf16", "peaked", 0, 1, _BOTH),
    ("train_cap05_bf16_d128", TRAIN_D128_Q, TRAIN_D128_KV, "bf16", "ladder", 0, 1,
     dict(softcap=0.5)),
    ("fp32_n512_both", TRAIN_FP32_Q, TRAIN_FP32_KV, "fp32", "peaked", 0, 1, _BOTH),
    ("fp32_n512_cap05", TRAIN_FP32_Q, TRAIN_FP32_KV, "fp32", "ladder", 0, 1, dict(softcap=0.5)),
    ("fp32_n512_alibi_large_w100", TRAIN_FP32_Q, TRAIN_FP32_KV, "fp32", "peaked", XF_NEAR_OFFSETS,
     1, dict(alibi="large", window=100, sinks=SINKS)),
    ("train_alibi_large_w100_offs_bf16", TRAIN_Q, TRAIN_KV, "bf16", "peaked", XF_OFFSETS, 1,
     dict(alibi="large", window=100, sinks=SINKS)),
    ("prefill_both_bf16_off512", PREFILL_Q, PREFILL_KV, "bf16", "peaked", 512, 1, _BOTH),
    ("decode_cap30_bf16", DECODE_Q, DECODE_KV, "bf16", "peaked", None, 2, _CAP),
    ("decode_both_bf16", XF_DECODE_Q, DECODE_KV, "bf16", "peaked", None, 1, _BOTH),
    ("decode_alibi_large_bf16_spike", XF_DECODE_Q, DECODE_KV, "bf16", "spike", None, 1,
     dict(alibi="large")),
    ("decode_both_bf16_d128", XF_DECODE_D128_Q, DECODE_D128_KV, "bf16", "peaked", None, 1, _BOTH),
    ("decode_both_fp32", XF_DECODE_Q, DECODE_KV, "fp32", "peaked", None, 1, _BOTH),
)
# The backward checks (the split pair: the fused kernel takes no transform).
XF_BWD_CASES = tuple(name for name in (
    "train_cap30_bf16_peaked", "train_cap05_bf16_peaked", "train_alibi_bf16",
    "train_alibi_large_bf16_peaked", "train_both_bf16_peaked", "train_cap05_alibi_bf16_peaked",
    "train_both_bf16_spike",
    "train_both_w512_bf16", "train_both_seg_bf16", "train_both_full_bf16",
    "train_both_offs_bf16", "train_both_bf16_d128", "train_cap05_bf16_d128", "fp32_n512_both",
    "fp32_n512_cap05", "fp32_n512_alibi_large_w100", "train_alibi_large_w100_offs_bf16"))


def xf_fwd_cases(gen: torch.Generator, names=None) -> Dict[str, tuple]:
    """``window_fwd_cases`` of ``XF_FWD_CASES``."""
    return window_fwd_cases(gen, names, XF_FWD_CASES)


# The fp32 kernels on rows far past the cache, as
# train_alibi_large_w100_offs_bf16 in fp32 at N 512: the last batch's rows
# sit 1500-2011 positions past the start of a 512-row cache, so under the
# window of 100 they see only the sinks, 1500-2000 columns back, at slopes
# up to 1, and score (and their lse) down to about -2000.  fp32 resolves
# such a number to 2^-23 of itself (~1.8e-4 at 1500): the exponent's reference
# and the slope's rounding times the distance move P by that much
# relative, above the bound of 1e-5.  So this case is held at a limit
# scaled to the lse: o at the fp32 bound (P's relative error leaves o's
# weights summing to 1), each row's lse within FAR_ULPS units of 2^-23 of
# its own |lse| (or the bound, the larger), and the gradients, normalised
# as ``window_bwd_errors`` does, within FAR_ULPS * 2^-23 of the case's
# largest |lse| (or the bound).
XF_FAR_FP32 = ("fp32_n512_alibi_large_w100_far", TRAIN_FP32_Q, TRAIN_FP32_KV, "fp32", "peaked",
               XF_OFFSETS, 1, dict(alibi="large", window=100, sinks=SINKS))
FAR_ULPS = 2


def xf_far_errors(gen: torch.Generator) -> Dict[str, Tuple[float, float]]:
    """``{check: (error, limit)}`` of ``XF_FAR_FP32``: ``o`` (max-abs),
    ``lse`` (the largest row's error over its own limit: limit 1), and the
    split pair's ``dq``, ``dk``, ``dv``, ``d_slopes`` and ``d_slopes_head``
    (as ``window_bwd_errors``'s normalised errors)."""
    name = XF_FAR_FP32[0]
    case = window_fwd_cases(gen, (name,), (XF_FAR_FP32,))[name]
    q, k, v, off, pos_div, feats = case
    got = flash_attention_fwd(q, k, v, off, pos_div=pos_div, save_lse=True, **feats)
    want = flash_attention_fwd_plain(q.float(), k.float(), v.float(), off,
                                     sm_scale=default_scale(q.shape[-1]), pos_div=pos_div,
                                     save_lse=True, **feats)
    err, _ = _fwd_errors(got, want)
    tol = TOL[torch.float32]
    lse, lse_ref = got[1], want[1]
    finite = torch.isfinite(lse_ref)
    ulp = FAR_ULPS * 2.0 ** -23
    if not torch.equal(finite, torch.isfinite(lse)):
        lse_ratio = float("inf")
    else:
        row_limit = (lse_ref[finite].abs() * ulp).clamp_min(tol)
        lse_ratio = ((lse[finite] - lse_ref[finite]).abs() / row_limit).max().item()
    out = {"o": (err, tol), "lse": (lse_ratio, 1.0)}
    grad_limit = max(tol, ulp * lse_ref[finite].abs().max().item())
    for g, (_, rel) in window_bwd_errors(window_bwd_inputs(case, gen)).items():
        out[g] = (rel, grad_limit)
    return out


def unfolded(args: tuple, heads: int) -> tuple:
    """A ``kv_cases`` entry's args with its folded decode q (``[B, H_kv,
    group, D]``, pos_div = group) unfolded to ``[B, heads, 1, D]``."""
    from ..ops.attention import unfold_gqa_rows

    return (unfold_gqa_rows(args[0], heads, 1).contiguous(),) + tuple(args[1:])


# The cache kernels' transformed checks: (kv_cases entry, unfold the
# decode rows, features).  Folded decode takes the softcap alone; ALiBi
# runs unfolded (16 q-heads, a row each).  The prefill chunk, fp32 q, the
# skewed lengths and head dim 128; e4m3 once.
XF_KV_CASES = tuple(
    (f"{kernel}_{tag}", unfold, feats)
    for kernel in ("quant_int8", "paged", "paged_quant_int8")
    for tag, unfold, feats in (
        ("decode_bf16", False, _CAP), ("decode_bf16_peaked", True, _BOTH),
        ("decode_bf16_spike", True, dict(alibi="large")),
        ("decode_bf16_peaked", False, dict(softcap=0.5)),
        ("prefill_bf16", False, _BOTH), ("prefill_bf16_peaked", False, dict(softcap=0.5,
                                                                           alibi="small")),
        ("prefill_fp32", False, _BOTH), ("decode_skewed_bf16", True, dict(_BOTH, window=64)),
        ("decode_bf16_d128", True, _BOTH))
) + (("quant_e4m3_decode_bf16_peaked", True, _BOTH),
     ("paged_quant_e4m3_prefill_bf16", False, _BOTH))


def xf_kv_case(cases: dict, name: str, unfold: bool, feats: dict) -> Tuple[str, tuple, int, dict]:
    """``(kernel, args, pos_div, keywords)`` of an ``XF_KV_CASES`` entry
    over ``kv_cases`` (and ``kv_d128_cases``)."""
    kernel, args, pos_div = cases[name]
    if unfold:
        args, pos_div = unfolded(args, 2 * args[0].shape[1]), 1
    kw = dict(feats)
    if "alibi" in kw:
        kw["alibi_slopes"] = alibi_slopes(kw.pop("alibi"), args[0].shape[1])
    return kernel, args, pos_div, kw


# ---------------------------------------------------------------------------
# Attention dropout on the general forward (row 1: the wgmma kernel and the
# fp32 template) and the split pair (rows 5-6), against their plain versions,
# which multiply by the keep factors of kernels/_common.py::keep_factors.
# ---------------------------------------------------------------------------

# GPT-2's attn_pdrop, the rate of the dropout FlashLM, and the seed of the
# checks (its top bit set: the hash must take it as unsigned).
DROP_RATE = 0.1
DROP_SEED = -1_234_567_891
# Shard offsets (row, col, batch, head) and a global head count of 4096
# (so that bh passes 2^16 from the first batch on), as a sequence-, data-
# and head-sharded call passes them.
DROP_OFFSETS = (1000, 333, 30, 7)
DROP_HEADS = 4096
FP32_D128_Q, FP32_D128_KV = (4, 16, 512, 128), (4, 8, 512, 128)
_DROP = dict(dropout=DROP_RATE)
# (name, q shape, kv shape, dtype, fixture, offsets, pos_div, features), as
# WINDOW_FWD_CASES.  The training shape at D 64 and 128, bf16 and fp32, on
# the ladder, peaked and spike fixtures; dropout with the window and sinks,
# the softcap and ALiBi all together; with segment ids; with shard offsets
# and a global head count; per-batch offsets (which must not enter the
# hash); not causal; fp32 at N 512; one unfolded decode token (n_q 1: the
# wgmma kernel and the template, never the decode grid).
DROP_FWD_CASES = (
    ("train_drop_bf16", TRAIN_Q, TRAIN_KV, "bf16", "ladder", 0, 1, _DROP),
    ("train_drop_bf16_peaked", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1, _DROP),
    ("train_drop_bf16_spike", TRAIN_Q, TRAIN_KV, "bf16", "spike", 0, 1, _DROP),
    ("train_drop_bf16_d128", TRAIN_D128_Q, TRAIN_D128_KV, "bf16", "ladder", 0, 1, _DROP),
    ("train_drop_bf16_peaked_d128", TRAIN_D128_Q, TRAIN_D128_KV, "bf16", "peaked", 0, 1, _DROP),
    ("train_drop_fp32", TRAIN_Q, TRAIN_KV, "fp32", "ladder", 0, 1, _DROP),
    ("train_drop_fp32_d128", TRAIN_D128_Q, TRAIN_D128_KV, "fp32", "ladder", 0, 1, _DROP),
    ("train_drop_all_bf16", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1,
     dict(_DROP, window=WINDOW, sinks=SINKS, softcap=SOFTCAP, alibi="std")),
    ("train_drop_seg_bf16", TRAIN_Q, TRAIN_KV, "bf16", "peaked", 0, 1, dict(_DROP, segments=True)),
    ("train_drop_shard_bf16", TRAIN_Q, TRAIN_KV, "bf16", "ladder", 0, 1,
     dict(_DROP, drop_offsets=DROP_OFFSETS, dropout_heads=DROP_HEADS)),
    ("train_drop_offs_bf16", TRAIN_Q, TRAIN_KV, "bf16", "peaked", XF_NEAR_OFFSETS, 1, _DROP),
    ("train_drop_full_bf16", TRAIN_Q, TRAIN_KV, "bf16", "ladder", 0, 1,
     dict(_DROP, causal=False)),
    ("fp32_n512_drop_peaked", TRAIN_FP32_Q, TRAIN_FP32_KV, "fp32", "peaked", 0, 1, _DROP),
    ("fp32_n512_drop_all_d128", FP32_D128_Q, FP32_D128_KV, "fp32", "peaked", 0, 1,
     dict(_DROP, window=100, sinks=SINKS, softcap=SOFTCAP, alibi="std", segments=True,
          drop_offsets=DROP_OFFSETS, dropout_heads=DROP_HEADS)),
    ("decode_drop_bf16", XF_DECODE_Q, DECODE_KV, "bf16", "peaked", None, 1, _DROP),
    ("decode_drop_fp32", XF_DECODE_Q, DECODE_KV, "fp32", "peaked", None, 1, _DROP),
)
# The backward checks (the split pair: dropout takes no other backward).
DROP_BWD_CASES = tuple(c[0] for c in DROP_FWD_CASES if not c[0].startswith("decode"))


def drop_fwd_cases(gen: torch.Generator, names=None) -> Dict[str, tuple]:
    """``window_fwd_cases`` of ``DROP_FWD_CASES``."""
    return window_fwd_cases(gen, names, DROP_FWD_CASES)


# The bit-exact mask check: (name, q shape, kv heads, dtype, seed, offsets,
# heads).  Rate 0.2 keeps 1.25 (1.25 / 64 and / 128 are exact in bf16).
MASK_RATE = 0.2
MASK_CASES = (
    ("mask_bf16_d64", (2, 4, 200, 64), 2, "bf16", 5, None, None),
    ("mask_bf16_d128", (2, 4, 200, 128), 2, "bf16", 5, None, None),
    ("mask_bf16_d64_shard", (2, 4, 200, 64), 2, "bf16", DROP_SEED, DROP_OFFSETS, DROP_HEADS),
    ("mask_bf16_d128_shard", (2, 4, 130, 128), 4, "bf16", DROP_SEED, DROP_OFFSETS, DROP_HEADS),
    ("mask_fp32_d64_shard", (2, 4, 200, 64), 2, "fp32", DROP_SEED, DROP_OFFSETS, DROP_HEADS),
    ("mask_fp32_d128", (2, 4, 130, 128), 4, "fp32", -7, (0, 5, 0, 70000), None),
    ("mask_bf16_d64_one_row", (3, 4, 1, 64), 2, "bf16", DROP_SEED, DROP_OFFSETS, DROP_HEADS),
)


def dropout_mask(name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(got, want)`` of a ``MASK_CASES`` entry: the forward kernel's keep
    mask and ``_common.keep_factors`` (computed on the host), both fp32
    ``[B, H, N_q, N_kv]``.  With q = k = 0 every score is 0, P is 1 and the
    row sum ``n_kv``; over ``n_kv = D`` columns and V the identity, ``o *
    n_kv`` is row r's keep factors exactly, so the two must be equal."""
    _, shape_q, hkv, dt, seed, offsets, heads = next(c for c in MASK_CASES if c[0] == name)
    b, h, n_q, d = shape_q
    dtype = _DTYPES[dt]
    q = torch.zeros(shape_q, dtype=dtype, device="cuda")
    k = torch.zeros((b, hkv, d, d), dtype=dtype, device="cuda")
    v = torch.eye(d, dtype=dtype, device="cuda").expand(b, hkv, d, d).contiguous()
    packed = pack_dropout_seed(seed, offsets)
    o = flash_attention_fwd(q, k, v, causal=False, dropout_rate=MASK_RATE,
                            dropout_seed=packed.to("cuda"), dropout_heads=heads)
    want = keep_factors((b, h, n_q, d), MASK_RATE, packed, heads, "cpu")
    return o.float().cpu() * d, want


def alibi_bias(slopes: torch.Tensor, n_q: int, n_kv: int, offsets: torch.Tensor,
               visible: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """SDPA's float mask of an ALiBi call: ``slope_h * (c - p)`` where
    ``visible`` (``[B or 1, 1, N_q, N_kv]``), -inf elsewhere, ``[B or 1, H,
    N_q, N_kv]`` in ``dtype`` on the card."""
    pos = torch.arange(n_q, device="cuda")[None, :, None] + offsets.to("cuda", torch.int64)[:, None, None]
    dist = (torch.arange(n_kv, device="cuda") - pos).float()[:, None]
    bias = slopes.reshape(1, -1, 1, 1) * dist
    return bias.masked_fill(~visible, float("-inf")).to(dtype)


def fwd_work(q: torch.Tensor, k: torch.Tensor, offsets, pos_div: int = 1,
             save_lse: bool = False, window: Optional[int] = None,
             sinks: int = 0) -> Tuple[float, float]:
    """``(flops, bytes)`` one causal call of the dense forward kernel must
    do: 4 * D flops per visible (row, column) pair (under a window, its
    visible pairs only); each slot's K and V rows that any of its rows sees
    read once, q read and o (and the lse) written once.  A call that sees
    no pair reads nothing: it only writes o = 0 (and lse = -inf)."""
    heads, n_q, head_dim = q.shape[1:]
    kv_heads, n_kv = k.shape[1], k.shape[2]
    offsets = [int(x) for x in offsets]
    win = dict(window=window, sinks=sinks)
    pairs = heads * sum(visible_pairs(n_q, n_kv, off, pos_div, **win) for off in offsets)
    rows = kv_heads * sum(visible_kv_rows(n_q, n_kv, off, pos_div, **win) for off in offsets)
    nbytes = kv_cache_bytes(rows, head_dim, k.element_size()) + q.numel() * q.element_size()
    if pairs:
        nbytes += q.numel() * q.element_size()
    if save_lse:
        nbytes += 4 * q.numel() // head_dim
    return 4.0 * head_dim * pairs, nbytes


def kv_work(kernel: str, args: tuple, pos_div: int, window: Optional[int] = None,
            sinks: int = 0) -> Tuple[float, float]:
    """``(flops, bytes)`` one ``KV_KERNELS`` call must do on this data: 4 *
    D flops per visible (row, column) pair (under a window, its visible
    pairs only); each slot's K and V rows that any of its rows sees read
    once (``kv_cache_bytes``: 1 byte per element and a 4-byte scale per row
    of an 8-bit cache), q read and o (and the quant kernel's lse) written
    once."""
    q, offsets = args[0], args[-1].tolist()
    heads, n_q, head_dim = q.shape[1:]
    if kernel == "flash_quant":
        kv_heads, n_kv, item = args[1].k_q.shape[1], args[1].seq_len, 1
    else:
        kv_heads, n_kv, item = args[1].shape[1], args[-2].shape[1] * PAGE, args[1].element_size()
    win = dict(window=window, sinks=sinks)
    pairs = heads * sum(visible_pairs(n_q, n_kv, off, pos_div, **win) for off in offsets)
    rows = kv_heads * sum(visible_kv_rows(n_q, n_kv, off, pos_div, **win) for off in offsets)
    nbytes = kv_cache_bytes(rows, head_dim, item, scaled=kernel != "flash_paged")
    nbytes += 2 * q.numel() * q.element_size()
    if kernel == "flash_quant":
        nbytes += 4 * q.numel() // head_dim
    return 4.0 * head_dim * pairs, nbytes


# ---------------------------------------------------------------------------
# GQA-folded calls of more than 16 rows (a speculative verify window): rows
# 1 and 11-13 on the wgmma forward's split-KV folded grid
# (csrc/flash_fold_sm90.cu), against their plain versions.
# ---------------------------------------------------------------------------

# TinyLlama-1.1B's attention (32 q-heads over 4 KV heads, group 8) verifying
# gamma 4 draft tokens: 5 positions x 8 q-heads = 40 folded rows a KV head,
# over the serving engine's 2048-slot cache, at 8 slots.
FOLD_KV_HEADS, FOLD_N_KV, FOLD_BATCH = 4, 2048, 8
# (rows, pos_div): group 2 at gamma 8, group 3 at gamma 6 (a position's rows
# straddle the 64-row tile edge), group 8 at gamma 2, 4 and 15.
FOLD_SHAPES = ((18, 2), (21, 3), (24, 8), (40, 8), (128, 8))
# The cache kinds: the dense entry's bf16 cache, the 8-bit formats, the
# bf16 and int8 page pools.
FOLD_FORMATS = ("bf16", "int8", "e4m3", "e5m2", "paged", "paged_int8")
_FOLD_QDT = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
             "paged_int8": torch.int8}
FOLD_FEATURES = {"": {}, "_w512": dict(window=WINDOW, sinks=SINKS), "_cap30": dict(softcap=30.0)}


def fold_lengths(n_q: int, pos_div: int, batch: int = FOLD_BATCH,
                 n_kv: int = FOLD_N_KV) -> torch.Tensor:
    """Seeded ragged slot lengths of a verify window: the full cache (the
    window's last position at n_kv - 1; one slot holds just that), 0, a tile
    edge and the rest drawn."""
    full = n_kv - -(-n_q // pos_div)
    rng = np.random.default_rng(SEED + n_q + pos_div)
    lengths = rng.integers(1, full, max(batch, 3))
    lengths[:3] = (full, 0, 64)
    return torch.from_numpy(lengths[:batch].astype(np.int32)).to("cuda")


def fold_pages(xs, lengths: torch.Tensor, n_q: int, pos_div: int, gen) -> tuple:
    """``(pools, table)``: each of ``xs`` (``[B, H_kv, N, ...]``) laid into a
    shuffled page pool (``to_pages``: page 0 NaN, the table's entries past
    each slot's diagonal 0), with the longest slot's first page moved to the
    pool's last page ``P - 1`` and its table entry set to ``P + 1``: past
    the pool, so clamped back to ``P - 1`` (paged.py:64-65).  Each pool is
    a view of a buffer whose two pages after it hold NaN, so a kernel that
    reads the entry unclamped turns that slot's rows NaN."""
    b, _, n_kv = xs[0].shape[:3]
    perm, table, n_pages = paged_layout(b, n_kv, lengths, n_q, pos_div, gen)
    last, slot = n_pages - 1, int(torch.argmax(lengths))
    at = (perm == last).nonzero()[0]
    perm[at[0], at[1]], perm[slot, 0] = perm[slot, 0].clone(), last
    live = ((n_q - 1) // pos_div + lengths.long()) // PAGE + 1
    table = torch.where(torch.arange(perm.shape[1], device="cuda")[None, :] < live[:, None],
                        perm, 0).to(torch.int32)
    table[slot, 0] = n_pages + 1
    pools = []
    for x in xs:
        pool = to_pages(x, perm, n_pages)
        buf = torch.empty((n_pages + 2, *pool.shape[1:]), dtype=pool.dtype, device="cuda")
        if x.element_size() == 1:
            buf.view(torch.uint8)[n_pages:] = 0x7F
        else:
            buf[n_pages:] = float("nan")
        buf[:n_pages] = pool
        pools.append(buf[:n_pages])
    return pools, table


def fold_case(gen, n_q: int, pos_div: int, head_dim: int, fmt: str, fixture: str = "",
              batch: int = FOLD_BATCH) -> Tuple[str, tuple]:
    """``(kernel, args)`` of one folded call: bf16 q ``[batch, 4, n_q, D]``
    on ``fixture`` ("" the ladder, "peaked", "spike" or "negative") over a
    2048-slot cache of ``fmt`` at ``fold_lengths``, a paged format through
    ``fold_pages``."""
    shape_q = (batch, FOLD_KV_HEADS, n_q, head_dim)
    shape_kv = (batch, FOLD_KV_HEADS, FOLD_N_KV, head_dim)
    q, k, v = _fixture(shape_q, shape_kv, torch.bfloat16, gen, fixture or "ladder")
    lengths = fold_lengths(n_q, pos_div, batch)
    if fmt == "bf16":
        return "flash_fwd", (q, k, v, lengths)
    if fmt == "paged":
        pools, table = fold_pages((k, v), lengths, n_q, pos_div, gen)
        return "flash_paged", (q, *pools, table, lengths)
    qkv = quantize_kv(k, v, _FOLD_QDT[fmt])
    if fmt == "paged_int8":
        pools, table = fold_pages((qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale), lengths, n_q,
                                  pos_div, gen)
        return "flash_paged_quant", (q, *pools, table, lengths)
    return "flash_quant", (q, qkv, lengths)


def fold_cases(gen, shapes=FOLD_SHAPES, head_dims=(64, 128), formats=FOLD_FORMATS,
               fixtures=("",), features=("",),
               batch: int = FOLD_BATCH) -> Dict[str, Tuple[str, tuple, int, dict]]:
    """``{name: (kernel, args, pos_div, features)}`` over the product of
    ``shapes`` (``(n_q, pos_div)``), head dims, fixtures, cache formats and
    ``FOLD_FEATURES`` keys, each call's inputs drawn from ``gen``."""
    cases = {}
    for n_q, pos_div in shapes:
        for d in head_dims:
            for fix in fixtures:
                for fmt in formats:
                    kernel, args = fold_case(gen, n_q, pos_div, d, fmt, fix, batch)
                    for feat in features:
                        name = f"fold_{fmt}_{n_q}x{pos_div}_d{d}{'_' + fix if fix else ''}{feat}"
                        cases[name] = (kernel, args, pos_div, FOLD_FEATURES[feat])
    return cases


def fold_call(kernel: str, args: tuple, pos_div: int, plain: bool = False, **feats):
    """One folded call of ``kernel`` (its wrapper, or its plain version in
    fp32): ``o``, or the quant and dense kernels' ``(o, lse)``."""
    if kernel != "flash_fwd":
        return KV_KERNELS[kernel][plain](*args, pos_div, **feats)
    q, k, v, off = args
    if plain:
        return flash_attention_fwd_plain(q.float(), k.float(), v.float(), off, sm_scale=_scale(q),
                                         causal=True, pos_div=pos_div, save_lse=True, **feats)
    return flash_attention_fwd(q, k, v, off, causal=True, pos_div=pos_div, save_lse=True,
                               **feats)


def fold_error(case: tuple) -> Tuple[float, float]:
    """Errors of one ``fold_cases`` entry against its plain version, in fp32
    (``_fwd_errors``)."""
    kernel, args, pos_div, feats = case
    return _fwd_errors(fold_call(kernel, args, pos_div, **feats),
                       fold_call(kernel, args, pos_div, plain=True, **feats))


# Each folded kernel's wrapper (its launches and its last grid).
FOLD_WRAPPERS = {"flash_fwd": flash_fwd_general, "flash_quant": flash_attention_quant,
                 "flash_paged": flash_attention_paged,
                 "flash_paged_quant": flash_attention_paged_quant}


def fold_work(case: tuple) -> Tuple[float, float]:
    """``(flops, bytes)`` one ``fold_cases`` call must do (``kv_work``, and
    ``fwd_work`` with its lse for the dense kernel)."""
    kernel, args, pos_div, feats = case
    win = dict(window=feats.get("window"), sinks=feats.get("sinks", 0))
    if kernel == "flash_fwd":
        return fwd_work(args[0], args[1], args[3].tolist(), pos_div, save_lse=True, **win)
    return kv_work(kernel, args, pos_div, **win)


def fold_sdpa_ms(case: tuple) -> Tuple[float, str]:
    """The library yardstick of a ``fold_cases`` call: SDPA over a dense
    bf16 cache of its shape, unfolded (q ``[B, H_kv * pos_div, n_q /
    pos_div, D]``), under the boolean mask of each slot's causal offset
    (another function for the 8-bit and paged caches).  Every backend is
    tried, with ``enable_gqa`` and on K/V repeated to q's heads before the
    timed call; those that refuse the call are passed over.  Returns the
    fastest one's device ms and its backend.  The port never calls it."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    kernel, args, pos_div, _ = case
    q, lengths = args[0], args[-1]
    b, h_kv, n_q, d = q.shape
    t = -(-n_q // pos_div)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    qu, k, v = ladder_inputs((b, h_kv * pos_div, t, d), (b, h_kv, FOLD_N_KV, d), torch.bfloat16,
                             gen)
    kr, vr = (x.repeat_interleave(pos_div, dim=1) for x in (k, v))
    cols = torch.arange(FOLD_N_KV, device="cuda")
    rows = torch.arange(t, device="cuda")
    mask = (cols[None, None, :] <= (lengths[:, None, None] + rows[None, :, None]))[:, None]
    best = (float("inf"), "")
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        for how, kk, vv, gqa in (("enable_gqa", k, v, True), ("repeated K/V", kr, vr, False)):
            def call(kk=kk, vv=vv, gqa=gqa):
                return F.scaled_dot_product_attention(qu, kk, vv, attn_mask=mask, enable_gqa=gqa)
            try:
                with sdpa_kernel(backend), warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    ms = device_ms(call)
            except RuntimeError:  # this backend does not take the call
                continue
            if ms < best[0]:
                best = (ms, f"{backend.name} ({how}, boolean mask)")
    if not best[1]:
        raise RuntimeError("no SDPA backend takes the folded verify call")
    return best


# ---------------------------------------------------------------------------
# A rolling cache's position map (kv_positions): rows 1 and 11 in position
# space, the wgmma forward's position walk, the template's and the decode
# grid's kPos instances, against their plain versions.
# ---------------------------------------------------------------------------

# The rolling cache of the windowed FlashLM (W 512, 4 sinks):
# ceil((512 + 4) / 128) * 128 + 128 slots, as DecodeEngine(rolling=True).
ROLL_CAP = 768
# Tokens each slot has seen (the query rows' included) at decode: a slot
# that has not filled the cache (most slots -1), one at the capacity, and
# slots wrapped once to six times.
POS_DECODE_TOTALS = (1, 37, 300, 700, 768, 1000, 3000, 5000)
# Decode totals whose rows' windows all lie near them (fp32 under ALiBi:
# XF_OFFSETS' note on far rows).
POS_NEAR_TOTALS = (1, 37, 100, 300, 500, 700, 760, 768)
# A prefill chunk of 128 rows: a wrapped slot and a short one.
POS_PREFILL_TOTALS = (2000, 300)
# Share of the slots whose position is set to -1 (holes: a padded row's
# slot, or one never written), beside the slots no token reached.
POS_HOLES = 0.05
_W = dict(window=WINDOW, sinks=SINKS)
_XF = dict(window=WINDOW, sinks=SINKS, softcap=30.0, alibi="std")
_S70 = dict(window=WINDOW, sinks=70)
POS_PREFILL_Q, POS_PREFILL_KV = (2, 16, 128, 64), (2, 8, ROLL_CAP, 64)
POS_DECODE_Q, POS_DECODE_KV = (8, 16, 1, 64), (8, 8, ROLL_CAP, 64)
POS_PREFILL_D128_Q, POS_PREFILL_D128_KV = (2, 16, 128, 128), (2, 8, ROLL_CAP, 128)
POS_DECODE_D128_Q, POS_DECODE_D128_KV = (8, 16, 1, 128), (8, 8, ROLL_CAP, 128)
# (name, kernel: "fwd" (row 1) or the 8-bit cache of row 11, q shape, kv
# shape, dtype, fixture, totals, features).  The sinks-70 cases make the
# sinks a visible share of every long row (a fault that drops them shows).
POS_CASES = (
    ("pos_prefill_bf16", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "ladder",
     POS_PREFILL_TOTALS, _W),
    ("pos_prefill_bf16_peaked", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "peaked",
     POS_PREFILL_TOTALS, _W),
    ("pos_prefill_bf16_spike", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "spike",
     (2000, 900), _W),
    ("pos_prefill_bf16_xf", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "peaked",
     POS_PREFILL_TOTALS, _XF),
    ("pos_prefill_bf16_s70", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "peaked",
     POS_PREFILL_TOTALS, _S70),
    ("pos_prefill_bf16_d128", "fwd", POS_PREFILL_D128_Q, POS_PREFILL_D128_KV, "bf16", "peaked",
     POS_PREFILL_TOTALS, _W),
    ("pos_prefill_bf16_xf_d128", "fwd", POS_PREFILL_D128_Q, POS_PREFILL_D128_KV, "bf16",
     "peaked", POS_PREFILL_TOTALS, _XF),
    ("pos_prefill_fp32", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "fp32", "peaked",
     POS_PREFILL_TOTALS, _W),
    ("pos_prefill_fp32_s70", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "fp32", "peaked",
     POS_PREFILL_TOTALS, _S70),
    ("pos_prefill_fp32_xf", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "fp32", "peaked", (700, 300),
     _XF),
    ("pos_prefill_fp32_d128", "fwd", POS_PREFILL_D128_Q, POS_PREFILL_D128_KV, "fp32", "peaked",
     POS_PREFILL_TOTALS, _W),
    ("pos_decode_bf16", "fwd", POS_DECODE_Q, POS_DECODE_KV, "bf16", "ladder", POS_DECODE_TOTALS,
     _W),
    ("pos_decode_bf16_peaked", "fwd", POS_DECODE_Q, POS_DECODE_KV, "bf16", "peaked",
     POS_DECODE_TOTALS, _W),
    ("pos_decode_bf16_spike", "fwd", POS_DECODE_Q, POS_DECODE_KV, "bf16", "spike",
     POS_DECODE_TOTALS, _W),
    ("pos_decode_bf16_negative", "fwd", POS_DECODE_Q, POS_DECODE_KV, "bf16", "negative",
     POS_DECODE_TOTALS, _W),
    ("pos_decode_bf16_xf", "fwd", POS_DECODE_Q, POS_DECODE_KV, "bf16", "peaked",
     POS_DECODE_TOTALS, _XF),
    ("pos_decode_bf16_s70", "fwd", POS_DECODE_Q, POS_DECODE_KV, "bf16", "peaked",
     POS_DECODE_TOTALS, _S70),
    ("pos_decode_bf16_d128", "fwd", POS_DECODE_D128_Q, POS_DECODE_D128_KV, "bf16", "peaked",
     POS_DECODE_TOTALS, _W),
    ("pos_decode_fp32", "fwd", POS_DECODE_Q, POS_DECODE_KV, "fp32", "peaked", POS_DECODE_TOTALS,
     _W),
    ("pos_decode_fp32_xf", "fwd", POS_DECODE_Q, POS_DECODE_KV, "fp32", "peaked", POS_NEAR_TOTALS,
     _XF),
    ("pos_decode_fp32_d128", "fwd", POS_DECODE_D128_Q, POS_DECODE_D128_KV, "fp32", "peaked",
     POS_DECODE_TOTALS, _W),
    ("pos_prefill_int8", "int8", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "peaked",
     POS_PREFILL_TOTALS, _W),
    ("pos_prefill_int8_xf", "int8", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "peaked",
     POS_PREFILL_TOTALS, _XF),
    ("pos_prefill_int8_d128", "int8", POS_PREFILL_D128_Q, POS_PREFILL_D128_KV, "bf16", "peaked",
     POS_PREFILL_TOTALS, _W),
    ("pos_prefill_int8_fp32", "int8", POS_PREFILL_Q, POS_PREFILL_KV, "fp32", "peaked",
     POS_PREFILL_TOTALS, _W),
    # The template's kPos instance under the transforms over a wrapped cache
    # (fp32 q: bf16 takes the wgmma walk), at the small slopes: a row's
    # scores stay near 0, where fp32 holds 1e-5.
    ("pos_prefill_int8_fp32_xf", "int8", POS_PREFILL_Q, POS_PREFILL_KV, "fp32", "peaked",
     POS_PREFILL_TOTALS, dict(_XF, alibi="small")),
    ("pos_decode_int8", "int8", POS_DECODE_Q, POS_DECODE_KV, "bf16", "peaked", POS_DECODE_TOTALS,
     _W),
    ("pos_decode_int8_xf", "int8", POS_DECODE_Q, POS_DECODE_KV, "bf16", "peaked",
     POS_DECODE_TOTALS, _XF),
    ("pos_decode_int8_d128", "int8", POS_DECODE_D128_Q, POS_DECODE_D128_KV, "bf16", "peaked",
     POS_DECODE_TOTALS, _W),
    ("pos_decode_int8_fp32", "int8", POS_DECODE_Q, POS_DECODE_KV, "fp32", "peaked",
     POS_DECODE_TOTALS, _W),
    ("pos_decode_e4m3", "e4m3", POS_DECODE_Q, POS_DECODE_KV, "bf16", "peaked", POS_DECODE_TOTALS,
     _W),
)
_QDT = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}
# Segment ids over the same rolling caches (row 1; the 8-bit entry takes
# none, as in JAX): the slots' ids change at slot POS_SEG_KV_CUT, inside a
# 64-slot tile; a prefill chunk's rows' at row POS_SEG_Q_CUT, inside a Q
# tile (rows g and g + 8 of one warp differ); the chunk's last row, and
# decode batch 0, hold POS_SEG_NONE, which no slot holds (o = 0, lse =
# -inf).  Decode-sized calls take the segmented position walks too.
POS_SEG_KV_CUT, POS_SEG_Q_CUT, POS_SEG_NONE = 200, 40, 9
_SEG = dict(_W, segments=True)
POS_SEG_CASES = (
    ("pos_seg_prefill_bf16", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "ladder",
     POS_PREFILL_TOTALS, _SEG),
    ("pos_seg_prefill_bf16_peaked", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "peaked",
     POS_PREFILL_TOTALS, _SEG),
    ("pos_seg_prefill_bf16_spike", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "spike",
     (2000, 900), _SEG),
    ("pos_seg_prefill_bf16_xf", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "bf16", "peaked",
     POS_PREFILL_TOTALS, dict(_XF, segments=True)),
    ("pos_seg_prefill_bf16_d128", "fwd", POS_PREFILL_D128_Q, POS_PREFILL_D128_KV, "bf16",
     "peaked", POS_PREFILL_TOTALS, _SEG),
    ("pos_seg_decode_bf16", "fwd", POS_DECODE_Q, POS_DECODE_KV, "bf16", "peaked",
     POS_DECODE_TOTALS, _SEG),
    ("pos_seg_decode_bf16_negative", "fwd", POS_DECODE_Q, POS_DECODE_KV, "bf16", "negative",
     POS_DECODE_TOTALS, _SEG),
    ("pos_seg_prefill_fp32", "fwd", POS_PREFILL_Q, POS_PREFILL_KV, "fp32", "peaked",
     POS_PREFILL_TOTALS, _SEG),
    ("pos_seg_prefill_fp32_d128", "fwd", POS_PREFILL_D128_Q, POS_PREFILL_D128_KV, "fp32",
     "peaked", POS_PREFILL_TOTALS, _SEG),
    ("pos_seg_decode_fp32", "fwd", POS_DECODE_Q, POS_DECODE_KV, "fp32", "peaked",
     POS_DECODE_TOTALS, _SEG),
)


def pos_segment_ids(q_shape, n_kv: int, device="cuda") -> SegmentIds:
    """``POS_SEG_CASES``' ids for q ``[B, H, N_q, D]`` over ``n_kv`` slots
    (see there)."""
    batch, _, n_q, _ = q_shape
    kv = 1 + (torch.arange(n_kv, device=device) >= POS_SEG_KV_CUT).int()
    if n_q > 1:
        q = 1 + (torch.arange(n_q, device=device) >= POS_SEG_Q_CUT).int()
        q[-1] = POS_SEG_NONE
        q = q.expand(batch, n_q)
    else:
        q = 1 + (torch.arange(batch, device=device) % 2).int()[:, None]
        q[0] = POS_SEG_NONE
    return SegmentIds(q.contiguous(), kv.expand(batch, n_kv).contiguous())


def rolling_positions(totals, capacity: int, sinks: int, gen: torch.Generator,
                      holes: float = POS_HOLES) -> torch.Tensor:
    """int32 ``[B, capacity]`` position maps on the card, one per slot
    count in ``totals``: each position below ``totals[b]`` in its rolling
    slot (``runtime.kv_cache.rolling_slots``; the latest writer wins), then
    the slots shuffled (a kernel must not rely on slot order) and a
    ``holes`` share of them set to -1."""
    rows = []
    for total in totals:
        pos = np.full(capacity, -1, np.int64)
        p = np.arange(total)
        slots = np.where(p < sinks, p, sinks + (p - sinks) % (capacity - sinks))
        np.maximum.at(pos, slots, p)
        rows.append(torch.from_numpy(pos))
    pos = torch.stack(rows).to("cuda")
    perm = torch.argsort(torch.rand(pos.shape, generator=gen, device="cuda"), dim=1)
    pos = pos.gather(1, perm)
    drop = torch.rand(pos.shape, generator=gen, device="cuda") < holes
    return pos.masked_fill(drop, -1).to(torch.int32).contiguous()


# The fault ``chip_smoke.py`` plants in a copy of ``csrc/`` (source, old,
# new): both segmented position walks ignore the ids, the wgmma walk the
# bf16 cases' and the template the fp32 cases' (``tests/test_torch_gpu.py::
# PLANTED_POS_SEG_FAULTS`` plants these and others one at a time).
POS_SEG_IGNORED = (
    ("flash_fwd_sm90.cuh", "if ((int)ids[j * 8 + (e & 1)] != qid[e >> 1]) return false;",
     "(void)0;"),
    ("flash_fwd.cu", "if constexpr (kPosSeg) seen[j] = seen[j] && kids[c] == my_seg;", ""),
)
# The split-KV decode grid's units, which flash_fwd.cu calls.
DECODE_UNITS = ("flash_decode.cu", "flash_decode_int8.cu", "flash_decode_e4m3.cu",
                "flash_decode_e5m2.cu")
# The wgmma prefill of the 8-bit and paged caches, and the folded grid of
# every cache, which flash_fwd.cu calls.
KV_SM90_UNIT = "flash_kv_sm90.cu"
FOLD_UNIT = "flash_fold_sm90.cu"
# Every unit flash_fwd.cu's entries call.
FWD_UNITS = (*DECODE_UNITS, KV_SM90_UNIT, FOLD_UNIT)
# flash_fwd.cu with the route to flash_kv_sm90.cu turned off: the bf16
# prefill of the 8-bit and paged caches on the 64-row template, the design
# before it (a "fault" for build_planted, to time the two in one call).
KV_TEMPLATE_ROUTE = (
    ("flash_fwd.cu",
     "if (pos_div == 1 && n_q > kDecodeRows && f.q_seg == nullptr && !f.drop.on()) {",
     "if (false) {"),
)
# flash_fwd.cu with the route to flash_fold_sm90.cu turned off: the bf16
# calls folded by GQA of more than 16 rows on the 64-row template, the
# design before it (timed beside the folded grid in one call).
KV_FOLD_TEMPLATE_ROUTE = (
    ("flash_fwd.cu", "if (pos_div > 1 && n_q > kDecodeRows) {", "if (false) {"),
)


def planted_copy(work: Path, faults) -> Path:
    """``csrc/`` copied to ``work/csrc`` with each ``(source, old, new)`` of
    ``faults`` planted (``old`` must occur once); the copy's path."""
    from ..kernels import _build

    src = Path(work) / "csrc"
    shutil.copytree(_build.CSRC, src)
    for source, old, new in faults:
        text = (src / source).read_text()
        if text.count(old) != 1:
            raise ValueError(f"{source}: the planted text occurs {text.count(old)} times")
        (src / source).write_text(text.replace(old, new))
    return src


def build_planted(work: str, faults, units=("flash_fwd.cu", *FWD_UNITS)) -> Path:
    """``units`` built from ``planted_copy(work, faults)`` into
    ``work/planted.so`` (one ``nvcc`` per unit)."""
    from ..kernels import _build

    src = planted_copy(Path(work), faults)
    return _build.compile_library([src / u for u in units], Path(work) / "planted.so")


def build_kv_sm90_planted(work: str, faults: Dict[str, list],
                          unit: str = KV_SM90_UNIT) -> Dict[str, Path]:
    """A library per entry of ``faults`` (name -> ``[(source, old, new),
    ...]``, each ``old`` occurring once), in ``work``: flash_fwd.cu and the
    other units it calls compiled once from this package's csrc/, and each
    entry's ``unit`` (flash_kv_sm90.cu, or flash_fold_sm90.cu) from a copy
    of csrc/ with its faults planted (in that unit, or in a header it
    includes: only its own instances take the planted code), every compile
    started together; then a link per entry.  A planted unit costs one
    unit's compile."""
    from ..kernels import _build

    work = Path(work)
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    common_units = ("flash_fwd.cu", *(u for u in FWD_UNITS if u != unit))
    jobs = {u: _build.CSRC / u for u in common_units}
    for name, planted in faults.items():
        jobs[name] = planted_copy(work / name, planted) / unit
    procs = []
    for key, path in jobs.items():
        obj = work / f"{key}.o"
        cmd = [nvcc, *flags, "-I", str(path.parent), "-c", "-o", str(obj), str(path)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True)))
    _build._run(procs)
    common = [str(work / f"{u}.o") for u in common_units]
    out = {}
    for name in faults:
        out[name] = work / f"{name}.so"
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(out[name]), str(work / f"{name}.o"),
                        *common], check=True, capture_output=True)
    return out


def pos_cases(gen: torch.Generator, names=None, table=POS_CASES) -> Dict[str, tuple]:
    """``{name: (kernel, q, kv, q_offset, kv_positions, features)}`` of
    ``table`` (``POS_CASES`` or ``POS_SEG_CASES``; all, or ``names``):
    ``kv`` the ``(k, v)`` pair, or for an 8-bit kernel its ``QuantizedKV``;
    row ``r`` of batch ``b`` at position ``totals[b] - n_q + r``, so the
    last row is the slot's newest token; ``segments`` becomes the
    ``segment_ids`` of ``pos_segment_ids``."""
    cases = {}
    for name, kernel, sq, skv, dt, fixture, totals, feats in table:
        if names is not None and name not in names:
            continue
        q, k, v = _fixture(sq, skv, _DTYPES[dt], gen, fixture)
        kv = (k, v) if kernel == "fwd" else quantize_kv(k, v, _QDT[kernel])
        pos = rolling_positions(totals, skv[2], feats["sinks"], gen)
        offs = torch.tensor([t - sq[2] for t in totals], dtype=torch.int32, device="cuda")
        feats = dict(feats, causal=True)
        if feats.pop("segments", False):
            feats["segment_ids"] = pos_segment_ids(sq, skv[2])
        if "alibi" in feats:
            feats["alibi_slopes"] = alibi_slopes(feats.pop("alibi"), sq[1])
        cases[name] = (kernel, q, kv, offs, pos, feats)
    return cases


def _pos_kv(case: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """A case's K/V in q's type (an 8-bit cache dequantized)."""
    kernel, q, kv = case[:3]
    return kv if kernel == "fwd" else dequantize_kv(kv, q.dtype)


def pos_call(case: tuple, plain: bool = False, linear: bool = False):
    """The case's kernel with the lse (``plain``: its fp32 plain version):
    ``flash_attention_fwd`` or ``flash_attention_quant``.  ``linear``: the
    index-space windowed call with the same visible pairs, on a linear
    cache of the rolling cache's length, each row at position ``min(p,
    capacity - n_q + r)`` (a row that has filled the cache sees the
    window's and the sinks' columns there)."""
    kernel, q, kv, off, pos, feats = case
    if linear:
        cap = (kv[0] if kernel == "fwd" else kv.k_q).shape[2]
        off, pos = torch.clamp(off, max=cap - q.shape[2]).to(torch.int32), None
    scale = default_scale(q.shape[-1])
    if kernel == "fwd":
        k, v = kv
        if plain:
            return flash_attention_fwd_plain(q.float(), k.float(), v.float(), off, sm_scale=scale,
                                             save_lse=True, kv_positions=pos, **feats)
        return flash_attention_fwd(q, k, v, off, save_lse=True, kv_positions=pos, **feats)
    if plain:
        return flash_attention_quant_plain(q.float(), kv, off, sm_scale=scale, save_lse=True,
                                           kv_positions=pos, **feats)
    return flash_attention_quant(q, kv, off, pos, save_lse=True, **feats)


def pos_error(case: tuple) -> Tuple[float, float]:
    """Errors of a ``pos_cases`` entry's kernel against its plain version
    (see ``_fwd_errors``)."""
    return _fwd_errors(pos_call(case), pos_call(case, plain=True))


def _pos_visible(case: tuple) -> torch.Tensor:
    kernel, q, kv, off, pos, feats = case
    return plain_visible(q.shape[2], pos.shape[1], off, causal=True, window=feats["window"],
                         sinks=feats["sinks"], segment_ids=feats.get("segment_ids"),
                         device=q.device, kv_positions=pos)


def pos_work(case: tuple) -> Tuple[float, float]:
    """``(flops, bytes)`` a position-map call must do on this data: 4 * D
    flops per visible (row, slot) pair; each KV row a row sees read once
    (an 8-bit row with its two scales), the positions, q and o read or
    written once, and the lse."""
    kernel, q, kv, off, pos, feats = case
    heads, n_q, head_dim = q.shape[1:]
    k = kv[0] if kernel == "fwd" else kv.k_q
    visible = _pos_visible(case)
    pairs = heads * int(visible.sum())
    rows = k.shape[1] * int(visible.any(dim=2).sum())
    nbytes = kv_cache_bytes(rows, head_dim, k.element_size(), scaled=kernel != "fwd")
    nbytes += pos.numel() * 4 + 2 * q.numel() * q.element_size() + 4 * q.numel() // head_dim
    return 4.0 * head_dim * pairs, nbytes


def pos_sdpa_ms(case: tuple) -> float:
    """SDPA on the case's K/V in q's type (an 8-bit cache dequantized) under
    the boolean mask of the positions' visible pairs (ALiBi as its float
    bias)."""
    kernel, q, kv, off, pos, feats = case
    k, v = _pos_kv(case)
    mask = visible = _pos_visible(case)
    if feats.get("alibi_slopes") is not None:
        rowp = torch.arange(q.shape[2], device="cuda")[None, :, None] + off[:, None, None].long()
        dist = (pos.long()[:, None, :] - rowp).float()[:, None]
        mask = (feats["alibi_slopes"].reshape(1, -1, 1, 1) * dist).masked_fill(
            ~visible, float("-inf")).to(q.dtype)
    return sdpa_ms(q, k, v, mask=mask)[0]


# ---------------------------------------------------------------------------
# Block-sparse attention (csrc/flash_mask.cu): the forward, dK/dV and dQ
# kernels under ladder rung 11's mask at the training shape.
# ---------------------------------------------------------------------------

# Rung 11's mask at the training length, in 128-row blocks (JAX's blocks).
SPARSE_N, SPARSE_BLOCK = 2048, 128
SPARSE_D128_Q, SPARSE_D128_KV = (1, 8, 2048, 128), (1, 4, 2048, 128)


def sparse_mask(n: int = SPARSE_N):
    """Ladder rung 11's ``BlockMask`` at length ``n``."""
    from ..kernels.flash_mask import BlockMask
    from .verify import block_sparse_rung_mask

    return BlockMask(block_sparse_rung_mask(n), n, n, SPARSE_BLOCK, SPARSE_BLOCK)


def sparse_cases(gen: torch.Generator) -> Dict[str, tuple]:
    """``{name: (q, k, v, do, mask)}`` under ``sparse_mask``: the training
    shape (``TRAIN_Q`` over ``TRAIN_KV``, bf16) on the ladder, peaked and
    spike fixtures; fp32 at N = 512; bf16 at head dim 128 (where the dK/dV
    plan splits the longest walks) on the ladder and peaked fixtures."""
    bf16, f32 = torch.bfloat16, torch.float32
    masks = {n: sparse_mask(n) for n in (SPARSE_N, TRAIN_FP32_Q[2])}
    runs = {
        "sparse_bf16": (TRAIN_Q, TRAIN_KV, bf16, "ladder"),
        "sparse_bf16_peaked": (TRAIN_Q, TRAIN_KV, bf16, "peaked"),
        "sparse_bf16_spike": (TRAIN_Q, TRAIN_KV, bf16, "spike"),
        "sparse_fp32_n512": (TRAIN_FP32_Q, TRAIN_FP32_KV, f32, "ladder"),
        "sparse_bf16_d128": (SPARSE_D128_Q, SPARSE_D128_KV, bf16, "ladder"),
        "sparse_bf16_d128_peaked": (SPARSE_D128_Q, SPARSE_D128_KV, bf16, "peaked"),
    }
    cases = {}
    for name, (shape_q, shape_kv, dtype, fixture) in runs.items():
        if fixture == "spike":
            q, k, v = spike_inputs(shape_q, shape_kv, dtype, gen)
        else:
            scale = PEAKED_Q_SCALE if fixture == "peaked" else 1.0
            q, k, v = ladder_inputs(shape_q, shape_kv, dtype, gen, scale)
        do = ladder_inputs(shape_q, shape_kv, dtype, gen)[0]
        cases[name] = (q, k, v, do, masks[shape_q[2]])
    return cases


def sparse_plain(q, k, v, do, mask):
    """The plain versions of the three kernels in fp32 on the same inputs:
    ``(o, lse, dq, dk, dv)`` (the backward from the plain ``o`` and lse)."""
    from ..kernels import flash_mask as fm

    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    scale = _scale(q)
    o, lse = fm.flash_sparse_fwd_plain(qf, kf, vf, mask, sm_scale=scale, save_lse=True)
    delta = bwd_delta(o, dof, None)
    dk, dv = fm.flash_sparse_dkv_plain(qf, kf, vf, dof, lse, delta, mask, sm_scale=scale)
    dq = fm.flash_sparse_dq_plain(qf, kf, vf, dof, lse, delta, mask, sm_scale=scale)
    return o, lse, dq, dk, dv


def sparse_kernel_errors(case: tuple) -> Dict[str, Tuple[float, float]]:
    """Each block-sparse kernel against its plain version on one
    ``sparse_cases`` entry: ``{"o": (max-abs, lse max-abs)}`` for the
    forward (``_fwd_errors``: NaN or disagreeing dead rows fail), and
    ``{"dq", "dk", "dv"}: (max-abs, normalised)`` for the backward kernels,
    fed the same fp32 o, lse and delta as their plain versions."""
    from ..kernels import flash_mask as fm

    q, k, v, do, mask = case
    scale = _scale(q)
    o_p, lse_p, *grads_p = sparse_plain(q, k, v, do, mask)
    errors = {"o": _fwd_errors(fm.flash_sparse_fwd(q, k, v, mask, sm_scale=scale, save_lse=True),
                               (o_p, lse_p))}
    delta = bwd_delta(o_p, do.float(), None)
    dk, dv = fm.flash_sparse_dkv(q, k, v, do, lse_p, delta, mask, sm_scale=scale)
    dq = fm.flash_sparse_dq(q, k, v, do, lse_p, delta, mask, sm_scale=scale)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), grads_p):
        err = (g.float() - w).abs().max().item()
        errors[name] = (err, err / w.abs().max().item())
    return errors


def sparse_op_grad_errors(case: tuple) -> Dict[str, float]:
    """``torch.autograd.grad`` through ``block_sparse_attention`` (the
    forward kernel, then both backward kernels) against the plain versions'
    gradient: max-abs error over the plain gradient's max-abs, per input."""
    from ..kernels.flash_mask import block_sparse_attention

    q, k, v, do, mask = case
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(block_sparse_attention(*leaves, mask), leaves, do)
    want = sparse_plain(q, k, v, do, mask)[2:]
    torch.cuda.synchronize()
    return {name: ((g.float() - w).abs().max() / w.abs().max()).item()
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}


def sdpa_ms(q, k, v, *, causal: bool = False, mask=None, backward_of=None,
            with_forward: bool = False, dropout_p: float = 0.0) -> Tuple[float, str]:
    """The library yardstick: ``F.scaled_dot_product_attention`` on the
    same inputs, its device ms and the backend it was pinned to.

    bf16 without a mask runs the flash backend, fp32 or an explicit mask
    (needed where the diagonal is not top-left aligned) the memory-efficient
    one.  GQA K/V are repeated to q's heads before the timed call.  With
    ``backward_of=do`` the time is SDPA's backward from
    ``torch.autograd.grad`` with that cotangent (dQ, dK and dV together),
    and with ``with_forward`` the forward and that backward.  ``dropout_p``:
    SDPA's own attention dropout (its RNG, so another mask than the port's).
    The port never calls SDPA; it is timed here only.
    """
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(group, dim=1) for x in (k, v))
    fast = q.dtype == torch.bfloat16 and mask is None
    backend = SDPBackend.FLASH_ATTENTION if fast else SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        kw = dict(attn_mask=mask, is_causal=causal, dropout_p=dropout_p)
        if backward_of is None:
            ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw))
        elif with_forward:
            q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
            ms = device_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(
                q, k, v, **kw), (q, k, v), backward_of))
        else:
            q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
            o = F.scaled_dot_product_attention(q, k, v, **kw)
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


def launched_kernels(fn: Callable[[], object], tries: int = 4) -> List[str]:
    """The names of the device kernels one call of ``fn`` launches, in
    launch order, from a ``torch.profiler`` trace.  ``fn`` runs under a
    trace of its own each time, and the first trace after the first that
    holds device events is read (at most ``tries`` traces; none: ``[]``):
    a process's first traces can come back without device events (seen on
    the H100 hosts, once the first two)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if attempt and events:
            break
    return [ev.name for ev in sorted(events, key=lambda ev: ev.time_range.start)]


def kv_routes_run(names: List[str]) -> List[str]:
    """The ``quant.kv_route`` routes whose device kernels ``names`` holds
    (each once, in ``KV_ROUTE_KERNELS`` order): a route with a walk of its
    own (``KV_ROUTE_WALKS``) by its stem and its walk, another by its stem
    and none of those walks."""
    walks = set(KV_ROUTE_WALKS.values())

    def runs(route: str, stem: str, name: str) -> bool:
        if not re.search(rf"\b{stem}<", name):
            return False
        walk = KV_ROUTE_WALKS.get(route)
        return walk in name if walk else not any(w in name for w in walks)

    return [route for route, stem in KV_ROUTE_KERNELS.items()
            if any(runs(route, stem, name) for name in names)]


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


def _kernel_modules(csrc: Optional[str]) -> SimpleNamespace:
    """The kernel modules whose wrappers ``kernel_times`` calls: this
    package's, or with ``csrc`` those of the tree whose package holds that
    ``csrc/`` directory, imported under another name.  Each tree's wrappers
    then call its own library, built from its own sources into its own
    ``_build/``, whatever its C entries' signatures."""
    if csrc is None:
        pkg = sys.modules[__package__.rpartition(".")[0]]
    else:
        root = Path(csrc).resolve().parent
        name = "fam_other_tree"
        spec = importlib.util.spec_from_file_location(
            name, root / "__init__.py", submodule_search_locations=[str(root)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    name = pkg.__name__
    mod = lambda m: importlib.import_module(f"{name}.kernels.{m}")  # noqa: E731
    return SimpleNamespace(ff=mod("flash_fwd"), fb=mod("flash_bwd"), qt=mod("quant"),
                           pg=mod("paged"), nv=mod("naive"), ft=mod("flash_tri"),
                           fv=mod("flash_v1"), fm=mod("flash_mask"))


def kernel_times(csrc: Optional[str] = None) -> Tuple[Dict[str, float], Dict[str, int]]:
    """``(ms, bytes)``: device ms of the forward, backward, naive and
    triangular kernels at their paths' shapes, through this package's
    wrappers or, with ``csrc``, through the wrappers and the sources of the
    tree that directory belongs to (e.g. an earlier tree unpacked under
    ``_scratch/``): two versions compared on one card, in turns; and the
    triangular backward's workspace at the high-occupancy shape.

    The forward: the general kernel at the training shape (``TRAIN_Q``,
    causal, with its lse) and the prefill chunk (offset 512) at head dim 64
    and 128, and in fp32 at the prefill chunk; folded decode (``DECODE_Q``
    at ``decode_lengths()``, D 64 and 128), and unfolded bf16 decode of one
    token (``DECODE_MHA_Q`` over ``DECODE_MHA_KV``); lean at the sweep's N = 1024 and
    N = 128 (D 64 and 128, bf16) and at the ladder's N = 1024 in fp32; the
    quant (int8), paged and paged-quant (int8) kernels at folded decode (D
    64 and 128, and D 64 at ``skewed_lengths()``) and at the prefill chunk;
    SDPA over a dense bf16 cache at folded decode (D 64 and 128).  Naive in fp32
    at the sweep's N = 1024 (plain and causal), N = 128 and N = 1024 at
    head dim 128.  V1 in fp32 through ``flash_attention_v1`` (the kernel its
    route takes): streaming at the sweep's N = 1024, folded at N = 128, each
    at head dim 64 and 128.  The backward: dK/dV, dQ and the fused kernel in bf16 at
    the training shape (D 64 and 128) and in fp32 at ``TRAIN_FP32_Q``.  The
    triangular forward (with its lse) and backward, each through its
    wrapper (the backward's delta op included), in bf16 at ``HIGH_OCC``
    and ``TRI_D128`` and in fp32 at ``LADDER``.  The three block-sparse
    kernels under rung 11's mask (``BlockMask`` of the tree's own module) in
    bf16 at the training shape and at ``SPARSE_D128_Q`` (with SDPA's forward
    and backward under the same mask there) and in fp32 at
    ``TRAIN_FP32_Q``.  In a tree whose wrappers take a sliding window: the
    general forward, the split pair and the fused backward at the training
    shape (D 64 and 128), folded decode and the quant, paged and
    paged-quant kernels at decode (D 64 and 128), each under ``WINDOW`` and
    ``SINKS`` (keys ``window_*``); in one whose wrappers take dropout, the
    general forward and the split pair at the training shape (D 64 and 128)
    and in fp32 at ``TRAIN_FP32_Q`` at ``DROP_RATE`` (keys ``drop_*``).
    Every input is the ladder fixture.  The workspace: the allocator's peak over one backward call at
    ``HIGH_OCC`` less its outputs and delta (fp32 ``[B, H, N]``), which at
    that shape outweigh the delta op's fp32 temporaries in either tree.
    """
    m = _kernel_modules(csrc)
    ff, fb = m.ff, m.fb
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    times = {}
    for tag, shape_q, shape_kv, dtype, offset in (
        ("train_d64", TRAIN_Q, TRAIN_KV, bf16, 0),
        ("train_d128", TRAIN_D128_Q, TRAIN_D128_KV, bf16, 0),
        ("prefill_d64", PREFILL_Q, PREFILL_KV, bf16, 512),
        ("prefill_d128", PREFILL_D128_Q, PREFILL_D128_KV, bf16, 512),
        ("prefill_fp32", PREFILL_Q, PREFILL_KV, f32, 512),
    ):
        q, k, v = ladder_inputs(shape_q, shape_kv, dtype, gen)
        off = torch.full((shape_q[0],), offset, dtype=torch.int32, device="cuda")
        lse = tag.startswith("train")  # the training forward saves it
        times[f"fwd_{tag}"] = device_ms(
            lambda: ff.flash_fwd_general(q, k, v, off, causal=True, save_lse=lse))
    q, k, v = ladder_inputs(DECODE_Q, DECODE_KV, bf16, gen)
    lengths = torch.from_numpy(decode_lengths()).to("cuda")
    times["fwd_decode_d64"] = device_ms(
        lambda: ff.flash_fwd_general(q, k, v, lengths, causal=True, pos_div=2))
    for tag, shape, dtype in (
        ("n1024_d64", SWEEP_1024, bf16), ("n1024_d128", SWEEP_1024_D128, bf16),
        ("n128_d64", SWEEP_128, bf16), ("n128_d128", SWEEP_128_D128, bf16),
        ("n1024_fp32", LADDER, f32),
    ):
        q, k, v = ladder_inputs(shape, shape, dtype, gen)
        times[f"lean_{tag}"] = device_ms(lambda: ff.flash_fwd_lean(q, k, v))
    kv_wrappers = {
        "flash_quant": lambda q, qkv, off, pos_div, **win: m.qt.flash_attention_quant(
            q, qkv, off, causal=True, pos_div=pos_div, save_lse=True, **win),
        "flash_paged": lambda q, pk, pv, table, lengths, pos_div, **win: m.pg.flash_attention_paged(
            q, pk, pv, table, lengths, pos_div=pos_div, **win),
        "flash_paged_quant": lambda q, pk, pv, pks, pvs, table, lengths, pos_div, **win:
            m.pg.flash_attention_paged_quant(q, pk, pv, pks, pvs, table, lengths,
                                             pos_div=pos_div, **win),
    }
    timed = [f"{k}_{shape}_bf16" for k in ("quant_int8", "paged", "paged_quant_int8")
             for shape in ("decode", "decode_skewed", "prefill")]
    for name, (kernel, args, pos_div) in kv_cases(gen).items():
        if name in timed:
            times[name.replace("_bf16", "")] = device_ms(
                lambda: kv_wrappers[kernel](*args, pos_div))
    for name, (kernel, args, pos_div) in kv_d128_cases(gen).items():
        times[name.replace("_bf16", "")] = device_ms(lambda: kv_wrappers[kernel](*args, pos_div))
    q, k, v = ladder_inputs(DECODE_D128_Q, DECODE_D128_KV, bf16, gen)
    times["fwd_decode_d128"] = device_ms(
        lambda: ff.flash_fwd_general(q, k, v, lengths, causal=True, pos_div=2))
    # Unfolded decode of an MHA model: one token of 16 heads over 16 KV
    # heads, bf16, pos_div 1.
    q, k, v = ladder_inputs(DECODE_MHA_Q, DECODE_MHA_KV, bf16, gen)
    times["fwd_decode_unfolded_d64"] = device_ms(
        lambda: ff.flash_fwd_general(q, k, v, lengths, causal=True))
    # The yardstick: SDPA over a dense bf16 cache at the decode shape, each
    # KV head's group as q-heads.
    for tag, kv_shape in (("d64", DECODE_KV), ("d128", DECODE_D128_KV)):
        b, h, n_kv, d = kv_shape
        qd, kd, vd = ladder_inputs((b, 2 * h, 1, d), kv_shape, bf16, gen)
        mask = (torch.arange(n_kv, device="cuda") <= lengths[:, None])[:, None, None, :]
        times[f"sdpa_dense_decode_{tag}"] = sdpa_ms(qd, kd, vd, mask=mask)[0]
    del q, k, v, qd, kd, vd
    for tag, shape, causal in (("n1024", SWEEP_1024, False), ("n1024_causal", SWEEP_1024, True),
                               ("n128", SWEEP_128, False), ("n1024_d128", SWEEP_1024_D128, False)):
        q, k, v = ladder_inputs(shape, shape, f32, gen)
        times[f"naive_fp32_{tag}"] = device_ms(lambda: m.nv.naive_attention(q, k, v, causal=causal))
    for tag, shape in (("stream_n1024", SWEEP_1024), ("stream_n1024_d128", SWEEP_1024_D128),
                       ("folded_n128", SWEEP_128), ("folded_n128_d128", SWEEP_128_D128)):
        q, k, v = ladder_inputs(shape, shape, f32, gen)
        times[f"v1_fp32_{tag}"] = device_ms(lambda: m.fv.flash_attention_v1(q, k, v))
    for tag, shape_q, shape_kv, dtype in (("bf16_train", TRAIN_Q, TRAIN_KV, bf16),
                                          ("bf16_train_d128", TRAIN_D128_Q, TRAIN_D128_KV, bf16),
                                          ("fp32_n512", TRAIN_FP32_Q, TRAIN_FP32_KV, f32)):
        q, k, v = ladder_inputs(shape_q, shape_kv, dtype, gen)
        do = ladder_inputs(shape_q, shape_kv, dtype, gen)[0]
        off = torch.zeros((shape_q[0],), dtype=torch.int32, device="cuda")
        o, lse = ff.flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)
        delta = fb.bwd_delta(o, do, None)
        kw = dict(sm_scale=default_scale(q.shape[-1]), causal=True)
        times[f"dkv_{tag}"] = device_ms(
            lambda: fb.flash_bwd_dkv(q, k, v, do, lse, delta, off, **kw))
        times[f"dq_{tag}"] = device_ms(
            lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, off, **kw))
        times[f"fused_{tag}"] = device_ms(lambda: fb.flash_attention_bwd_fused(
            q, k, v, o, do, lse, off, q_offset_max=0, **kw))
    for tag, shape_q, shape_kv, dtype in (("bf16_train", TRAIN_Q, TRAIN_KV, bf16),
                                          ("bf16_d128", SPARSE_D128_Q, SPARSE_D128_KV, bf16),
                                          ("fp32_n512", TRAIN_FP32_Q, TRAIN_FP32_KV, f32)):
        from .verify import block_sparse_rung_mask

        n = shape_q[2]
        bm = m.fm.BlockMask(block_sparse_rung_mask(n), n, n, SPARSE_BLOCK, SPARSE_BLOCK)
        q, k, v = ladder_inputs(shape_q, shape_kv, dtype, gen)
        do = ladder_inputs(shape_q, shape_kv, dtype, gen)[0]
        kw = dict(sm_scale=_scale(q))
        o, lse = m.fm.flash_sparse_fwd(q, k, v, bm, save_lse=True, **kw)
        delta = fb.bwd_delta(o, do, None)
        times[f"sparse_fwd_{tag}"] = device_ms(
            lambda: m.fm.flash_sparse_fwd(q, k, v, bm, save_lse=True, **kw))
        times[f"sparse_dkv_{tag}"] = device_ms(
            lambda: m.fm.flash_sparse_dkv(q, k, v, do, lse, delta, bm, **kw))
        times[f"sparse_dq_{tag}"] = device_ms(
            lambda: m.fm.flash_sparse_dq(q, k, v, do, lse, delta, bm, **kw))
        if tag == "bf16_d128":  # the yardstick: SDPA's forward and backward, same mask
            times["sdpa_sparse_fwd_bwd_d128"] = sdpa_ms(q, k, v, mask=bm.dense("cuda"),
                                                        backward_of=do, with_forward=True)[0]
    nbytes = {}
    for tag, shape, dtype in (("bf16_b16h8n2048", HIGH_OCC, bf16), ("bf16_d128", TRI_D128, bf16),
                              ("fp32_n1024", LADDER, f32)):
        q, k, v = ladder_inputs(shape, shape, dtype, gen)
        do = ladder_inputs(shape, shape, dtype, gen)[0]
        times[f"tri_fwd_{tag}"] = device_ms(
            lambda: m.ft.flash_attention_tri(q, k, v, save_lse=True))
        o, lse = m.ft.flash_attention_tri(q, k, v, save_lse=True)
        times[f"tri_bwd_{tag}"] = device_ms(
            lambda: m.ft.flash_attention_bwd_tri(q, k, v, o, do, lse))
        if shape == HIGH_OCC:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            grads = m.ft.flash_attention_bwd_tri(q, k, v, o, do, lse)
            torch.cuda.synchronize()
            held = sum(t.numel() * t.element_size() for t in grads) + 4 * lse.numel()
            nbytes[f"tri_bwd_workspace_{tag}"] = torch.cuda.max_memory_allocated() - base - held
            del grads
    # The windowed kernels come last, so that every key both trees time
    # follows the same work on the card.
    if "window" in inspect.signature(ff.flash_fwd_general).parameters:
        win = dict(window=WINDOW, sinks=SINKS)
        for tag, shape_q, shape_kv in (("d64", TRAIN_Q, TRAIN_KV),
                                       ("d128", TRAIN_D128_Q, TRAIN_D128_KV)):
            q, k, v = ladder_inputs(shape_q, shape_kv, bf16, gen)
            do = ladder_inputs(shape_q, shape_kv, bf16, gen)[0]
            off = torch.zeros((shape_q[0],), dtype=torch.int32, device="cuda")
            o, lse = ff.flash_attention_fwd(q, k, v, off, causal=True, save_lse=True, **win)
            delta = fb.bwd_delta(o, do, None)
            kw = dict(sm_scale=default_scale(q.shape[-1]), causal=True)
            times[f"window_fwd_train_{tag}"] = device_ms(
                lambda: ff.flash_fwd_general(q, k, v, off, causal=True, save_lse=True, **win))
            times[f"window_dkv_train_{tag}"] = device_ms(
                lambda: fb.flash_bwd_dkv(q, k, v, do, lse, delta, off, **kw, **win))
            times[f"window_dq_train_{tag}"] = device_ms(
                lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, off, **kw, **win))
            times[f"window_fused_train_{tag}"] = device_ms(lambda: fb.flash_attention_bwd_fused(
                q, k, v, o, do, lse, off, q_offset_max=0, **kw, **win))
        for tag, shape_q, shape_kv in (("d64", DECODE_Q, DECODE_KV),
                                       ("d128", DECODE_D128_Q, DECODE_D128_KV)):
            q, k, v = ladder_inputs(shape_q, shape_kv, bf16, gen)
            times[f"window_fwd_decode_{tag}"] = device_ms(
                lambda: ff.flash_fwd_general(q, k, v, lengths, causal=True, pos_div=2, **win))
        cases = {**kv_cases(gen), **kv_d128_cases(gen)}
        for name in ("quant_int8_decode_bf16", "paged_decode_bf16",
                     "paged_quant_int8_decode_bf16"):
            for suffix in ("", "_d128"):
                kernel, args, pos_div = cases[name + suffix]
                times[f"window_{name.replace('_bf16', '')}{suffix or '_d64'}"] = device_ms(
                    lambda: kv_wrappers[kernel](*args, pos_div, **win))
        del cases
    # Then, in a tree whose wrappers take dropout, the dropout instances:
    # the general forward and the split pair at the training shape (bf16, D
    # 64 and 128) and at TRAIN_FP32_Q, at DROP_RATE, with the seed packed on
    # the card beforehand, so that no timed call copies it from the host.
    if "dropout_rate" in inspect.signature(ff.flash_fwd_general).parameters:
        d = ff.check_dropout(DROP_RATE, DROP_SEED, device="cuda")
        drop = dict(dropout_rate=DROP_RATE, dropout_seed=d.seed)
        for tag, shape_q, shape_kv, dtype in (("bf16_train", TRAIN_Q, TRAIN_KV, bf16),
                                              ("bf16_train_d128", TRAIN_D128_Q, TRAIN_D128_KV, bf16),
                                              ("fp32_n512", TRAIN_FP32_Q, TRAIN_FP32_KV, f32)):
            q, k, v = ladder_inputs(shape_q, shape_kv, dtype, gen)
            do = ladder_inputs(shape_q, shape_kv, dtype, gen)[0]
            off = torch.zeros((shape_q[0],), dtype=torch.int32, device="cuda")
            o, lse = ff.flash_fwd_general(q, k, v, off, causal=True, save_lse=True, **drop)
            delta = fb.bwd_delta(o, do, None)
            kw = dict(sm_scale=default_scale(q.shape[-1]), causal=True, drop=d)
            times[f"drop_fwd_{tag}"] = device_ms(
                lambda: ff.flash_fwd_general(q, k, v, off, causal=True, save_lse=True, **drop))
            times[f"drop_dkv_{tag}"] = device_ms(
                lambda: fb.flash_bwd_dkv(q, k, v, do, lse, delta, off, **kw))
            times[f"drop_dq_{tag}"] = device_ms(
                lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, off, **kw))
    return times, nbytes


def v1_tile_times(log=print) -> List[dict]:
    """Each V1 kernel's device ms at every Q-tile height it takes (fp32,
    the ladder fixture, non-causal), at every point of the benchmark's sweep
    (N = 128 .. 16384 at ``amortizing_batch(N)``, H = 1, D = 64) and at head
    dim 128 at N = 128 and 1024; with the height ``v1_tile_rows`` picks and
    each height's block count.  Heights whose block exceeds 227 KB of shared
    memory are left out."""
    from .benchmark import DEFAULT_SWEEP, amortizing_batch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    points = [(n, 64) for n in DEFAULT_SWEEP] + [(128, 128), (1024, 128)]
    out = []
    for n, d in points:
        b = amortizing_batch(n)
        route, fold = v1_route(b, n, n)
        q, k, v = ladder_inputs((b, 1, n, d), (b, 1, n, d), torch.float32, gen)
        kw = dict(sm_scale=default_scale(d), causal=False)
        heights = (64, 32, 16) if route == "folded" else (64, 32)
        ms = {}
        for rows in heights:
            if v1_smem_bytes(route, rows, n, d) > BLOCK_SMEM_MAX:
                continue
            if route == "folded":
                ms[rows] = device_ms(lambda: flash_v1_folded(q, k, v, fold, rows=rows, **kw))
            else:
                ms[rows] = device_ms(lambda: flash_v1_stream(q, k, v, rows=rows, **kw))
        rec = {"n": n, "b": b, "d": d, "route": route, "rule": v1_tile_rows(route, b, 1, n, n, d),
               "ms": ms, "blocks": {r: b * -(-n // r) for r in ms}}
        out.append(rec)
        log(json.dumps(rec))
        del q, k, v
    return out


SPLIT_CHUNKS = (64, 128, 192, 256, 384, 512, 768, 1024, 2048)


def decode_split_times(log=print) -> List[dict]:
    """Device ms of each decode kernel (``csrc/flash_decode.cuh``) at every
    chunk of ``SPLIT_CHUNKS`` (bf16, the ladder fixture): the quant (int8),
    paged and paged-quant (int8) kernels and the dense folded decode at the
    serving shape (``DECODE_Q`` over ``DECODE_KV``, D 64 and 128) at
    ``decode_lengths()`` and ``skewed_lengths()``, and the quant kernel at
    1 to 64 slots (``decode_lengths()`` from its 2046-long slot on,
    repeated); beside the chunk ``decode_kv_chunk`` picks.  A chunk is
    forced by standing in for ``decode_kv_chunk``; each time's blocks are
    the wrapper's ``.grid`` at its last launch."""
    from unittest import mock

    from ..kernels import flash_fwd as ff

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []

    def row(what, shape_q, n_kv, wrapper, call):
        b, h, n_q, _ = shape_q
        rule = ff.decode_kv_chunk(b, h, n_q, n_kv, sms)
        rec = {"case": what, "q": list(shape_q), "n_kv": n_kv, "rule": rule, "ms": {},
               "blocks": {}}
        for chunk in sorted({c for c in SPLIT_CHUNKS if c <= n_kv} | {rule}):
            with mock.patch.object(ff, "decode_kv_chunk", lambda *shape, c=chunk: c):
                rec["ms"][chunk] = device_ms(call)
            rec["blocks"][chunk] = wrapper.grid.blocks
        out.append(rec)
        log(json.dumps(rec))

    for lengths_name, lengths_np in (("decode_lengths", decode_lengths()),
                                     ("skewed", skewed_lengths())):
        lengths = torch.from_numpy(lengths_np).to("cuda")
        for shape_q, shape_kv in ((DECODE_Q, DECODE_KV), (DECODE_D128_Q, DECODE_D128_KV)):
            q, k, v = ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)
            b, _, n_kv, d = shape_kv
            perm, table, n_pages = paged_layout(b, n_kv, lengths, shape_q[2], 2, gen)
            qkv = quantize_kv(k, v, torch.int8)
            runs = {
                "flash_quant": (flash_attention_quant, (q, qkv, lengths)),
                "flash_paged": (flash_attention_paged, (
                    q, *(to_pages(x, perm, n_pages) for x in (k, v)), table, lengths)),
                "flash_paged_quant": (flash_attention_paged_quant, (q, *(
                    to_pages(x, perm, n_pages) for x in (qkv.k_q, qkv.v_q, qkv.k_scale,
                                                         qkv.v_scale)), table, lengths)),
            }
            for kernel, (wrapper, args) in runs.items():
                row(f"{kernel} d{d} {lengths_name}", shape_q, n_kv, wrapper,
                    lambda: KV_KERNELS[kernel][0](*args, 2))
            row(f"flash_fwd folded d{d} {lengths_name}", shape_q, n_kv, ff.flash_fwd_general,
                lambda: ff.flash_fwd_general(q, k, v, lengths, causal=True, pos_div=2))
            del q, k, v, qkv, runs
    for slots in (1, 2, 4, 16, 32, 64):
        shape_q, shape_kv = (slots,) + DECODE_Q[1:], (slots,) + DECODE_KV[1:]
        q, k, v = ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)
        lengths = torch.from_numpy(np.resize(np.roll(decode_lengths(), -1), slots)).to("cuda")
        qkv = quantize_kv(k, v, torch.int8)
        row(f"flash_quant d64, {slots} slots", shape_q, shape_kv[2], flash_attention_quant,
            lambda: KV_KERNELS["flash_quant"][0](q, qkv, lengths, 2))
        del q, k, v, qkv
    return out


# The verify windows ``fold_split_times`` sweeps: TinyLlama-1.1B's gamma 4 at
# group 8 (40 rows) at 1, 2, 8 and 32 slots, and group 2 at gamma 8.
FOLD_SPLIT_RUNS = ((40, 8, 1), (40, 8, 2), (40, 8, 8), (40, 8, 32), (18, 2, 8))


def fold_split_times(log=print) -> List[dict]:
    """Device ms of the folded grid (``csrc/flash_fold_sm90.cu``) at every
    chunk of ``SPLIT_CHUNKS`` (bf16 q, the ladder fixture, ``fold_lengths``)
    on the dense bf16, int8 and paged int8 caches at ``FOLD_SPLIT_RUNS``, D
    64 and 128, beside the chunk ``decode_kv_chunk`` picks.  A chunk is
    forced by standing in for ``decode_kv_chunk``; each time's blocks are
    the wrapper's ``.grid`` at its last launch."""
    from unittest import mock

    from ..kernels import flash_fwd as ff

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for n_q, pos_div, slots in FOLD_SPLIT_RUNS:
        for d in (64, 128):
            for fmt in ("bf16", "int8", "paged_int8"):
                kernel, args = fold_case(gen, n_q, pos_div, d, fmt, batch=slots)
                wrapper = FOLD_WRAPPERS[kernel]
                rule = ff.decode_kv_chunk(slots, FOLD_KV_HEADS, n_q, FOLD_N_KV, sms, True)
                rec = {"case": f"{kernel} {fmt} {n_q}x{pos_div} d{d}, {slots} slots",
                       "rule": rule, "ms": {}, "blocks": {}}
                for chunk in sorted(set(SPLIT_CHUNKS) | {rule}):
                    with mock.patch.object(ff, "decode_kv_chunk", lambda *shape, c=chunk: c):
                        rec["ms"][chunk] = device_ms(lambda: fold_call(kernel, args, pos_div))
                    rec["blocks"][chunk] = wrapper.grid.blocks
                out.append(rec)
                log(json.dumps(rec))
                del args
    return out


# Caps of the block-sparse dK/dV plan timed by ``sparse_splits``, in tile
# pairs a block walks (64 and more: no tile of rung 11's mask at N = 2048 is
# split at GQA 2).
SPARSE_CAPS = (4, 8, 12, 14, 16, 18, 20, 24, 32, 48, 56, 61, 64, 73)


def sparse_split_times(log=print) -> List[dict]:
    """Device ms of the bf16 block-sparse dK/dV kernel at every cap of
    ``SPARSE_CAPS`` under rung 11's mask (the ladder fixture), at the
    training shape and at ``SPARSE_D128_Q``, beside the cap
    ``dkv_chunk_cap`` picks; with the dQ kernel's time once per shape.  A
    cap is forced by standing in for ``dkv_chunk_cap``; each time's chunks
    and blocks are the wrapper's ``.grid`` at its last launch."""
    from unittest import mock

    from ..kernels import flash_mask as fm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bm = sparse_mask()
    out = []
    for shape_q, shape_kv in ((TRAIN_Q, TRAIN_KV), (SPARSE_D128_Q, SPARSE_D128_KV)):
        b, h, _, d = shape_q
        h_kv = shape_kv[1]
        q, k, v = ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)
        do = ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)[0]
        kw = dict(sm_scale=_scale(q))
        o, lse = fm.flash_sparse_fwd(q, k, v, bm, save_lse=True, **kw)
        delta = bwd_delta(o, do, None)
        rule = fm.dkv_chunk_cap(bm.kv_lengths, b, h_kv, h // h_kv, d, sms)
        rec = {"q": list(shape_q), "kv": list(shape_kv), "rule": rule, "ms": {}, "chunks": {},
               "blocks": {}}
        for cap in sorted(set(SPARSE_CAPS) | {rule}):
            with mock.patch.object(fm, "dkv_chunk_cap", lambda *shape, c=cap: c):
                rec["ms"][cap] = device_ms(
                    lambda: fm.flash_sparse_dkv(q, k, v, do, lse, delta, bm, **kw))
            rec["chunks"][cap] = fm.flash_sparse_dkv.grid.chunks
            rec["blocks"][cap] = fm.flash_sparse_dkv.grid.blocks
        rec["dq_ms"] = device_ms(lambda: fm.flash_sparse_dq(q, k, v, do, lse, delta, bm, **kw))
        out.append(rec)
        log(json.dumps(rec))
        del q, k, v, do, o, lse, delta
    return out


# Every unit of csrc/ (the same kernel compiles in each unit that includes
# its header, so each unit's instances are reported).
PTXAS_UNITS = ("flash_fwd.cu", "flash_bwd.cu", "flash_mask.cu", "flash_tri.cu", "flash_lean.cu",
               "flash_decode.cu", "flash_decode_int8.cu", "flash_decode_e4m3.cu",
               "flash_decode_e5m2.cu", "flash_kv_sm90.cu", "flash_fold_sm90.cu", "naive.cu",
               "flash_v1.cu")


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments, demangled with ``c++filt``
    when the toolkit's host has it (else the mangled name)."""
    filt = shutil.which("c++filt")
    if filt is None:
        return mangled
    name = subprocess.run([filt, mangled], capture_output=True, text=True).stdout.strip()
    name = re.sub(r"\(anonymous namespace\)::", "", name).split("(")[0]
    return name[len("void "):] if name.startswith("void ") else name


def parse_ptxas(unit: str, text: str) -> List[dict]:
    """Each kernel's registers, spill bytes and stack frame from the output
    of ``nvcc -Xptxas -v`` on ``unit``."""
    out = []
    for block in text.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        stack = re.search(r"(\d+) bytes stack frame", block)
        out.append({"unit": unit, "kernel": _kernel_name(mangled),
                    "registers": int(regs.group(1)),
                    "spill_stores": int(spill.group(1)) if spill else 0,
                    "spill_loads": int(spill.group(2)) if spill else 0,
                    "stack": int(stack.group(1)) if stack else 0})
    return out


def ptxas_report(csrc: Optional[str] = None) -> List[dict]:
    """``parse_ptxas`` of every unit of ``PTXAS_UNITS`` in this package's
    ``csrc/`` (or ``csrc``: those it has, so an older tree compiles too),
    compiled with the build's flags and ``-Xptxas -v``; one ``nvcc`` per
    unit, all started together."""
    from ..kernels import _build

    src = Path(csrc) if csrc else _build.CSRC
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    out = []
    with tempfile.TemporaryDirectory() as work:
        procs = [(unit, subprocess.Popen(
            [_build._nvcc(), *flags, "-Xptxas", "-v", "-I", str(src), "-c", "-o",
             str(Path(work) / f"{unit}.o"), str(src / unit)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for unit in PTXAS_UNITS if (src / unit).exists()]
        for unit, proc in procs:
            text = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src / unit}:\n{text}")
            out += parse_ptxas(unit, text)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("sweep", "profile", "kernels", "v1_tiles",
                                         "decode_splits", "sparse_splits", "ptxas"))
    parser.add_argument("target", nargs="?", choices=("serving", "train"), default="serving")
    parser.add_argument("--mode", choices=sorted(serving.SERVING_MODES), default="dense",
                        help="the KV cache the serving profile decodes from")
    parser.add_argument("--csrc", help="kernels: time the wrappers and kernels of the tree "
                        "whose package holds this csrc/ directory; ptxas: compile its sources")
    args = parser.parse_args(argv)
    if args.what == "ptxas":
        for rec in ptxas_report(args.csrc):
            print(json.dumps({"csrc": args.csrc or "package", **rec}))
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    stamp = serving.nvidia_smi_line()
    if args.what == "kernels":
        ms, nbytes = kernel_times(args.csrc)
        print(json.dumps({"csrc": args.csrc or "package", "card": stamp, "ms": ms,
                          "bytes": nbytes}))
        return 0
    if args.what == "sweep":
        sweep(stamp)
        return 0
    if args.what == "decode_splits":
        print(f"[decode_splits] {stamp}")
        decode_split_times(log=lambda line: print(f"[decode_splits] {line}"))
        fold_split_times(log=lambda line: print(f"[decode_splits] {line}"))
        return 0
    if args.what == "sparse_splits":
        print(f"[sparse_splits] {stamp}")
        sparse_split_times(log=lambda line: print(f"[sparse_splits] {line}"))
        return 0
    if args.what == "v1_tiles":
        print(f"[v1_tiles] {stamp}")
        v1_tile_times(log=lambda line: print(f"[v1_tiles] {line}"))
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
