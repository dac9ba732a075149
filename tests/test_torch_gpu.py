"""PyTorch port on the card: the CUDA kernels against their plain versions.

Every test here needs an NVIDIA GPU and skips without one (the CUDA kernels
have no CPU mode).  The file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import ctypes
import dataclasses
import json
import math
import re

import numpy as np
import pytest
import torch

from flash_attention_metal_tpu_torch import bench, flash_attention
from flash_attention_metal_tpu_torch.harness import autotune, onchip, serving
from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels import flash_mask as fm
from flash_attention_metal_tpu_torch.kernels import flash_tri as ft
from flash_attention_metal_tpu_torch.kernels import flash_v1 as fv
from flash_attention_metal_tpu_torch.kernels import naive as nv
from flash_attention_metal_tpu_torch.kernels import paged as pg
from flash_attention_metal_tpu_torch.kernels import quant as qt
from flash_attention_metal_tpu_torch.kernels.flash_mxu import flash_attention_mxu
from flash_attention_metal_tpu_torch.kernels.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from flash_attention_metal_tpu_torch.models import transformer as tf
from flash_attention_metal_tpu_torch.runtime import decode as dec
from flash_attention_metal_tpu_torch.runtime import kv_cache as kv

# Kernel against its fp32 plain version: the tolerances chip_smoke.py holds.
TOL = onchip.TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _uniform(rng, shape, device, dtype, scale=1.0):
    x = rng.uniform(-1, 1, shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(device, dtype)


# Units a unit's library needs beside it: flash_fwd.cu's entries launch the
# decode grid's instances (one unit per KV element type); flash_lean.cu's
# fp32 entry calls the dense template of flash_fwd.cu; flash_tri.cu's fp32
# entries call that template and the fused backward's entry in flash_bwd.cu.
_DECODE_UNITS = onchip.DECODE_UNITS
_COMPANIONS = {"flash_fwd.cu": _DECODE_UNITS,
               "flash_lean.cu": ("flash_fwd.cu", *_DECODE_UNITS),
               "flash_tri.cu": ("flash_fwd.cu", "flash_bwd.cu", *_DECODE_UNITS)}


def _planted_library(tmp_path, unit: str, source: str, old: str, new: str) -> ctypes.CDLL:
    """``csrc/<unit>`` (with its companions) built from a copy of ``csrc/``
    in which one fault is planted in ``<source>``: the unit itself or a
    header it includes, directly or through another header."""
    units = (unit, *_COMPANIONS.get(unit, ()))
    return ctypes.CDLL(str(onchip.build_planted(str(tmp_path), [(source, old, new)], units)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "case",
    [
        # ragged n_q and n_kv (not multiples of the 64 tile), GQA 2
        dict(b=2, hq=4, hkv=2, n_q=130, n_kv=300, off=[0, 170], pos_div=1, causal=True),
        dict(b=2, hq=4, hkv=2, n_q=130, n_kv=300, off=[0, 0], pos_div=1, causal=False),
        # folded decode, group 4, offsets at both ends of the cache
        dict(b=3, hq=2, hkv=2, n_q=4, n_kv=256, off=[0, 255, 97], pos_div=4, causal=True),
        # rows that see nothing: o = 0, lse = -inf
        dict(b=1, hq=2, hkv=1, n_q=128, n_kv=128, off=[-70], pos_div=1, causal=True),
        # peaked softmax over 5 KV tiles: the running max rises across tiles
        dict(b=2, hq=4, hkv=2, n_q=130, n_kv=300, off=[0, 170], pos_div=1, causal=True,
             q_scale=onchip.PEAKED_Q_SCALE),
        # the decode grid's 16-row tile (group 8), a ragged row in 16 splits
        # of one tile, peaked
        dict(b=2, hq=2, hkv=2, n_q=8, n_kv=1000, off=[0, 999], pos_div=8, causal=True,
             q_scale=onchip.PEAKED_Q_SCALE),
        # one decode token of 4 q-heads unfolded, non-causal (every column)
        dict(b=2, hq=4, hkv=2, n_q=1, n_kv=700, off=[0, 0], pos_div=1, causal=False),
    ],
    ids=["prefill_ragged", "non_causal", "decode_fold4", "masked_rows", "prefill_peaked",
         "decode_fold8_ragged", "decode_one_row_non_causal"],
)
def test_kernel_matches_plain(cuda, dtype, case):
    rng = np.random.default_rng(0)
    q = _uniform(rng, (case["b"], case["hq"], case["n_q"], 64), cuda, dtype,
                 case.get("q_scale", 1.0))
    k = _uniform(rng, (case["b"], case["hkv"], case["n_kv"], 64), cuda, dtype)
    v = _uniform(rng, (case["b"], case["hkv"], case["n_kv"], 64), cuda, dtype)
    off = torch.tensor(case["off"], dtype=torch.int32, device=cuda)
    kw = dict(causal=case["causal"], pos_div=case["pos_div"], save_lse=True)
    before = ff.flash_fwd_general.launches
    o, lse = flash_attention_fwd(q, k, v, off, **kw)
    assert ff.flash_fwd_general.launches == before + 1
    o_p, lse_p = flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), off, sm_scale=0.125, **kw
    )
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    assert float((o.float() - o_p).abs().max()) <= TOL[dtype]
    finite = torch.isfinite(lse_p)
    assert torch.equal(finite, torch.isfinite(lse))
    assert float((lse[finite] - lse_p[finite]).abs().max()) <= TOL[dtype]


# Faults planted in a copy of csrc/: (source, the path_cases whose output
# alone must fail, text, replacement).  Folded decode runs the split-KV
# grid of flash_decode.cuh; fp32 prefill runs flash_fwd.cu's 64-row
# template (bf16 prefill runs the wgmma kernel).
PLANTED_FAULTS = {
    # o and l are not rescaled when the running max rises between KV tiles
    "no_rescale": ("flash_decode.cuh", ("decode_bf16_peaked",),
                   "alpha[r] = m[r] == -INFINITY ? 0.0f : exp2f(m[r] - m_new);",
                   "alpha[r] = 1.0f;"),
    # each split stops one tile before the last column it should walk
    "last_tile_dropped": ("flash_decode.cuh", ("decode_bf16_peaked",),
                          "(kv_end - kv_begin - 1) / kBlockN + 1;",
                          "(kv_end - kv_begin - 1) / kBlockN;"),
    "template_no_rescale": ("flash_fwd.cu", ("prefill_fp32_off512",),
                            "const float alpha = exp2f(m_i - m_new);", "const float alpha = 1.0f;"),
    "template_last_tile_dropped": ("flash_fwd.cu", ("prefill_fp32_off512",),
                                   "tile_limit / kBlockN + 1", "tile_limit / kBlockN"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_planted_kernel_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's kernel check passes the kernels as built and fails a
    copy with a planted fault on the cases that run the planted code: the
    decode grid's on folded decode (the ladder fixture and the peaked one),
    the template's on fp32 prefill.  The errors of o and lse are printed
    too (``-s``)."""
    source, failing, old, new = PLANTED_FAULTS[fault]
    lib = ff.bind(_planted_library(tmp_path, "flash_fwd.cu", source, old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.path_cases(gen)
    names = ("decode_bf16",) + failing if source == "flash_decode.cuh" else failing
    clean = {n: onchip.kernel_error(cases[n]) for n in names}
    monkeypatch.setattr(ff, "_lib", lambda: lib)
    faulty = {n: onchip.kernel_error(cases[n]) for n in names}
    print(f"\n{fault}, (o, lse) max-abs error, built -> planted:\n" + "\n".join(
        f"  {n}: o {clean[n][0]:.3e} -> {faulty[n][0]:.3e}, "
        f"lse {clean[n][1]:.3e} -> {faulty[n][1]:.3e}" for n in names))
    for name in names:
        assert max(clean[name]) <= TOL[cases[name][0].dtype]
    # The output alone fails, not only the lse.
    for name in failing:
        assert faulty[name][0] > TOL[cases[name][0].dtype], name


# The wgmma forward (csrc/flash_fwd_sm90.cuh): bf16 general calls with
# pos_div 1 and bf16 lean calls.  General: (q shape, kv shape, per-batch
# offsets, causal) with ragged n_q = 1000, n_kv != n_q, GQA 1 and 2, rows
# and a whole batch that see nothing.
SM90_GENERAL_CASES = {
    "ragged1000_gqa1": ((2, 4, 1000), (2, 4, 1000), [0, 0], True),
    "ragged1000_gqa2_kv1300": ((2, 4, 1000), (2, 2, 1300), [300, -40], True),
    "non_causal_gqa2_kv700": ((2, 4, 1000), (2, 2, 700), [0, 0], False),
    "batch_sees_nothing": ((2, 2, 128), (2, 1, 128), [-200, 10], True),
}
# Lean: (q shape, kv shape, the wrapper's keywords) with an int offset 0,
# positive or negative; the sweep's points N = 1024 and N = 128 (B 512).
SM90_LEAN_CASES = {
    "n1024": ((8, 1, 1024), (8, 1, 1024), dict()),
    "n128_b512": ((512, 1, 128), (512, 1, 128), dict()),
    "non_causal_gqa2_kv300": ((2, 4, 130), (2, 2, 300), dict()),
    "ragged1000_gqa2_off0": ((2, 4, 1000), (2, 2, 1000), dict(causal=True, q_offset=0)),
    "gqa1_off100": ((2, 2, 900), (2, 2, 1000), dict(causal=True, q_offset=100)),
    "off_minus70": ((1, 2, 128), (1, 2, 128), dict(causal=True, q_offset=-70)),
}


def _fixture_inputs(shape_q, shape_kv, fixture, gen):
    if fixture == "spike":
        return onchip.spike_inputs(shape_q, shape_kv, torch.bfloat16, gen, col=shape_kv[2] // 2)
    scale = onchip.PEAKED_Q_SCALE if fixture == "peaked" else 1.0
    return onchip.ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("fixture", ["ladder", "peaked", "spike"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("case", sorted(SM90_GENERAL_CASES) + sorted(SM90_LEAN_CASES))
def test_wgmma_forward_matches_plain(cuda, case, head_dim, fixture):
    """The wgmma forward through ``flash_fwd_general`` and ``flash_fwd_lean``
    (one launch each) against its plain version within 1e-2 (o and lse),
    and two runs bitwise equal."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if case in SM90_GENERAL_CASES:
        shape_q, shape_kv, offsets, causal = SM90_GENERAL_CASES[case]
        wrapper = ff.flash_fwd_general
        off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
        kw = dict(causal=causal, save_lse=True)
        q, k, v = _fixture_inputs((*shape_q, head_dim), (*shape_kv, head_dim), fixture, gen)
        run = lambda: wrapper(q, k, v, off, **kw)  # noqa: E731
        want = flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), off, sm_scale=head_dim ** -0.5, **kw)
    else:
        shape_q, shape_kv, kw = SM90_LEAN_CASES[case]
        wrapper = ff.flash_fwd_lean
        q, k, v = _fixture_inputs((*shape_q, head_dim), (*shape_kv, head_dim), fixture, gen)
        run = lambda: wrapper(q, k, v, save_lse=True, **kw)  # noqa: E731
        want = onchip.LADDER_FWD_KERNELS["flash_lean"][1](
            q.float(), k.float(), v.float(), save_lse=True, **kw)
    before = wrapper.launches
    got = run()
    assert wrapper.launches == before + 1
    err, lse_err = onchip._fwd_errors(got, want)
    assert err <= TOL[torch.bfloat16] and lse_err <= TOL[torch.bfloat16], (err, lse_err)
    again = run()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def _sm90_fwd_cases(gen):
    """chip_smoke.py's prefill cases and the training shape's forward (bf16
    ladder, peaked and spike fixtures), as ``path_cases`` entries."""
    cases = onchip.path_cases(gen)
    out = {n: cases[n] for n in ("prefill_bf16_off512", "prefill_bf16_off512_peaked")}
    for name, (q, k, v, _, off) in onchip.train_cases(gen).items():
        if "bf16" in name:
            out[name] = (q, k, v, off, 1)
    return out


# Faults planted in a copy of csrc/flash_fwd_sm90.cuh (built into
# flash_fwd.cu): (text, replacement).
PLANTED_SM90_FWD_FAULTS = {
    # o and l are not rescaled when the running max rises between KV tiles
    "no_rescale": ("alpha[half] = exp2f(m_i[half] - m_ref[half]);", "alpha[half] = 1.0f;"),
    # the KV walk stops one tile before the last visible column
    "walk_one_tile_short": ("limit < 0 ? 0 : limit / kTile + 1;", "limit < 0 ? 0 : limit / kTile;"),
    # the diagonal tile treated as interior: no visibility compare on it
    "diagonal_unmasked": ("const bool full = kv_start + kTile - 1 <= q_start + off &&",
                          "const bool full = kv_start <= q_start + off &&"),
    # 16-byte chunks 1 and 2 of row 5 of every swizzled K tile stored at
    # each other's address: a permutation, every slot written
    "k_chunk_misplaced": (
        "    load_tile<D, kTile>(sm.k[j % kStages], k + (kv_rows + kv_start) * D, n_kv - kv_start);",
        "    for (int x = threadIdx.x; x < kTile * D / 8; x += kThreads) {\n"
        "      const int r = x / (D / 8), c = x % (D / 8);\n"
        "      const bool ok = r < n_kv - kv_start;\n"
        "      cp_async16(sm.k[j % kStages] + swz<kTile>(r, r == 5 && (c == 1 || c == 2) ? 3 - c : c),\n"
        "                 k + (kv_rows + kv_start + (ok ? r : 0)) * D + (ok ? c * 8 : 0), ok);\n"
        "    }"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_SM90_FWD_FAULTS))
def test_planted_wgmma_forward_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's forward check on the prefill and training-shape cases
    passes the wgmma kernel as built and fails a copy with a planted fault:
    finite output errors above the bound (errors printed with ``-s``)."""
    old, new = PLANTED_SM90_FWD_FAULTS[fault]
    lib = ff.bind(_planted_library(tmp_path, "flash_fwd.cu", "flash_fwd_sm90.cuh", old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = _sm90_fwd_cases(gen)
    clean = {n: onchip.kernel_error(c) for n, c in cases.items()}
    monkeypatch.setattr(ff, "_lib", lambda: lib)
    faulty = {n: onchip.kernel_error(c) for n, c in cases.items()}
    print(f"\n{fault}, (o, lse) max-abs error, built -> planted:\n" + "\n".join(
        f"  {n}: o {clean[n][0]:.3e} -> {faulty[n][0]:.3e}, "
        f"lse {clean[n][1]:.3e} -> {faulty[n][1]:.3e}" for n in cases))
    tol = TOL[torch.bfloat16]
    for name in cases:
        assert max(clean[name]) <= tol
    planted = [faulty[n][0] for n in cases]
    assert all(math.isfinite(e) for e in planted) and max(planted) > tol, planted


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ff.flash_fwd_general(q, q, q, causal=True)
    q = torch.zeros((1, 2, 8, 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ff.flash_fwd_general(q, q, q, causal=True)
    q = torch.zeros((1, 2, 64, 8), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ff.flash_fwd_general(q, q, q, causal=True)


@pytest.mark.gpu
def test_served_logits_cuda_match_cpu(cuda):
    """Prefill + cached decode in fp32 on the card equal the same steps on
    the CPU (plain attention) within fp32 rounding."""
    eng, cfg = serving.build_engine(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256,
        max_batch=2, max_len=256, dtype=torch.float32, device="cpu",
    )
    prompt = torch.arange(1, 41, dtype=torch.int32)
    padded = torch.zeros(128, dtype=torch.int32)
    padded[:40] = prompt
    outs = {}
    for dev in ("cpu", "cuda"):
        params = {
            "embed": eng.params["embed"].to(dev),
            "final_norm": eng.params["final_norm"].to(dev),
            "lm_head": eng.params["lm_head"].to(dev),
            "layers": [{n: w.to(dev) for n, w in layer.items()} for layer in eng.params["layers"]],
        }
        cache = kv.init_cache(2, 2, 2, 256, 64, torch.float32, device=dev)
        logits, cache = dec.prefill_slot(params, cfg, cache, padded.to(dev), 40, 1)
        steps = [logits]
        active = torch.tensor([False, True], device=dev)
        for t in range(6):
            tok = torch.tensor([0, 7 + t], dtype=torch.int32, device=dev)
            logits, cache = dec.decode_step(params, cfg, cache, tok, active)
            steps.append(logits[1])
        outs[dev] = torch.stack(steps).cpu()
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) < 1e-3


# ---------------------------------------------------------------------------
# Backward kernels (csrc/flash_bwd.cu) and the training path.
# ---------------------------------------------------------------------------

BWD_TOL = onchip.BWD_TOL


def _bwd_errors(got, want):
    return {
        name: float((g.float() - w).abs().max() / w.abs().max())
        for name, g, w in zip(("dq", "dk", "dv"), got, want)
    }


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "case",
    [
        # ragged n_q and n_kv, GQA 2, per-batch offsets
        dict(b=2, hq=4, hkv=2, n_q=130, n_kv=300, off=[0, 170], causal=True),
        dict(b=2, hq=4, hkv=2, n_q=130, n_kv=300, off=[0, 0], causal=False),
        # GQA 4 (the dK/dV block walks four q-heads)
        dict(b=1, hq=8, hkv=2, n_q=256, n_kv=256, off=[0], causal=True),
        # rows that see nothing (lse = -inf): zero gradients, no NaN
        dict(b=1, hq=2, hkv=1, n_q=128, n_kv=128, off=[-70], causal=True),
        # peaked softmax over several tiles
        dict(b=2, hq=4, hkv=2, n_q=256, n_kv=256, off=[0, 0], causal=True,
             q_scale=onchip.PEAKED_Q_SCALE),
        # ragged n_q = 1000 (a partial Q step and tile), GQA 1
        dict(b=2, hq=4, hkv=4, n_q=1000, n_kv=1000, off=[0, 0], causal=True),
        # head dim 128: n_kv != n_q with per-batch offsets (one row block
        # masked), GQA 1 non-causal, fully masked rows, peaked, spike
        dict(b=2, hq=4, hkv=2, n_q=1000, n_kv=1300, off=[300, -40], causal=True, d=128),
        dict(b=2, hq=4, hkv=4, n_q=1000, n_kv=1000, off=[0, 0], causal=False, d=128),
        dict(b=1, hq=2, hkv=1, n_q=128, n_kv=128, off=[-70], causal=True, d=128),
        dict(b=2, hq=4, hkv=2, n_q=256, n_kv=256, off=[0, 0], causal=True, d=128,
             q_scale=onchip.PEAKED_Q_SCALE),
        dict(b=2, hq=4, hkv=2, n_q=1000, n_kv=1000, off=[0, 0], causal=True, d=128,
             spike=True),
    ],
    ids=["ragged_gqa2", "non_causal", "gqa4", "masked_rows", "peaked", "gqa1_n1000",
         "d128_ragged_offsets", "d128_non_causal_gqa1", "d128_masked_rows", "d128_peaked",
         "d128_spike"],
)
def test_bwd_kernels_match_plain(cuda, dtype, case):
    """The split pair (bf16: the Hopper kernels of flash_bwd_sm90.cuh; fp32:
    the FMA template) against its plain version, one launch each."""
    rng = np.random.default_rng(0)
    d = case.get("d", 64)
    shape_q, shape_kv = (case["b"], case["hq"], case["n_q"], d), (case["b"], case["hkv"], case["n_kv"], d)
    if case.get("spike"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        q, k, v = onchip.spike_inputs(shape_q, shape_kv, dtype, gen, col=case["n_kv"] // 2)
    else:
        q = _uniform(rng, shape_q, cuda, dtype, case.get("q_scale", 1.0))
        k = _uniform(rng, shape_kv, cuda, dtype)
        v = _uniform(rng, shape_kv, cuda, dtype)
    do = _uniform(rng, q.shape, cuda, dtype)
    dlse = _uniform(rng, q.shape[:3], cuda, torch.float32)
    off = torch.tensor(case["off"], dtype=torch.int32, device=cuda)
    causal = case["causal"]
    o, lse = flash_attention_fwd(q, k, v, off, causal=causal, save_lse=True)
    before = (fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches)
    sm_scale = d ** -0.5
    got = fb.flash_attention_bwd(q, k, v, o, do, lse, off, dlse, sm_scale=sm_scale, causal=causal)
    assert (fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    want = fb.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), do.float(), lse, off, dlse,
        sm_scale=sm_scale, causal=causal,
    )
    torch.cuda.synchronize()
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape and bool(torch.isfinite(g).all())
    errors = _bwd_errors(got, want)
    assert max(errors.values()) <= BWD_TOL[dtype], errors
    if min(case["off"]) < 0:
        rows = -min(case["off"])
        assert torch.all(got[0][case["off"].index(-rows), :, :rows] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
def test_bwd_kernels_are_deterministic(cuda, head_dim):
    """Each output tile has one owner block and a fixed summation order:
    two runs give bit-identical gradients (the training shape, peaked)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    case = onchip.train_cases(gen)["train_bf16_peaked"]
    if head_dim == 128:
        shape_q, shape_kv = onchip.TRAIN_D128_Q, onchip.TRAIN_D128_KV
        q, k, v = onchip.ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen, onchip.PEAKED_Q_SCALE)
        case = (q, k, v, onchip.ladder_inputs(shape_q, shape_kv, torch.bfloat16, gen)[0], case[4])
    q, k, v, o, do, lse, off = onchip.bwd_inputs(case)
    first = fb.flash_attention_bwd(q, k, v, o, do, lse, off, causal=True)
    second = fb.flash_attention_bwd(q, k, v, o, do, lse, off, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# Faults planted in a copy of csrc/flash_bwd_sm90.cuh, the bf16 split pair
# (built into flash_bwd.cu), or of the tile helpers it includes,
# csrc/sm90_tiles.cuh (source ":tiles"): (text, replacement[, source]).
PLANTED_BWD_FAULTS = {
    # the dQ walk stops one KV tile short: the diagonal tile is left out
    "dq_walk_one_tile_short": ("limit < 0 ? 0 : limit / kTile + 1;", "limit < 0 ? 0 : limit / kTile;"),
    # the dK/dV walk starts one Q step late: its first visible Q tile is skipped
    "dkv_first_q_tile_skipped": ("max(0, kv_start - off) / kRows;",
                                 "max(0, kv_start - off) / kRows + 1;"),
    # the dK/dV block walks only its group's first q-head: dK and dV miss the
    # other q-heads' terms (the training shape is GQA 2)
    "first_head_only": ("n_steps = group * per_head;", "n_steps = per_head;"),
    # dS^T = P^T * dP^T: delta not subtracted
    "delta_not_subtracted": ("dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt[e & 1]);",
                             "dpt[4 * j + e] = p * dpt[4 * j + e];"),
    # 16-byte chunks 1 and 2 of row 5 of every swizzled tile stored at each
    # other's address: every slot is written, with finite data
    "swizzled_chunk_misplaced": (
        "cp_async16(dst + swz<kRows>(r, c), src",
        "cp_async16(dst + swz<kRows>(r, r == 5 && (c == 1 || c == 2) ? 3 - c : c), src",
        ":tiles"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_BWD_FAULTS))
def test_planted_bwd_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's backward check at the training shape passes the
    kernels as built and fails a copy with a planted fault (errors printed
    with ``-s``)."""
    old, new, *where = PLANTED_BWD_FAULTS[fault]
    source = "sm90_tiles.cuh" if where == [":tiles"] else "flash_bwd_sm90.cuh"
    lib = fb.bind(_planted_library(tmp_path, "flash_bwd.cu", source, old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.train_cases(gen)
    names = ("train_bf16", "train_bf16_peaked")
    inputs = {n: onchip.bwd_inputs(cases[n]) for n in names}
    clean = {n: onchip.bwd_kernel_errors(inputs[n]) for n in names}
    monkeypatch.setattr(fb, "_lib", lambda: lib)
    faulty = {n: onchip.bwd_kernel_errors(inputs[n]) for n in names}
    print(f"\n{fault}, (dq, dk, dv) normalised max-abs error, built -> planted:\n" + "\n".join(
        f"  {n}: " + ", ".join(f"{g} {clean[n][g][1]:.3e} -> {faulty[n][g][1]:.3e}" for g in clean[n])
        for n in names))
    tol = BWD_TOL[torch.bfloat16]
    for name in names:
        assert all(rel <= tol for _, rel in clean[name].values())
        planted = [rel for _, rel in faulty[name].values()]
        # a wrong but finite answer, above the bound
        assert all(math.isfinite(rel) for rel in planted) and max(planted) > tol, planted


@pytest.mark.gpu
def test_bwd_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 64, 64), device=cuda)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(NotImplementedError):
        fb.flash_attention_bwd(q, q, q, q, q, lse, causal=True, pos_div=2)
    # The softcap and dropout are the split pair's now (the transformed
    # kernels' checks: test_xf_*, dropout's: test_drop_*); the fused
    # backward refuses dropout, and dropout needs its seed.
    assert len(fb.flash_attention_bwd(q, q, q, q, q, lse, causal=True, softcap=30.0)) == 3
    assert len(fb.flash_attention_bwd(q, q, q, q, q, lse, causal=True, dropout_rate=0.1,
                                      dropout_seed=3)) == 3
    with pytest.raises(NotImplementedError, match="dropout"):
        fb.flash_attention_bwd_fused(q, q, q, q, q, lse, causal=True, dropout_rate=0.1,
                                     dropout_seed=3)
    with pytest.raises(ValueError, match="dropout_seed"):
        fb.flash_attention_bwd(q, q, q, q, q, lse, causal=True, dropout_rate=0.1)
    with pytest.raises(ValueError, match="causal"):
        fb.flash_attention_bwd(q, q, q, q, q, lse, causal=False, window=16)
    with pytest.raises(ValueError, match="lse"):
        fb.flash_attention_bwd(q, q, q, q, q, lse.double(), causal=True)


@pytest.mark.gpu
def test_training_on_cuda_matches_cpu_and_counts_launches(cuda):
    """A small fp32 model: the loss and every gradient on the card (the
    three kernels) equal the CPU's (plain versions), and one step under
    remat launches fwd 2L, dK/dV L and dQ L times."""
    cfg = tf.ModelConfig(
        vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256,
        dtype=torch.float32,
    )
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, master_dtype=torch.float32)
    tokens = torch.randint(0, 256, (2, 192), generator=gen)
    loss_cpu, g_cpu = tf.value_and_grad(tf.loss_fn, params, tokens, cfg)
    params_cuda = tf.map_params(lambda p: p.to(cuda), params)
    counts = (ff.flash_fwd_general.launches, fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches)
    loss_gpu, g_gpu = tf.value_and_grad(tf.loss_fn, params_cuda, tokens.to(cuda), cfg)
    after = (ff.flash_fwd_general.launches, fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches)
    assert tuple(a - b for a, b in zip(after, counts)) == (4, 2, 2)
    assert abs(float(loss_gpu) - float(loss_cpu)) < 1e-4
    for a, b in zip(tf.param_leaves(g_gpu), tf.param_leaves(g_cpu)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


# ---------------------------------------------------------------------------
# The kernel ladder's kernels: naive (csrc/naive.cu), lean
# (csrc/flash_lean.cu), triangular forward and backward (csrc/flash_tri.cu:
# the wgmma forward and the fused backward given one int offset).
# ---------------------------------------------------------------------------

# (kernel, q shape, kv shape, the wrapper's keywords): ragged lengths (not
# multiples of the 64 tile), GQA 2, static offsets 0, > 0 and < 0 (rows and
# whole tiles that see nothing).
LADDER_FWD_CASES = {
    "naive_causal": ("naive", (2, 2, 300, 64), (2, 2, 300, 64), dict(causal=True)),
    "naive_ragged": ("naive", (2, 2, 130, 64), (2, 2, 257, 64), dict()),
    "naive_causal_kv_longer": ("naive", (1, 2, 64, 64), (1, 2, 100, 64), dict(causal=True)),
    # rows 0-169 see no column: mean(V), and whole Q tiles walk all of K
    "naive_causal_q_longer": ("naive", (2, 2, 300, 64), (2, 2, 130, 64), dict(causal=True)),
    "lean_gqa": ("flash_lean", (2, 4, 130, 64), (2, 2, 300, 64), dict(save_lse=True)),
    "lean_causal_off170": ("flash_lean", (2, 4, 130, 64), (2, 2, 300, 64),
                           dict(causal=True, q_offset=170, save_lse=True)),
    "lean_longest_row": ("flash_lean", (1, 2, 64, 64), (1, 2, 1024, 64), dict(save_lse=True)),
    "lean_masked_rows": ("flash_lean", (1, 2, 128, 64), (1, 2, 128, 64),
                         dict(causal=True, q_offset=-70, save_lse=True)),
    "tri_gqa_off170": ("flash_tri", (2, 4, 130, 64), (2, 2, 300, 64),
                       dict(q_offset=170, save_lse=True)),
    "tri_square": ("flash_tri", (1, 2, 256, 64), (1, 2, 256, 64), dict(save_lse=True)),
    "tri_masked_rows": ("flash_tri", (1, 2, 200, 64), (1, 2, 128, 64),
                        dict(q_offset=-70, save_lse=True)),
    # Q tiles 0 and 1 see nothing, tile 2 in part (skipped walks, a
    # mixed tile); every row sees every column; head dim 128
    "tri_q_longer_off_neg170": ("flash_tri", (2, 4, 300, 64), (2, 2, 130, 64),
                                dict(q_offset=-170, save_lse=True)),
    "tri_gqa_off_max": ("flash_tri", (2, 4, 130, 64), (2, 2, 300, 64),
                        dict(q_offset=299, save_lse=True)),
    "tri_d128_off100": ("flash_tri", (1, 2, 200, 128), (1, 2, 300, 128),
                        dict(q_offset=100, save_lse=True)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("q_scale", [1.0, onchip.PEAKED_Q_SCALE], ids=["ladder", "peaked"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(LADDER_FWD_CASES))
def test_ladder_kernel_matches_plain(cuda, case, dtype, q_scale):
    kernel, shape_q, shape_kv, kw = LADDER_FWD_CASES[case]
    rng = np.random.default_rng(0)
    q = _uniform(rng, shape_q, cuda, dtype, q_scale)
    k = _uniform(rng, shape_kv, cuda, dtype)
    v = _uniform(rng, shape_kv, cuda, dtype)
    wrapper = onchip.LADDER_FWD_KERNELS[kernel][0]
    before = wrapper.launches
    err, lse_err = onchip.ladder_fwd_error(kernel, (q, k, v), kw)
    assert wrapper.launches == before + 1
    assert err <= TOL[dtype] and lse_err <= TOL[dtype], (err, lse_err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "case",
    [
        # ragged, offset 170, with an lse cotangent
        dict(shape_q=(2, 4, 130, 64), shape_kv=(2, 4, 300, 64), off=170, dlse=True),
        dict(shape_q=(1, 2, 256, 64), shape_kv=(1, 2, 256, 64), off=0, dlse=False),
        # rows and a whole tile that see nothing: zero gradients, no NaN
        dict(shape_q=(1, 2, 200, 64), shape_kv=(1, 2, 128, 64), off=-70, dlse=False),
        dict(shape_q=(2, 4, 256, 64), shape_kv=(2, 4, 256, 64), off=0, dlse=True,
             q_scale=onchip.PEAKED_Q_SCALE),
        # whole Q steps with no column: KV tile 0 zeroes their dQ rows
        dict(shape_q=(2, 2, 300, 64), shape_kv=(2, 2, 130, 64), off=-170, dlse=True),
        # every row sees every column
        dict(shape_q=(2, 2, 130, 64), shape_kv=(2, 2, 300, 64), off=299, dlse=False),
        dict(shape_q=(1, 2, 200, 128), shape_kv=(1, 2, 300, 128), off=100, dlse=True),
    ],
    ids=["ragged_off170_dlse", "square", "masked_rows", "peaked", "q_longer_off_neg170",
         "off_max", "d128_off100"],
)
def test_tri_bwd_matches_plain(cuda, dtype, case):
    rng = np.random.default_rng(0)
    q = _uniform(rng, case["shape_q"], cuda, dtype, case.get("q_scale", 1.0))
    k = _uniform(rng, case["shape_kv"], cuda, dtype)
    v = _uniform(rng, case["shape_kv"], cuda, dtype)
    do = _uniform(rng, q.shape, cuda, dtype)
    dlse = _uniform(rng, q.shape[:3], cuda, torch.float32) if case["dlse"] else None
    off = case["off"]
    o, lse = ft.flash_attention_tri(q, k, v, q_offset=off, save_lse=True)
    before = ft.flash_attention_bwd_tri.launches
    got = ft.flash_attention_bwd_tri(q, k, v, o, do, lse, dlse, q_offset=off)
    assert ft.flash_attention_bwd_tri.launches == before + 1
    want = ft.flash_attention_bwd_tri_plain(
        q.float(), k.float(), v.float(), o.float(), do.float(), lse, off, dlse,
        sm_scale=q.shape[-1] ** -0.5,
    )
    torch.cuda.synchronize()
    # dQ in q's dtype; dK and dV fp32, as the Pallas kernel returns them
    # (the split pair returns k's dtype).
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    for g in got:
        assert bool(torch.isfinite(g).all())
    errors = _bwd_errors(got, want)
    assert max(errors.values()) <= BWD_TOL[dtype], errors
    if off < 0:
        assert torch.all(got[0][:, :, :-off] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tri_bwd_bf16_n2048_peaked", "tri_bwd_bf16_off300"])
def test_tri_bwd_is_deterministic(cuda, case):
    """Each dK/dV tile has one owner block, and the KV tiles' blocks add to
    each dQ row in KV-tile order, each waiting on the row's counter for its
    turn: repeated runs give identical bits."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    q, k, v, o, do, lse, off = onchip.tri_bwd_cases(gen)[case]
    first = ft.flash_attention_bwd_tri(q, k, v, o, do, lse, q_offset=off)
    for _ in range(3):
        again = ft.flash_attention_bwd_tri(q, k, v, o, do, lse, q_offset=off)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(c for c in LADDER_FWD_CASES if c.startswith("naive")))
def test_naive_spike_matches_plain(cuda, case, dtype):
    """Naive on the spike fixture (one column scored far above the rest,
    past exp's range unless the max is the whole row's): a partial row
    max overflows there, where the ladder and peaked fixtures hide it."""
    _, shape_q, shape_kv, kw = LADDER_FWD_CASES[case]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    qkv = onchip.spike_inputs(shape_q, shape_kv, dtype, gen, col=shape_kv[2] - 10)
    before = nv.naive_attention.launches
    err, _ = onchip.ladder_fwd_error("naive", qkv, kw)
    assert nv.naive_attention.launches == before + 1
    assert err <= TOL[dtype], err


def _ladder_fault_errors(kernel, gen):
    """The worst error over chip_smoke.py's cases of one ladder kernel at
    reduced batch, with the check's tolerance."""
    bf16, f32 = torch.bfloat16, torch.float32
    if kernel == "flash_tri_bwd":
        cases = onchip.tri_bwd_cases(gen)
        names = ("tri_bwd_bf16_n2048_peaked", "tri_bwd_bf16_off300")
        return float(np.max([rel for n in names
                             for _, rel in onchip.tri_bwd_errors(cases[n]).values()])), BWD_TOL[bf16]
    shp = onchip.SWEEP_1024
    cases = {
        "naive": [(f32, onchip.ladder_inputs(shp, shp, f32, gen), dict(causal=True)),
                  (f32, onchip.spike_inputs(shp, shp, f32, gen), {})],
        "flash_lean": [(bf16, onchip.ladder_inputs(shp, shp, bf16, gen), dict(save_lse=True)),
                       (bf16, onchip.spike_inputs(shp, shp, bf16, gen), dict(save_lse=True))],
        "flash_tri": [(bf16, onchip.ladder_inputs((2, 8, 2048, 64), (2, 8, 2048, 64), bf16, gen),
                       dict(save_lse=True))],
    }[kernel]
    tol = TOL[cases[0][0]]
    # np.max, not max(): a NaN error must not hide behind a finite one.
    return float(np.max([onchip.ladder_fwd_error(kernel, qkv, kw) for _, qkv, kw in cases])), tol


# Faults planted in a copy of a ladder kernel's source: (file, or (file,
# header it includes), module, its bind function, kernel, text,
# replacement).
PLANTED_LADDER_FAULTS = {
    # causal test c >= limit in place of c > limit: the diagonal is masked
    "naive_diagonal_masked": ("naive.cu", nv, nv.bind, "naive", "causal && c > row_limit[a]",
                              "causal && c >= row_limit[a]"),
    # pass 1's row max over the first KV tile only (the spike fixture
    # overflows expf)
    "naive_max_first_tile": ("naive.cu", nv, nv.bind, "naive",
                             "for (int b = 0; b < 4; ++b) m[a] = fmaxf(m[a], sc[a][b]);",
                             "for (int b = 0; b < 4; ++b) m[a] = i == 0 ? fmaxf(m[a], sc[a][b]) "
                             ": m[a];"),
    # lean through the wgmma forward: the running max is the first visible
    # tile's and never rises (the spike fixture overflows exp2)
    "lean_max_first_tile": (("flash_lean.cu", "flash_fwd_sm90.cuh"), ff, ff.bind_lean, "flash_lean",
                            "const float m_new = fmaxf(m_i[half], mx[half] * scale_log2);",
                            "const float m_new = m_i[half] == -INFINITY ? mx[half] * scale_log2 "
                            ": m_i[half];"),
    # the diagonal tile treated as interior: no mask compare on it (the
    # wgmma forward, built through the triangular entry)
    "tri_diagonal_unmasked": (("flash_tri.cu", "flash_fwd_sm90.cuh"), ft, ft.bind, "flash_tri",
                              "const bool full = kv_start + kTile - 1 <= q_start + off",
                              "const bool full = kv_start <= q_start + off"),
    # dS = P * dP^T: delta dropped (the fused kernel the backward runs)
    "tri_bwd_delta_dropped": (("flash_tri.cu", "flash_bwd_fused_sm90.cuh"), ft, ft.bind,
                              "flash_tri_bwd", "pv * (dpt[4 * j + e] - dlt[e & 1])",
                              "pv * dpt[4 * j + e]"),
    # the last KV tile a dQ row sees (its diagonal tile) left out of the
    # ordered sum (the adds the fused kernel shares)
    "tri_bwd_last_add_dropped": (("flash_tri.cu", "dq_ordered.cuh"), ft, ft.bind,
                                 "flash_tri_bwd", "rank > 0 ? plus(sum[u], p.x) : p.x",
                                 "rank > 0 ? sum[u] : p.x"),
    # the fused kernel given offset 0 in place of the static offset (the
    # 300 of tri_bwd_bf16_off300)
    "tri_bwd_offset_dropped": ("flash_tri.cu", ft, ft.bind, "flash_tri_bwd",
                               "delta, nullptr, off, dk", "delta, nullptr, 0, dk"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_LADDER_FAULTS))
def test_planted_ladder_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's check of each ladder kernel passes the kernel as
    built and fails a copy with a planted fault (errors printed with ``-s``;
    NaN counts as a failure)."""
    source, module, bind, kernel, old, new = PLANTED_LADDER_FAULTS[fault]
    unit, source = (source, source) if isinstance(source, str) else source
    lib = bind(_planted_library(tmp_path, unit, source, old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    clean, tol = _ladder_fault_errors(kernel, gen)
    monkeypatch.setattr(module, "_lib", lambda: lib)
    gen.manual_seed(onchip.SEED)
    faulty, _ = _ladder_fault_errors(kernel, gen)
    print(f"\n{fault}: worst error built {clean:.3e} -> planted {faulty:.3e} (tol {tol})")
    assert clean <= tol
    assert not faulty <= tol


@pytest.mark.gpu
def test_bench_routes_launch_their_kernels(cuda):
    """The benchmark's calls reach the kernels the JAX router names: lean at
    non-causal N <= 1024, the general kernel at N >= 2048, the triangular
    kernel for causal, its backward in the high-occupancy phase; and the op
    (tensor offsets) the general kernel and the split pair."""
    rng = np.random.default_rng(0)

    def qkv(b, h, n):
        return [_uniform(rng, (b, h, n, 64), cuda, torch.bfloat16) for _ in range(3)]

    def launched(fn):
        before = {name: w.launches for name, w in bench.KERNELS.items()}
        fn()
        return {name: w.launches - before[name] for name, w in bench.KERNELS.items()
                if w.launches != before[name]}

    q, k, v = qkv(8, 1, 1024)
    assert launched(lambda: flash_attention_mxu(q, k, v)) == {"flash_lean": 1}
    assert launched(lambda: flash_attention_mxu(q, k, v, causal=True)) == {"flash_tri": 1}
    q2, k2, v2 = qkv(2, 1, 2048)
    assert launched(lambda: flash_attention_mxu(q2, k2, v2)) == {"flash_fwd": 1}
    assert launched(lambda: flash_attention_mxu(q2, k2, v2, causal=True)) == {"flash_tri": 1}
    q3, k3, v3 = qkv(2, 4, 512)
    o, lse = ff.flash_attention_fwd(q3, k3, v3, causal=True, save_lse=True)
    assert launched(lambda: fb.flash_attention_bwd_auto(q3, k3, v3, o, q3, lse, causal=True)) == {
        "flash_tri_bwd": 1}
    assert launched(lambda: nv.naive_attention(q.float(), k.float(), v.float())) == {"naive": 1}
    assert launched(lambda: flash_attention(q3, k3, v3, causal=True)) == {"flash_fwd": 1}
    q4 = q3.clone().requires_grad_(True)
    assert launched(lambda: flash_attention(q4, k3, v3, causal=True).sum().backward()) == {
        "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}


@pytest.mark.gpu
def test_ladder_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 2, 64, 64), device=cuda)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="static"):
        ft.flash_attention_tri(q, q, q, q_offset=torch.zeros(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="equal head counts"):
        ft.flash_attention_bwd_tri(q, q[:, :1], q[:, :1], q, q, lse)
    with pytest.raises(ValueError, match="n_kv"):
        ff.flash_fwd_lean(q, torch.zeros((1, 2, 1088, 64), device=cuda),
                          torch.zeros((1, 2, 1088, 64), device=cuda))
    with pytest.raises(ValueError, match="8192"):
        big = torch.zeros((1, 1, 8256, 64), device=cuda)
        nv.naive_attention(big, big, big)
    with pytest.raises(TypeError):
        nv.naive_attention(q.half(), q.half(), q.half())



# ---------------------------------------------------------------------------
# The 8-bit and paged caches' kernels (csrc/flash_fwd.cu): quant, paged and
# paged-quant.
# ---------------------------------------------------------------------------

KV_FORMATS = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
# (q shape, KV [B, H_kv, N], offsets, pos_div): ragged rows (not a multiple
# of the 64-row tile) with GQA 2; the folded decode of group 4 with slots at
# both ends of the cache.
KV_SHAPES = {
    "ragged_gqa2": ((3, 4, 130, 64), (3, 2, 384), [0, 100, 254], 1),
    "decode_fold4": ((3, 2, 4, 64), (3, 2, 256), [0, 255, 97], 4),
}


def _kv_args(kernel, fmt, shape, dtype, q_scale, gen):
    """A kernel's arguments (``onchip.KV_KERNELS`` order) at ``KV_SHAPES``
    entry ``shape``: 8-bit K/V of ``fmt`` for the quant kernels, pools in
    q's dtype for the paged one, a shuffled table with page 0 (NaN) past
    each slot's diagonal."""
    shape_q, (b, hkv, n_kv), offsets, pos_div = KV_SHAPES[shape]
    q, k, v = onchip.ladder_inputs(shape_q, (b, hkv, n_kv, 64), dtype, gen, q_scale)
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    if kernel == "flash_quant":
        return (q, qt.quantize_kv(k, v, KV_FORMATS[fmt]), off), pos_div
    perm, table, n_pages = onchip.paged_layout(b, n_kv, off, shape_q[2], pos_div, gen)
    if kernel == "flash_paged":
        kv_ = (k, v)
    else:
        qkv = qt.quantize_kv(k, v, KV_FORMATS[fmt])
        kv_ = (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)
    return (q, *(onchip.to_pages(x, perm, n_pages) for x in kv_), table, off), pos_div


KV_KERNEL_RUNS = [("flash_quant", fmt) for fmt in KV_FORMATS] + [("flash_paged", None)] + [
    ("flash_paged_quant", fmt) for fmt in ("int8", "e4m3")]


@pytest.mark.gpu
@pytest.mark.parametrize("q_scale", [1.0, onchip.PEAKED_Q_SCALE], ids=["ladder", "peaked"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", sorted(KV_SHAPES))
@pytest.mark.parametrize("kernel,fmt", KV_KERNEL_RUNS)
def test_kv_kernel_matches_plain(cuda, kernel, fmt, shape, dtype, q_scale):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    args, pos_div = _kv_args(kernel, fmt, shape, dtype, q_scale, gen)
    wrapper = onchip.KV_KERNELS[kernel][0]
    counter = {"flash_quant": qt.flash_attention_quant, "flash_paged": pg.flash_attention_paged,
               "flash_paged_quant": pg.flash_attention_paged_quant}[kernel]
    before = counter.launches
    out = wrapper(*args, pos_div)
    assert counter.launches == before + 1
    o = out[0] if isinstance(out, tuple) else out
    assert o.dtype == dtype and o.shape == args[0].shape
    err, lse_err = onchip.kv_kernel_error(kernel, args, pos_div)
    assert err <= TOL[dtype] and lse_err <= TOL[dtype], (err, lse_err)


@pytest.mark.gpu
def test_quant_kernel_masked_rows_and_non_causal(cuda):
    """Rows that see nothing give o = 0 and lse = -inf; non-causal calls
    see every column (the default offset)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v = onchip.ladder_inputs((1, 2, 128, 64), (1, 1, 128, 64), torch.bfloat16, gen)
    qkv = qt.quantize_kv(k, v, torch.int8)
    off = torch.tensor([-70], dtype=torch.int32, device="cuda")
    err, lse_err = onchip.kv_kernel_error("flash_quant", (q, qkv, off), 1)
    assert err <= TOL[torch.bfloat16] and lse_err <= TOL[torch.bfloat16]
    o, lse = qt.flash_attention_quant(q, qkv, off, causal=True, save_lse=True)
    assert torch.all(o[:, :, :70] == 0) and torch.all(torch.isneginf(lse[:, :, :70]))
    o = qt.flash_attention_quant(q, qkv)
    want = qt.flash_attention_quant_plain(q.float(), qkv, torch.zeros(1, dtype=torch.int32,
                                          device="cuda"), sm_scale=0.125, causal=False)
    assert float((o.float() - want).abs().max()) <= TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [64, 192, 256, 2048])
@pytest.mark.parametrize("kernel,fmt", KV_KERNEL_RUNS)
def test_kv_kernels_at_every_chunk(cuda, monkeypatch, kernel, fmt, chunk):
    """Any chunking of the decode grid gives the plain version's result:
    one-tile splits, splits that do not divide the row, the rule's 256
    and no split at all, on the peaked fixture at the serving shape (the
    chunk forced by standing in for ``decode_kv_chunk``)."""
    monkeypatch.setattr(ff, "decode_kv_chunk", lambda *shape: chunk)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    lengths = torch.from_numpy(onchip.decode_lengths()).to("cuda")
    q, k, v = onchip.ladder_inputs(onchip.DECODE_Q, onchip.DECODE_KV, torch.bfloat16, gen,
                                   onchip.PEAKED_Q_SCALE)
    if kernel == "flash_quant":
        args = (q, qt.quantize_kv(k, v, KV_FORMATS[fmt]), lengths)
        wrapper = qt.flash_attention_quant
        call = lambda: wrapper(*args, causal=True, pos_div=2, save_lse=True)  # noqa: E731
    else:
        b, _, n_kv, _ = onchip.DECODE_KV
        perm, table, n_pages = onchip.paged_layout(b, n_kv, lengths, 2, 2, gen)
        if kernel == "flash_paged":
            kv_ = (k, v)
        else:
            qkv = qt.quantize_kv(k, v, KV_FORMATS[fmt])
            kv_ = (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)
        args = (q, *(onchip.to_pages(x, perm, n_pages) for x in kv_), table, lengths)
        wrapper = pg.flash_attention_paged if kernel == "flash_paged" else pg.flash_attention_paged_quant
        call = lambda: wrapper(*args, pos_div=2)  # noqa: E731
    want = onchip.KV_KERNELS[kernel][1](*args, 2)
    err, lse_err = onchip._fwd_errors(call(), want)
    assert err <= TOL[torch.bfloat16] and lse_err <= TOL[torch.bfloat16], (err, lse_err)
    splits = -(-onchip.DECODE_KV[2] // chunk)
    assert wrapper.grid == ff.SplitGrid(chunk, splits, 8 * 8 * splits)


@pytest.mark.gpu
def test_kv_kernels_are_deterministic(cuda):
    """One owner block per output tile, a fixed KV order in each split and
    the splits merged in split order by whichever block arrives last: two
    runs of each kernel at chip_smoke.py's shapes give identical bits."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    for name, (kernel, args, pos_div) in onchip.kv_cases(gen).items():
        wrapper = onchip.KV_KERNELS[kernel][0]
        first, second = wrapper(*args, pos_div), wrapper(*args, pos_div)
        for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (first, second))):
            assert torch.equal(a, b), name


# Faults planted in a copy of csrc/: (source, kernels whose check must
# fail, text, replacement).  flash_decode.cuh is the split-KV decode grid,
# flash_fwd.cu the 64-row template that the 512-row prefill chunk runs (bf16
# and fp32 q), kv_tiles.cuh the paged addressing both share.
PLANTED_KV_FAULTS = {
    # every column of a KV tile takes the tile's first V scale: s_v
    # applied to the tile's sum instead of to each column of P
    "v_scale_on_the_sum": ("flash_decode.cuh", ("flash_quant", "flash_paged_quant"),
                           "const float v_scale = kScaled ? scales[kBlockN + c] : 1.0f;",
                           "const float v_scale = kScaled ? scales[kBlockN] : 1.0f;"),
    # the K scale dropped on one column of each KV tile
    "k_scale_dropped_on_one_column": ("flash_decode.cuh", ("flash_quant", "flash_paged_quant"),
                                      "const float k_scale = kScaled ? scales[c] : 1.0f;",
                                      "const float k_scale = kScaled && c != 5 ? scales[c] : 1.0f;"),
    # logical page j read as physical page j
    "identity_page_table": ("kv_tiles.cuh", ("flash_paged", "flash_paged_quant"),
                            "const int phys = min(max(kv.table[(size_t)b * kv.max_pages + logical], "
                            "0), kv.n_pages - 1);",
                            "const int phys = min(logical, kv.n_pages - 1);"),
    # the split that holds a slot's diagonal reads on up to a page past it
    "page_past_the_diagonal": ("flash_decode.cuh", ("flash_paged", "flash_paged_quant"),
                               "const int kv_end = min(kv_begin + kv_chunk, tile_limit + 1);",
                               "const int kv_end = min(kv_begin + kv_chunk, "
                               "tile_limit + 1 + (kPaged ? kv.page : 0));"),
    # the merge stops a split short: it drops the last split, the last
    # non-empty one of every slot whose diagonal lies in it (slot 1 of
    # decode_lengths, the long slot of skewed_lengths)
    "merge_drops_last_split": ("flash_decode.cuh",
                               ("flash_quant", "flash_paged", "flash_paged_quant"),
                               "for (int s = 0; s < n_splits; ++s) {",
                               "for (int s = 0; s < n_splits - 1; ++s) {"),
    # the merge adds each split's o_s without its e^(m_s - M) rescale (the
    # peaked fixture's splits have far apart maxima)
    "merge_no_rescale": ("flash_decode.cuh", ("flash_quant", "flash_paged", "flash_paged_quant"),
                         "om += weight * __ldcg(part + p * D + d);",
                         "om += __ldcg(part + p * D + d);"),
    # a split whose chunk starts past the diagonal reads its chunk's first
    # tile: an unallocated table entry, so page 0 (NaN)
    "empty_split_reads_its_page": ("flash_decode.cuh", ("flash_paged", "flash_paged_quant"),
                                   "const int n_steps = kv_begin >= kv_end ? 0 :",
                                   "const int n_steps = kv_begin >= kv_end ? 1 :"),
    # The template's versions of the first faults, on the prefill chunk.
    "template_v_scale_on_the_sum": ("flash_fwd.cu", ("flash_quant", "flash_paged_quant"),
                                    "const float v_scale = kScaled ? sm.sv[c] : 1.0f;",
                                    "const float v_scale = kScaled ? sm.sv[0] : 1.0f;"),
    "template_k_scale_dropped_on_one_column": (
        "flash_fwd.cu", ("flash_quant", "flash_paged_quant"),
        "const float k_scale = kScaled ? sm.sk[c] : 1.0f;",
        "const float k_scale = kScaled && c != 5 ? sm.sk[c] : 1.0f;"),
    # the KV loop reads one page past each row block's diagonal
    "template_page_past_the_diagonal": (
        "flash_fwd.cu", ("flash_paged", "flash_paged_quant"), "tile_limit / kBlockN + 1;",
        "tile_limit / kBlockN + 1 + (kPaged ? kv.page / kBlockN : 0);"),
}
# The kv_cases each source's code runs, by a part of the case's name: each
# group must fail on its own.
KV_FAULT_REACH = {"flash_decode.cuh": ("_decode_",),
                  "flash_fwd.cu": ("_prefill_bf16", "_prefill_fp32"),
                  "kv_tiles.cuh": ("_decode_", "_prefill_bf16", "_prefill_fp32")}


def _kv_check(kernel, group, gen):
    """The worst error of chip_smoke.py's checks of one kernel on the cases
    whose name holds ``group`` (NaN if any reads NaN)."""
    gen.manual_seed(onchip.SEED)
    cases = [c for name, c in onchip.kv_cases(gen).items() if c[0] == kernel and group in name]
    assert cases, (kernel, group)
    return float(np.max([onchip.kv_kernel_error(*c) for c in cases]))


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_KV_FAULTS))
def test_planted_kv_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's check of the 8-bit and paged kernels passes them as
    built and fails a copy with a planted fault, on every group of cases
    that runs the planted file (errors printed with ``-s``; NaN counts as a
    failure)."""
    source, kernels, old, new = PLANTED_KV_FAULTS[fault]
    lib = qt.bind(_planted_library(tmp_path, "flash_fwd.cu", source, old, new))
    gen = torch.Generator(device="cuda")
    runs = [(k, g) for k in kernels for g in KV_FAULT_REACH[source]]
    clean = {run: _kv_check(*run, gen) for run in runs}
    monkeypatch.setattr(qt, "_lib", lambda: lib)
    monkeypatch.setattr(pg, "_lib", lambda: lib)
    faulty = {run: _kv_check(*run, gen) for run in runs}
    tol = {g: TOL[torch.float32 if "fp32" in g else torch.bfloat16] for _, g in runs}
    print(f"\n{fault} ({source}): worst error built -> planted: " + ", ".join(
        f"{k}{g} {clean[k, g]:.3e} -> {faulty[k, g]:.3e} (tol {tol[g]})" for k, g in runs))
    for run in runs:
        assert clean[run] <= tol[run[1]]
        assert not faulty[run] <= tol[run[1]], run


@pytest.mark.gpu
def test_kv_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    k = torch.zeros((1, 2, 128, 64), device=cuda)
    qkv = qt.quantize_kv(k, k)
    with pytest.raises(TypeError):
        qt.flash_attention_quant(q.half(), qkv, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        qt.flash_attention_quant(torch.zeros((1, 2, 8, 96), device=cuda),
                                 qt.quantize_kv(torch.zeros((1, 2, 128, 96), device=cuda),
                                                torch.zeros((1, 2, 128, 96), device=cuda)))
    pool = torch.zeros((3, 2, 128, 64), device=cuda)
    table = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    lengths = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        pg.flash_attention_paged(q, pool, pool, table.cpu(), lengths)
    with pytest.raises(TypeError, match="dtype"):
        pg.flash_attention_paged(q, pool.bfloat16(), pool.bfloat16(), table, lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(serving.KV_MODES))
def test_engine_modes_cuda_match_cpu(cuda, mode):
    """Greedy fp32 serving in each KV-cache mode: the card (the mode's
    kernel) and the CPU (its plain version) emit the same tokens, with
    log-probabilities equal to fp32 rounding.  Three requests share a
    150-token prefix on two slots, so slots are reused and, with
    prefix_share, pages adopted."""
    _, cfg = serving.build_engine(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256,
        max_batch=2, max_len=512, dtype=torch.float32, device="cpu",
    )
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen)
    prefix = [7 + (i * 5) % 200 for i in range(150)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = serving.DecodeEngine(tf.map_params(lambda p: p.to(dev), params), cfg, max_batch=2,
                                   max_len=512, **serving.SERVING_MODES[mode][0])
        reqs = [serving.Request(uid=u, prompt=prefix + [u + 1], max_new_tokens=6) for u in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[dev] = reqs
    # As tests/test_torch_paged.py's LOGP_TOL: an 8-bit cache may round a
    # key a step apart on the two devices.
    atol = 5e-4 if mode.endswith(("int8", "fp8")) else 1e-4
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.generated == b.generated
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# FlashAttention V1 (csrc/flash_v1.cu: streaming and folded), the fused
# backward (csrc/flash_bwd.cu, fam_flash_bwd_fused) and the autotuner that
# routes the backward to it.
# ---------------------------------------------------------------------------

# (q shape, causal, (block_q, block_k) or None): the route each takes is
# the JAX function's (fv.v1_route), the Q-tile height fv.v1_tile_rows's.
# Folded: one KV tile per row, fold 8, 2 and 4 (ragged: 200 columns, not a
# multiple of the 64-column tile); every n_kv the sweep sends (128: 64-row
# tiles, 256 and 512: 32 rows; 16 at head dim 128) and 330, fold 2, in
# 32-row tiles that do not divide it.  Streaming: two 512-column logical
# blocks, a ragged row of 200 at batch 1 (fold 1), 1000 rows in 200-row
# logical blocks, N = 1024 on 128 blocks of 64 rows, and N = 2048 at
# batch 1 and 2, whose small grids take 32-row tiles.
V1_CASES = {
    "folded_n128": ((16, 2, 128, 64), False, None),
    "folded_n256": ((8, 1, 256, 64), False, None),
    "folded_n512_causal": ((4, 2, 512, 64), True, None),
    "folded_ragged_causal": ((4, 1, 200, 64), True, None),
    "folded_n330": ((2, 1, 330, 64), False, None),
    "folded_n330_causal": ((2, 1, 330, 64), True, None),
    "folded_n128_d128": ((8, 1, 128, 128), True, None),
    "folded_n256_d128": ((4, 1, 256, 128), False, None),
    "folded_n512_d128_causal": ((2, 1, 512, 128), True, None),
    "stream_n1024": ((2, 2, 1024, 64), False, None),
    "stream_n1024_causal": ((1, 2, 1024, 64), True, None),
    "stream_ragged_n200": ((1, 2, 200, 64), True, None),
    "stream_n1000_blocks200": ((1, 2, 1000, 64), True, (200, 200)),
    "stream_n1024_b8_causal": ((8, 1, 1024, 64), True, None),
    "stream_n1024_d128": ((4, 2, 1024, 128), False, None),
    "stream_n2048_b1": ((1, 1, 2048, 64), True, None),
    "stream_n2048_b2": ((2, 1, 2048, 64), False, None),
    "stream_n2048_d128_causal": ((2, 1, 2048, 128), True, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("q_scale", [1.0, onchip.PEAKED_Q_SCALE], ids=["ladder", "peaked"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(V1_CASES))
def test_v1_kernels_match_plain(cuda, case, dtype, q_scale):
    shape, causal, blocks = V1_CASES[case]
    block_q, block_k = blocks or (None, None)
    rng = np.random.default_rng(0)
    q = _uniform(rng, shape, cuda, dtype, q_scale)
    k = _uniform(rng, shape, cuda, dtype)
    v = _uniform(rng, shape, cuda, dtype)
    route = fv.v1_route(shape[0], shape[2], shape[2], block_q, block_k)[0]
    assert route == ("folded" if case.startswith("folded") else "stream")
    kernel = fv.flash_v1_folded if route == "folded" else fv.flash_v1_stream
    other = fv.flash_v1_stream if route == "folded" else fv.flash_v1_folded
    before = (kernel.launches, other.launches)
    o = fv.flash_attention_v1(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
    assert (kernel.launches, other.launches) == (before[0] + 1, before[1])
    want = fv.flash_attention_v1_plain(q.float(), k.float(), v.float(),
                                       sm_scale=shape[-1] ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    assert float((o.float() - want).abs().max()) <= TOL[dtype]


@pytest.mark.gpu
def test_v1_checks_pass_the_kernels(cuda):
    """chip_smoke.py's V1 checks: every case within 1e-5 (fp32), the spike
    fixture included."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    for name, (_, qkv, causal) in onchip.v1_cases(gen).items():
        err = onchip.v1_error(qkv, causal)
        assert err <= TOL[torch.float32], (name, err)


# Faults planted in a copy of csrc/flash_v1.cu: (kernel, the check that
# must fail, text, replacement).
PLANTED_V1_FAULTS = {
    # the accumulator and the running sum kept unrescaled when the running
    # max rises between KV tiles
    "stream_no_rescale": ("flash_v1", "v1_fp32_n1024_peaked",
                          "const float alpha = exp2f(m[a] - base);",
                          "const float alpha = 1.0f;"),
    # the folded kernel's row max taken over the first 64-column K tile only
    "folded_partial_row_max": ("flash_v1_folded", "v1_fp32_n128_spike",
                               "mx[a] = fmaxf(mx[a], s[a][b]);",
                               "mx[a] = i == 0 ? fmaxf(mx[a], s[a][b]) : mx[a];"),
    # the streaming step's row max over 8 of the row's 16 lanes: half its
    # columns (the spike fixture's column lies in the other half for some
    # rows' lanes)
    "stream_partial_step_max": ("flash_v1", "v1_fp32_n1024_spike",
                                "fmaxf(m[a], reduce_lanes<true, kColGroups>(mx))",
                                "fmaxf(m[a], reduce_lanes<true, kColGroups / 2>(mx))"),
    # the causal walk one KV tile short: the diagonal tile is skipped
    "causal_walk_short": ("flash_v1", "v1_fp32_n1024_causal",
                          "return causal ? min(n_t, q_last / kTile + 1) : n_t;",
                          "return causal ? min(n_t, q_last / kTile) : n_t;"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_V1_FAULTS))
def test_planted_v1_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's checks of one V1 kernel pass it as built and fail a
    copy with a planted fault on the fixture that shows it (errors printed
    with ``-s``; NaN counts as a failure)."""
    kernel, shows, old, new = PLANTED_V1_FAULTS[fault]
    lib = fv.bind(_planted_library(tmp_path, "flash_v1.cu", "flash_v1.cu", old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = {n: c for n, c in onchip.v1_cases(gen).items() if c[0] == kernel}
    clean = {n: onchip.v1_error(qkv, causal) for n, (_, qkv, causal) in cases.items()}
    monkeypatch.setattr(fv, "_lib", lambda: lib)
    faulty = {n: onchip.v1_error(qkv, causal) for n, (_, qkv, causal) in cases.items()}
    tol = TOL[torch.float32]
    print(f"\n{fault}: max-abs error built -> planted (tol {tol}):\n" + "\n".join(
        f"  {n}: {clean[n]:.3e} -> {faulty[n]:.3e}" for n in cases))
    assert all(e <= tol for e in clean.values()), clean
    assert not faulty[shows] <= tol


@pytest.mark.gpu
def test_v1_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((2, 1, 128, 64), device=cuda)
    with pytest.raises(ValueError, match="n_q == n_kv"):
        fv.flash_attention_v1(q[:, :, :64], q, q, causal=True)
    with pytest.raises(TypeError):
        fv.flash_attention_v1(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="divisible"):
        big = torch.zeros((1, 1, 1000, 64), device=cuda)
        fv.flash_attention_v1(big, big, big)
    with pytest.raises(ValueError, match="n_kv <= 512"):
        long = torch.zeros((2, 1, 1024, 64), device=cuda)
        fv.flash_v1_folded(long, long, long, 2, sm_scale=0.125, causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "case",
    [
        # ragged n_q and n_kv, GQA 2, per-batch offsets, an lse cotangent
        dict(b=2, hq=4, hkv=2, n_q=130, n_kv=300, off=[0, 170], causal=True),
        dict(b=2, hq=4, hkv=2, n_q=130, n_kv=300, off=[0, 0], causal=False),
        # GQA 4 (the block walks four q-heads, each adding its own dQ rows)
        dict(b=1, hq=8, hkv=2, n_q=256, n_kv=256, off=[0], causal=True),
        # rows and a whole Q tile that see nothing: zero gradients, no NaN
        dict(b=1, hq=2, hkv=1, n_q=128, n_kv=128, off=[-70], causal=True),
        # peaked softmax over several tiles
        dict(b=2, hq=4, hkv=2, n_q=256, n_kv=256, off=[0, 0], causal=True,
             q_scale=onchip.PEAKED_Q_SCALE),
    ],
    ids=["ragged_gqa2", "non_causal", "gqa4", "masked_rows", "peaked"],
)
def test_fused_bwd_matches_plain(cuda, dtype, case):
    rng = np.random.default_rng(0)
    q = _uniform(rng, (case["b"], case["hq"], case["n_q"], 64), cuda, dtype,
                 case.get("q_scale", 1.0))
    k = _uniform(rng, (case["b"], case["hkv"], case["n_kv"], 64), cuda, dtype)
    v = _uniform(rng, (case["b"], case["hkv"], case["n_kv"], 64), cuda, dtype)
    do = _uniform(rng, q.shape, cuda, dtype)
    dlse = _uniform(rng, q.shape[:3], cuda, torch.float32)
    off = torch.tensor(case["off"], dtype=torch.int32, device=cuda)
    causal = case["causal"]
    o, lse = flash_attention_fwd(q, k, v, off, causal=causal, save_lse=True)
    counters = (fb.flash_bwd_fused, fb.flash_bwd_dkv, fb.flash_bwd_dq)
    before = [c.launches for c in counters]
    got = fb.flash_attention_bwd_fused(q, k, v, o, do, lse, off, dlse, sm_scale=0.125,
                                       causal=causal)
    assert [c.launches for c in counters] == [before[0] + 1, before[1], before[2]]
    want = fb.flash_attention_bwd_fused_plain(
        q.float(), k.float(), v.float(), o.float(), do.float(), lse, off, dlse,
        sm_scale=0.125, causal=causal,
    )
    torch.cuda.synchronize()
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape and bool(torch.isfinite(g).all())
    errors = _bwd_errors(got, want)
    assert max(errors.values()) <= BWD_TOL[dtype], errors
    if case["off"] == [-70]:
        assert torch.all(got[0][:, :, :70] == 0)


def _fused_runs(inputs, n):
    """``n`` fused backward runs on the same inputs (their bound: the
    largest offset), each a tuple of (dq, dk, dv)."""
    q, k, v, o, do, lse, off = inputs
    bound = int(off.max())
    return [fb.flash_attention_bwd_fused(q, k, v, o, do, lse, off, causal=True,
                                         q_offset_max=bound) for _ in range(n)]


def _deterministic_inputs(gen):
    """The training shape (GQA 16 / 8), peaked, with a different device
    offset per batch."""
    q, k, v, do, _ = onchip.train_cases(gen)["train_bf16_peaked"]
    off = torch.tensor([0, 64, 100, 1000], dtype=torch.int32, device="cuda")
    return onchip.bwd_inputs((q, k, v, do, off))


@pytest.mark.gpu
def test_fused_bwd_is_deterministic(cuda):
    """Each dK/dV tile has one owner block, and the KV tiles add to each dQ
    row in KV-tile order, held by the counters: five runs give identical
    bits (GQA, per-batch device offsets)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    runs = _fused_runs(_deterministic_inputs(gen), 5)
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)


# Faults planted in a copy of csrc/ that only the fused path runs:
# (file, text, replacement).  The kernel is built for head dims 64 and 128;
# the check runs the training shape at 64.
PLANTED_FUSED_FAULTS = {
    # the last KV tile's dQ contribution (the diagonal's) left out of the sum
    "dq_partial_dropped": ("dq_ordered.cuh", "rank > 0 ? plus(sum[u], p.x) : p.x",
                           "rank > 0 ? sum[u] : p.x"),
    # dK stored without sm_scale on the fused path
    "dk_unscaled": ("flash_bwd_fused_sm90.cuh",
                    "store_row<D>(dk + (kv_rows + c) * D, dk_acc, half, sm_scale, t);",
                    "store_row<D>(dk + (kv_rows + c) * D, dk_acc, half, 1.0f, t);"),
    # the dQ fragment staged with its q-row and head-dim indices swapped
    "dqt_store_transposed": (
        "flash_bwd_fused_sm90.cuh",
        "*reinterpret_cast<float2*>(&tile[r * kDqPitch + j * 8 + 2 * t]) =\n"
        "                make_float2(dqt[0][4 * j + 2 * h], dqt[0][4 * j + 2 * h + 1]);",
        "tile[(j * 8 + 2 * t) * kDqPitch + r] = dqt[0][4 * j + 2 * h];\n"
        "            tile[(j * 8 + 2 * t + 1) * kDqPitch + r] = dqt[0][4 * j + 2 * h + 1];"),
    # the ordered add without its wait on the counter: tiles add in any order
    "ordered_add_unwaited": ("flash_bwd_fused_sm90.cuh",
                             "dq_ordered::load_acquire(cnt) < rank", "false"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_FUSED_FAULTS))
def test_planted_fused_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's fused-backward check at the training shape passes the
    kernel as built and fails a copy with a planted fault (errors printed
    with ``-s``): its error exceeds the bound, or, for a fault that only
    breaks the order of the adds, repeated runs differ."""
    source, old, new = PLANTED_FUSED_FAULTS[fault]
    lib = fb.bind(_planted_library(tmp_path, "flash_bwd.cu", source, old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.train_cases(gen)
    names = ("train_bf16", "train_bf16_peaked")
    inputs = {n: onchip.bwd_inputs(cases[n]) for n in names}
    gen.manual_seed(onchip.SEED)
    varied = _deterministic_inputs(gen)

    def check():
        errs = {n: onchip.bwd_kernel_errors(inputs[n], fused=True) for n in names}
        runs = _fused_runs(varied, 5)
        same = all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))
        return errs, same

    clean, clean_same = check()
    monkeypatch.setattr(fb, "_lib", lambda: lib)
    faulty, faulty_same = check()
    print(f"\n{fault}, (dq, dk, dv) normalised max-abs error, built -> planted:\n" + "\n".join(
        f"  {n}: " + ", ".join(f"{g} {clean[n][g][1]:.3e} -> {faulty[n][g][1]:.3e}" for g in clean[n])
        for n in names) + f"\n  repeated runs identical: {clean_same} -> {faulty_same}")
    tol = BWD_TOL[torch.bfloat16]
    for name in names:
        assert max(rel for _, rel in clean[name].values()) <= tol
    assert clean_same
    # np.max, not max(): a NaN error must not hide behind a finite one.
    worst = float(np.max([rel for n in names for _, rel in faulty[n].values()]))
    assert not worst <= tol or not faulty_same


@pytest.mark.gpu
def test_fused_bwd_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 64, 64), device=cuda)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="block_sizes"):
        fb.flash_attention_bwd_fused(q, q, q, q, q, lse, causal=True, block_sizes=fb.BlockSizes())
    with pytest.raises(NotImplementedError, match="JAX's fused kernel takes neither"):
        fb.flash_attention_bwd_fused(q, q, q, q, q, lse, causal=True, softcap=30.0)
    with pytest.raises(ValueError, match="causal"):
        fb.flash_attention_bwd_fused(q, q, q, q, q, lse, causal=False, window=16)
    # fp16 runs in fp32 (as flash_attention_bwd); fp64 has no kernel.
    with pytest.raises(TypeError):
        fb.flash_attention_bwd_fused(q.double(), q.double(), q.double(), q.double(), q.double(),
                                     lse, causal=True)
    grads = fb.flash_attention_bwd_fused(q.half(), q.half(), q.half(), q.half(), q.half(), lse,
                                         causal=True)
    assert all(g.dtype == torch.float16 for g in grads)


@pytest.mark.gpu
def test_fused_workspace_holds_the_visible_pairs(cuda):
    """The fused kernel's dQ workspace (csrc/dq_ordered.cuh): what the
    allocator gives a call is the accumulator and the counters
    (``fused_workspace_bytes``), whatever the offsets, and on the card the
    accumulator rows written are those of the Q steps that see two KV tiles
    or more (a step that sees one writes dQ directly, one that sees none
    gets zeros)."""
    rng = np.random.default_rng(0)
    q = _uniform(rng, (2, 4, 200, 64), cuda, torch.bfloat16)
    k, v = (_uniform(rng, (2, 2, 300, 64), cuda, torch.bfloat16) for _ in range(2))
    need = fb.fused_workspace_bytes(q)
    assert need == 4 * (2 * 4 * 200 * 64 + 1 + 2 * 4 * 7)

    def rows_added(off):
        # 64-row Q steps: the KV tiles their last row sees
        return sum(min(64, 200 - s) for s in range(0, 200, 64)
                   if min(s + 63, 199) + off >= 64)

    for offs, bound in (([100, 100], 100), ([0, 100], 100), ([-70, -70], -70)):
        off = torch.tensor(offs, dtype=torch.int32, device=cuda)
        inputs = onchip.bwd_inputs((q, k, v, q, off))
        allocated, written = onchip.fused_workspace_bytes(inputs, bound)
        assert 0 <= allocated - need < 512, (allocated, need)
        assert written == 4 * sum(rows_added(x) for x in offs) * 64 * 4, (offs, written)
        got = fb.flash_attention_bwd_fused(*inputs, causal=True, q_offset_max=bound)
        if offs[0] == -70:
            assert bool((got[0][:, :, :70] == 0).all())


@pytest.mark.gpu
def test_tri_workspace_is_the_fused_kernels(cuda):
    """The triangular backward allocates the fused kernel's dQ workspace
    (the fp32 accumulator and its counters), the same bytes at every
    offset, and adds to the accumulator rows of the Q steps that see two KV
    tiles or more."""
    rng = np.random.default_rng(0)
    q = _uniform(rng, (2, 4, 200, 64), cuda, torch.bfloat16)
    k, v = (_uniform(rng, (2, 4, 300, 64), cuda, torch.bfloat16) for _ in range(2))
    need = fb.fused_workspace_bytes(q)
    for off in (100, 0, -70, 299):
        o, lse = ft.flash_attention_tri(q, k, v, q_offset=off, save_lse=True)
        allocated, written = onchip.tri_workspace_bytes((q, k, v, o, q, lse, off))
        rows = sum(min(64, 200 - s) for s in range(0, 200, 64) if min(s + 63, 199) + off >= 64)
        assert 0 <= allocated - need < 512, (off, allocated, need)
        assert written == 2 * 4 * rows * 64 * 4, (off, written)


@pytest.fixture
def tuned_cache(tmp_path, monkeypatch):
    """The autotuner's cache in a temporary file, which the router reads."""
    path = tmp_path / "autotune_cache_torch.json"
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", str(path))
    autotune.reset_memo()
    yield path
    autotune.reset_memo()


@pytest.mark.gpu
def test_autotune_bwd_on_the_card_sets_the_route(cuda, tuned_cache):
    """``autotune_bwd`` races the split pair and the fused kernel (GQA: no
    triangular candidate) on the card and stores the winner under the
    card's name; the router then launches the winner's kernels only, and a
    cache naming "fused" sends the op's backward to the fused kernel."""
    shape = (2, 4, 2, 512, 64)
    impl, _ = autotune.autotune_bwd(shape, iters=3, log=lambda s: None)
    entries = json.loads(tuned_cache.read_text())
    (key,) = entries
    assert key.startswith(autotune.device_name("cuda") + "/bwd/b2h4kv_heads2q512kv512d64/")
    assert set(entries[key]["raced_us"]) == {"split", "fused"}
    autotune.reset_memo()
    rng = np.random.default_rng(0)
    q = _uniform(rng, (2, 4, 512, 64), cuda, torch.bfloat16)
    k, v = (_uniform(rng, (2, 2, 512, 64), cuda, torch.bfloat16) for _ in range(2))
    off = torch.zeros(2, dtype=torch.int32, device=cuda)
    o, lse = flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)
    counters = {"split": fb.flash_bwd_dkv, "fused": fb.flash_bwd_fused}
    before = {name: c.launches for name, c in counters.items()}
    fb.flash_attention_bwd_auto(q, k, v, o, q, lse, off, causal=True)
    assert {name: c.launches - before[name] for name, c in counters.items()} == {
        name: int(name == impl) for name in counters}
    entries[key] = {"impl": "fused", "blocks": {}}
    tuned_cache.write_text(json.dumps(entries))
    autotune.reset_memo()
    leaf = q.clone().requires_grad_(True)
    before = {name: c.launches for name, c in counters.items()}
    flash_attention(leaf, k, v, causal=True).float().sum().backward()
    assert {name: c.launches - before[name] for name, c in counters.items()} == {
        "split": 0, "fused": 1}


# ---------------------------------------------------------------------------
# Head dim 128 on the forward router's kernels and naive; the fp16 backward.
# ---------------------------------------------------------------------------

# (kernel, q shape, kv shape, the wrapper's keywords) at head dim 128:
# ragged lengths, GQA 2, offsets.
D128_CASES = {
    "general_gqa_off": ("flash_fwd", (2, 4, 130, 128), (2, 2, 300, 128),
                        dict(q_offset=[0, 170], causal=True, save_lse=True)),
    "lean_gqa": ("flash_lean", (2, 4, 130, 128), (2, 2, 300, 128), dict(save_lse=True)),
    "lean_longest_row": ("flash_lean", (1, 2, 64, 128), (1, 2, 1024, 128), dict(save_lse=True)),
    "tri_gqa_off170": ("flash_tri", (2, 4, 130, 128), (2, 2, 300, 128),
                       dict(q_offset=170, save_lse=True)),
    "tri_n1024": ("flash_tri", (1, 2, 1024, 128), (1, 2, 1024, 128), dict(save_lse=True)),
    "naive_ragged_causal": ("naive", (2, 2, 130, 128), (2, 2, 257, 128), dict(causal=True)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fixture", ["ladder", "peaked", "spike"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(D128_CASES))
def test_forward_kernels_at_head_dim_128_match_plain(cuda, case, dtype, fixture):
    kernel, shape_q, shape_kv, kw = D128_CASES[case]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if fixture == "spike":
        q, k, v = onchip.spike_inputs(shape_q, shape_kv, dtype, gen, col=shape_kv[2] // 2)
    else:
        scale = onchip.PEAKED_Q_SCALE if fixture == "peaked" else 1.0
        q, k, v = onchip.ladder_inputs(shape_q, shape_kv, dtype, gen, scale)
    if kernel == "flash_fwd":
        off = torch.tensor(kw["q_offset"], dtype=torch.int32, device=cuda)
        before = ff.flash_fwd_general.launches
        err, lse_err = onchip.kernel_error((q, k, v, off, 1))
        assert ff.flash_fwd_general.launches == before + 1
    else:
        wrapper = onchip.LADDER_FWD_KERNELS[kernel][0]
        before = wrapper.launches
        err, lse_err = onchip.ladder_fwd_error(kernel, (q, k, v), kw)
        assert wrapper.launches == before + 1
    assert err <= TOL[dtype] and lse_err <= TOL[dtype], (err, lse_err)


def _d128_check(kernel, gen):
    """``(error, tolerance)`` of one kernel at head dim 128 against
    its plain version: small ragged shapes, GQA 2 where the kernel takes it,
    the KV caches' kernels at folded decode."""
    bf16 = torch.bfloat16
    bwd = dict(flash_bwd_dkv=("dk", "dv"), flash_bwd_dq=("dq",), flash_bwd_fused=("dq", "dk", "dv"))
    if kernel == "flash_fwd":
        q, k, v = onchip.ladder_inputs((2, 4, 130, 128), (2, 2, 300, 128), bf16, gen)
        off = torch.tensor([0, 170], dtype=torch.int32, device="cuda")
        return max(onchip.kernel_error((q, k, v, off, 1))), TOL[bf16]
    if kernel in ("naive", "flash_lean", "flash_tri"):
        dtype = torch.float32 if kernel == "naive" else bf16
        kw = {"naive": dict(causal=True), "flash_lean": dict(causal=True, q_offset=100, save_lse=True),
              "flash_tri": dict(q_offset=170, save_lse=True)}[kernel]
        qkv = onchip.ladder_inputs((2, 2, 130, 128), (2, 2, 300, 128), dtype, gen)
        return max(onchip.ladder_fwd_error(kernel, qkv, kw)), TOL[dtype]
    if kernel in ("flash_v1", "flash_v1_folded"):
        shape = (1, 2, 1024, 128) if kernel == "flash_v1" else (8, 1, 128, 128)
        assert onchip.v1_kernel(shape) == kernel
        qkv = onchip.ladder_inputs(shape, shape, torch.float32, gen)
        return onchip.v1_error(qkv, True), TOL[torch.float32]
    if kernel == "flash_tri_bwd":
        q, k, v = onchip.ladder_inputs((2, 2, 130, 128), (2, 2, 300, 128), bf16, gen)
        do = onchip.ladder_inputs((2, 2, 130, 128), (2, 2, 300, 128), bf16, gen)[0]
        o, lse = ft.flash_attention_tri(q, k, v, q_offset=170, save_lse=True)
        errs = onchip.tri_bwd_errors((q, k, v, o, do, lse, 170))
        return max(r for _, r in errs.values()), BWD_TOL[bf16]
    if kernel in bwd:
        q, k, v = onchip.ladder_inputs((2, 4, 1000, 128), (2, 2, 1000, 128), bf16, gen)
        do = onchip.ladder_inputs((2, 4, 1000, 128), (2, 2, 1000, 128), bf16, gen)[0]
        off = torch.tensor([0, 100], dtype=torch.int32, device="cuda")
        errs = onchip.bwd_kernel_errors(onchip.bwd_inputs((q, k, v, do, off)),
                                        fused=kernel == "flash_bwd_fused")
        return max(errs[g][1] for g in bwd[kernel]), BWD_TOL[bf16]
    if kernel in onchip.KV_KERNELS:
        (_, args, pos_div), = [c for c in onchip.kv_d128_cases(gen).values() if c[0] == kernel]
        return max(onchip.kv_kernel_error(kernel, args, pos_div)), TOL[bf16]
    bm = fm.BlockMask(SPARSE_MASKS["rung11"], SPARSE_N, SPARSE_N, 128, 128)
    q, k, v = onchip.ladder_inputs((2, 4, SPARSE_N, 128), (2, 2, SPARSE_N, 128), bf16, gen)
    do = onchip.ladder_inputs((2, 4, SPARSE_N, 128), (2, 2, SPARSE_N, 128), bf16, gen)[0]
    errs = onchip.sparse_kernel_errors((q, k, v, do, bm))
    out = {"flash_sparse_fwd": ("o", TOL), "flash_sparse_dkv": ("dk", BWD_TOL),
           "flash_sparse_dq": ("dq", BWD_TOL)}[kernel]
    err = max(errs["o"]) if out[0] == "o" else max(errs["dk"][1], errs["dv"][1]) \
        if out[0] == "dk" else errs["dq"][1]
    return err, out[1][bf16]


# Each kernel's launch counter (its wrapper).
D128_COUNTERS = {
    "flash_fwd": ff.flash_fwd_general, "flash_lean": ff.flash_fwd_lean,
    "flash_tri": ft.flash_attention_tri, "flash_tri_bwd": ft.flash_attention_bwd_tri,
    "flash_bwd_dkv": fb.flash_bwd_dkv, "flash_bwd_dq": fb.flash_bwd_dq,
    "flash_bwd_fused": fb.flash_bwd_fused, "naive": nv.naive_attention, "flash_v1": fv.flash_v1_stream,
    "flash_v1_folded": fv.flash_v1_folded, "flash_quant": qt.flash_attention_quant,
    "flash_paged": pg.flash_attention_paged, "flash_paged_quant": pg.flash_attention_paged_quant,
    "flash_sparse_fwd": fm.flash_sparse_fwd, "flash_sparse_dkv": fm.flash_sparse_dkv,
    "flash_sparse_dq": fm.flash_sparse_dq,
}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(D128_COUNTERS))
def test_every_kernel_takes_head_dim_128(cuda, kernel):
    """Each of the 16 kernels is built for head dim 128: its wrapper
    launches it (its count moves) and it matches its plain version within
    the check's tolerance."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    before = D128_COUNTERS[kernel].launches
    err, tol = _d128_check(kernel, gen)
    assert D128_COUNTERS[kernel].launches > before
    assert err <= tol, (kernel, err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_fp16_grads_through_flash_attention(cuda, causal):
    """fp16 CUDA tensors through the op: the forward and both backward
    kernels run in fp32 on casts, the gradients come back fp16 and equal
    the plain fp32 gradient rounded to fp16 within 2e-3 of its max-abs
    (fp32 kernel sums vs plain sums, then one fp16 rounding each)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = onchip.ladder_inputs((2, 4, 256, 64), (2, 2, 256, 64), torch.float16, gen)
    do = onchip.ladder_inputs((2, 4, 256, 64), (2, 2, 256, 64), torch.float16, gen)[0]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches)
    got = torch.autograd.grad(flash_attention(*leaves, causal=causal), leaves, do)
    assert (fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention(*leaves, causal=causal, impl="reference"),
                               leaves, do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.float16
        w16 = w.half().float()
        assert float((g.float() - w16).abs().max() / w16.abs().max()) <= 2e-3


# ---------------------------------------------------------------------------
# Block-sparse attention (csrc/flash_mask.cu): forward, dK/dV and dQ.
# ---------------------------------------------------------------------------

SPARSE_N = 512
SPARSE_MASKS = {
    "banded-stripes": lambda r, c: (c <= r) & (((r - c) < 96) | ((c % 192) < 64)),
    "chunked-local": lambda r, c: (r // 160) == (c // 160),
    "dead-rows": lambda r, c: (r >= 64) & (c <= r),
    "rung11": lambda r, c: (c <= r) & (((r - c) < SPARSE_N // 4)
                                       | ((c % (3 * SPARSE_N // 8)) < SPARSE_N // 8)),
    # a long transposed list: every row sees the first 64 columns, plus a
    # band, so the bf16 dK/dV plan splits KV tile 0's walk
    "long-list": lambda r, c: (c < 64) | ((c <= r) & (r - c < 64)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fixture", ["ladder", "peaked"])
@pytest.mark.parametrize("mask", sorted(SPARSE_MASKS))
def test_sparse_kernels_match_plain(cuda, mask, fixture, dtype, head_dim):
    """Each sparse kernel against its plain version (GQA 2, one launch
    each); dead rows give o = 0, lse = -inf and zero dQ; the long list's
    dK/dV walk is split in bf16 (more chunks than KV tiles)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bm = fm.BlockMask(SPARSE_MASKS[mask], SPARSE_N, SPARSE_N, 128, 128)
    shape_q, shape_kv = (2, 4, SPARSE_N, head_dim), (2, 2, SPARSE_N, head_dim)
    scale = onchip.PEAKED_Q_SCALE if fixture == "peaked" else 1.0
    q, k, v = onchip.ladder_inputs(shape_q, shape_kv, dtype, gen, scale)
    do = onchip.ladder_inputs(shape_q, shape_kv, dtype, gen)[0]
    counters = (fm.flash_sparse_fwd, fm.flash_sparse_dkv, fm.flash_sparse_dq)
    before = [c.launches for c in counters]
    errors = onchip.sparse_kernel_errors((q, k, v, do, bm))
    assert [c.launches for c in counters] == [n + 1 for n in before]
    assert max(errors["o"]) <= TOL[dtype], errors
    assert max(errors[g][1] for g in ("dq", "dk", "dv")) <= BWD_TOL[dtype], errors
    if mask == "long-list" and dtype == torch.bfloat16:
        assert fm.flash_sparse_dkv.grid.chunks > len(bm.kv_lengths), fm.flash_sparse_dkv.grid
    if mask == "dead-rows":
        o, lse = fm.flash_attention_block_sparse_fwd(q, k, v, bm, save_lse=True)
        assert torch.all(o[:, :, :64] == 0) and torch.all(torch.isneginf(lse[:, :, :64]))
        dq = fm.flash_attention_block_sparse_bwd(q, k, v, o, do, lse, bm)[0]
        assert torch.all(dq[:, :, :64] == 0) and bool(torch.isfinite(dq).all())


# Lengths that are not a multiple of the kernels' 64-row tiles: the edge
# tiles' bits past n are zero, so an edge pair is never full, even where
# every element is visible ("all"), and K/V rows past n never count.
RAGGED_MASKS = {
    "all": lambda r, c: (r >= 0) & (c >= 0),
    "causal-17": lambda r, c: c <= r + 17,
    "banded-stripes": SPARSE_MASKS["banded-stripes"],
}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [300, 568])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask", sorted(RAGGED_MASKS))
def test_sparse_kernels_match_plain_at_ragged_lengths(cuda, mask, dtype, head_dim, n):
    """Each sparse kernel against its plain version (GQA 2, one launch
    each) at a length whose last Q and KV tiles are part-filled."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bm = fm.BlockMask(RAGGED_MASKS[mask], n, n, 4, 4)
    shape_q, shape_kv = (2, 4, n, head_dim), (2, 2, n, head_dim)
    q, k, v = onchip.ladder_inputs(shape_q, shape_kv, dtype, gen)
    do = onchip.ladder_inputs(shape_q, shape_kv, dtype, gen)[0]
    counters = (fm.flash_sparse_fwd, fm.flash_sparse_dkv, fm.flash_sparse_dq)
    before = [c.launches for c in counters]
    errors = onchip.sparse_kernel_errors((q, k, v, do, bm))
    assert [c.launches for c in counters] == [b + 1 for b in before]
    assert max(errors["o"]) <= TOL[dtype], errors
    assert max(errors[g][1] for g in ("dq", "dk", "dv")) <= BWD_TOL[dtype], errors


@pytest.mark.gpu
def test_sparse_op_grads_on_the_card(cuda):
    """``torch.autograd.grad`` through ``block_sparse_attention`` launches
    the three kernels once each and matches the plain gradient (the chip
    smoke's check at a smaller shape)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bm = fm.BlockMask(SPARSE_MASKS["rung11"], SPARSE_N, SPARSE_N, 128, 128)
    q, k, v = onchip.ladder_inputs((2, 4, SPARSE_N, 64), (2, 2, SPARSE_N, 64), torch.bfloat16, gen)
    do = onchip.ladder_inputs((2, 4, SPARSE_N, 64), (2, 2, SPARSE_N, 64), torch.bfloat16, gen)[0]
    counters = (fm.flash_sparse_fwd, fm.flash_sparse_dkv, fm.flash_sparse_dq)
    before = [c.launches for c in counters]
    errors = onchip.sparse_op_grad_errors((q, k, v, do, bm))
    assert [c.launches for c in counters] == [n + 1 for n in before]
    assert max(errors.values()) <= BWD_TOL[torch.bfloat16], errors


@pytest.mark.gpu
def test_sparse_kernels_are_deterministic(cuda):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bm = fm.BlockMask(SPARSE_MASKS["rung11"], SPARSE_N, SPARSE_N, 128, 128)
    q, k, v = onchip.ladder_inputs((2, 8, SPARSE_N, 64), (2, 2, SPARSE_N, 64), torch.bfloat16, gen)
    o, lse = fm.flash_attention_block_sparse_fwd(q, k, v, bm, save_lse=True)
    first = fm.flash_attention_block_sparse_bwd(q, k, v, o, q, lse, bm)
    second = fm.flash_attention_block_sparse_bwd(q, k, v, o, q, lse, bm)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_sparse_kernels_reject_what_they_do_not_take(cuda):
    bm = fm.BlockMask(SPARSE_MASKS["rung11"], SPARSE_N, SPARSE_N, 128, 128)
    q = torch.zeros((1, 2, SPARSE_N, 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fm.block_sparse_attention(q, q, q, bm)
    q = torch.zeros((1, 2, SPARSE_N, 64), device=cuda)
    with pytest.raises(TypeError):
        fm.flash_sparse_fwd(q, q.bfloat16(), q, bm, sm_scale=0.125)
    with pytest.raises(ValueError, match="mask compiled"):
        fm.block_sparse_attention(q[:, :, :256], q[:, :, :256], q[:, :, :256], bm)


# Faults planted in a copy of csrc/ and built into flash_mask.cu: (source,
# {sparse_cases name: the outputs whose check must fail there}, text,
# replacement).  The bf16 forward runs the dense forward's mainloop on its
# sparse walk (flash_fwd_sm90.cuh), the bf16 backward the split pair's
# (flash_bwd_sm90.cuh); fp32 keeps the first-generation template
# (flash_mask.cu), whose faults fail on the one case that still runs it.
# The cases run in the order given, on inputs no earlier check has computed.
_BF16 = {"sparse_bf16": ("dq", "dk", "dv"), "sparse_bf16_peaked": ("dq", "dk", "dv")}
_SPLIT = {"sparse_bf16_d128": ("dk", "dv"), "sparse_bf16_d128_peaked": ("dk", "dv")}
_FWD = {n: ("o",) for n in ("sparse_bf16", "sparse_bf16_peaked", "sparse_bf16_d128")}
PLANTED_SPARSE_FAULTS = {
    # the dK/dV walk takes each chunk one pair short: an unsplit tile drops
    # its last q-head's last list entry (dV moves by 8.8e-3 of its max on
    # the ladder fixture, under the bound; dK fails)
    "dkv_q_entry_dropped": ("flash_bwd_sm90.cuh", {"sparse_bf16": ("dk",),
                                                   "sparse_bf16_peaked": ("dk", "dv")},
                            "n_steps = (e[2] - e[1]) * kSub;",
                            "n_steps = (e[2] - e[1] - 1) * kSub;"),
    # the dQ kernel walks each Q tile's KV list one entry short
    "dq_kv_entry_dropped": ("flash_bwd_sm90.cuh", {n: ("dq",) for n in _BF16},
                            "n_steps = walk.ptr[q_tile + 1] - first;",
                            "n_steps = walk.ptr[q_tile + 1] - first - 1;"),
    # every partial pair's mask read one column off
    "mask_bit_off_by_one": ("flash_bwd_sm90.cuh", _BF16,
                            "return (bits[row * 2 + (col >> 5)] >> (col & 31)) & 1u;",
                            "return (bits[row * 2 + (col >> 5)] >> ((col + 1) & 31)) & 1u;"),
    # a partial dK/dV step tests the bit rows of the other ring stage
    "stale_bit_stage": ("flash_bwd_sm90.cuh", {n: ("dk", "dv") for n in _BF16},
                        "const uint32_t* step_bits = sm.bits[s];",
                        "const uint32_t* step_bits = sm.bits[s ^ 1];"),
    # the merge of a split tile leaves out its last chunk
    "merge_drops_last_chunk": ("flash_bwd_sm90.cuh", _SPLIT,
                               "c < n_chunks; ++c) {  // in chunk order",
                               "c < n_chunks - 1; ++c) {  // in chunk order"),
    # the merging block adds its own chunk twice
    "merge_adds_a_chunk_twice": ("flash_bwd_sm90.cuh", _SPLIT, "float sk = 0.0f, sv = 0.0f;",
                                 "float sk = dk[i], sv = dv[i];"),
    # the merging block leaves its ticket set: the first call is right, the
    # second finds no last chunk and stores no split tile
    "ticket_not_reset": ("flash_bwd_sm90.cuh", {"sparse_bf16_d128": (),
                                                "sparse_bf16_d128_peaked": ("dk", "dv")},
                         "if (tid == 0) tickets[ticket] = 0;", ""),
    # the bf16 forward walks each Q tile's KV list one entry short
    "fwd_sparse_entry_dropped": ("flash_fwd_sm90.cuh", _FWD,
                                 "n_steps = w.q_ptr[tile + 1] - first;",
                                 "n_steps = w.q_ptr[tile + 1] - first - 1;"),
    # the bf16 forward reads every partial pair's mask one column off
    "fwd_mask_bit_off_by_one": ("flash_fwd_sm90.cuh", _FWD, "(8 * (j & 3) + (e & 1))",
                                "(8 * (j & 3) + (e & 1) + 1)"),
    # the bf16 forward tests step i + 1 against the bit stage of step i
    "fwd_stale_bit_stage": ("flash_fwd_sm90.cuh", _FWD, "sm.bits[(i + 1) % kStages]",
                            "sm.bits[i % kStages]"),
    # the bf16 forward takes the first partial pair (bit tile 0: Q tile 0's
    # diagonal under rung 11's mask) for a full one
    "fwd_partial_pair_full": ("flash_fwd_sm90.cuh", _FWD, "m.full = entry.y < 0;",
                              "m.full = entry.y <= 0;"),
    # the fp32 template's forward walks each Q tile's KV list one entry short
    "fwd_kv_entry_dropped": ("flash_mask.cu", {"sparse_fp32_n512": ("o",)},
                             "e < last; ++e) {  // the Q tile's KV list",
                             "e < last - 1; ++e) {  // the Q tile's KV list"),
    # the fp32 dQ template walks each Q tile's KV list one entry short
    "template_dq_kv_entry_dropped": ("flash_mask.cu", {"sparse_fp32_n512": ("dq",)},
                                     "e < last; ++e) {  // the KV list again",
                                     "e < last - 1; ++e) {  // the KV list again"),
    # the fp32 dK/dV template walks each transposed Q list one entry short
    "template_dkv_q_entry_dropped": ("flash_mask.cu", {"sparse_fp32_n512": ("dk", "dv")},
                                     "e < last; ++e) {  // the transposed Q list",
                                     "e < last - 1; ++e) {  // the transposed Q list"),
    # the fp32 template's mask words (the forward and the backward) one
    # column off
    "template_mask_bit_off_by_one": (
        "flash_mask.cu", {"sparse_fp32_n512": ("o", "dq", "dk", "dv")},
        "bit_tiles[((size_t)bits * kTile + r) * kBitWords + half];",
        "(bit_tiles[((size_t)bits * kTile + r) * kBitWords + half] << 1);"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_SPARSE_FAULTS))
def test_planted_sparse_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's block-sparse checks (rung 11's mask: the training
    shape on the ladder and peaked fixtures, fp32 at N = 512, head dim 128
    where the dK/dV plan splits) fail a copy with a planted fault on each
    case it reaches, and pass the kernels as built (errors printed with
    ``-s``).  The planted copy runs first, on inputs seeded apart from
    every other check, so a split tile that it never stores cannot hold a
    right answer left by an earlier call; each library gets fresh tickets."""
    source, reach, old, new = PLANTED_SPARSE_FAULTS[fault]
    lib = fm.bind(_planted_library(tmp_path, "flash_mask.cu", source, old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED + 1)
    cases = onchip.sparse_cases(gen)

    def worst(errs, out):
        return max(errs["o"]) if out == "o" else errs[out][1]

    monkeypatch.setattr(ff, "_TICKETS", {})
    with monkeypatch.context() as m:
        m.setattr(fm, "_lib", lambda: lib)
        faulty = {n: onchip.sparse_kernel_errors(cases[n]) for n in reach}
    monkeypatch.setattr(ff, "_TICKETS", {})
    clean = {n: onchip.sparse_kernel_errors(cases[n]) for n in reach}
    print(f"\n{fault} ({source}), worst error built -> planted:\n" + "\n".join(
        f"  {n}: " + ", ".join(f"{out} {worst(clean[n], out):.3e} -> {worst(faulty[n], out):.3e}"
                               for out in ("o", "dq", "dk", "dv")) for n in reach))
    for n, outputs in reach.items():
        dtype = cases[n][0].dtype
        tol = {"o": TOL[dtype], "dq": BWD_TOL[dtype], "dk": BWD_TOL[dtype], "dv": BWD_TOL[dtype]}
        assert all(worst(clean[n], out) <= tol[out] for out in tol), (n, clean[n])
        for out in outputs:
            assert not worst(faulty[n], out) <= tol[out], (n, out)


# ---------------------------------------------------------------------------
# The sliding window with attention sinks, and segment ids (rows 1, 5-7 and
# 11-13): each windowed and segmented kernel against its plain version
# (onchip.WINDOW_*_CASES: the training, prefill and decode shapes, head dim
# 64 and 128, bf16 and fp32, the ladder, peaked and spike fixtures, a window
# ending mid-tile, a sink tile far left of it, decode splits wholly outside
# the window), then planted faults.

WINDOW_FWD_NAMES = [c[0] for c in onchip.WINDOW_FWD_CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("name", WINDOW_FWD_NAMES)
def test_window_forward_matches_plain(cuda, name):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    case = onchip.window_fwd_cases(gen, (name,))[name]
    err, lse_err = onchip.window_fwd_error(case)
    tol = TOL[case[0].dtype]
    print(f"\n{name}: o {err:.3e}, lse {lse_err:.3e}")
    assert err <= tol and lse_err <= tol, (err, lse_err)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("name,with_fused", onchip.WINDOW_BWD_CASES)
def test_window_bwd_matches_plain(cuda, name, with_fused, fused):
    if fused and not with_fused:
        pytest.skip("the split pair alone on this fixture")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    inputs = onchip.window_bwd_inputs(onchip.window_fwd_cases(gen, (name,))[name], gen)
    errs = onchip.window_bwd_errors(inputs, fused=fused)
    print(f"\n{name} {'fused' if fused else 'split'}: "
          + ", ".join(f"{g} {a:.3e} rel {r:.3e}" for g, (a, r) in errs.items()))
    assert all(rel <= BWD_TOL[inputs[0].dtype] for _, rel in errs.values()), errs


@pytest.mark.gpu
def test_window_bwd_kernels_are_deterministic(cuda):
    """The windowed split pair and the fused kernel's ordered dQ adds (over
    a Q tile's sink and window tiles) give the same bits on every run."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    q, k, v, o, do, lse, off, feats = onchip.window_bwd_inputs(
        onchip.window_fwd_cases(gen, ("train_w500_s70_bf16",))["train_w500_s70_bf16"], gen)
    for fn, kw in ((fb.flash_attention_bwd, {}), (fb.flash_attention_bwd_fused, {"q_offset_max": 0})):
        runs = [fn(q, k, v, o, do, lse, off, **kw, **feats) for _ in range(3)]
        assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))


@pytest.mark.gpu
@pytest.mark.parametrize("name,window,sinks", onchip.WINDOW_KV_CASES)
def test_window_kv_kernels_match_plain(cuda, name, window, sinks):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = {**onchip.kv_cases(gen), **onchip.kv_d128_cases(gen)}
    kernel, args, pos_div = cases[name]
    err, lse_err = onchip.kv_kernel_error(kernel, args, pos_div, window=window, sinks=sinks)
    print(f"\n{name} W {window} S {sinks}: o {err:.3e}, lse {lse_err:.3e}")
    assert err <= TOL[args[0].dtype] and lse_err <= TOL[args[0].dtype]


@pytest.mark.gpu
def test_window_skips_the_tiles_outside(cuda):
    """Out-of-window tiles are skipped, not masked: at N = 2048, W = 512 the
    windowed forward and split pair take well under the causal time."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    q, k, v, off, _, feats = onchip.window_fwd_cases(gen, ("train_w512_bf16",))["train_w512_bf16"]
    causal = onchip.device_ms(lambda: ff.flash_attention_fwd(q, k, v, off, causal=True))
    windowed = onchip.device_ms(lambda: ff.flash_attention_fwd(q, k, v, off, **feats))
    print(f"\nforward causal {causal:.4f} ms, W 512 {windowed:.4f} ms")
    assert windowed < 0.8 * causal


# (source, unit, kind, failing cases, old, new): each fault fails the
# checks of the cases that run it.
PLANTED_WINDOW_FAULTS = {
    # the window one column too wide: c >= p - window
    "window_off_by_one": ("window.cuh", "flash_fwd.cu", "fwd", ("train_w16_bf16_peaked",),
                          "return c > p - window || c < sinks;",
                          "return c >= p - window || c < sinks;"),
    # the walk leaves out the tiles of sinks (the columns stay "visible")
    "sink_tile_dropped": ("window.cuh", "flash_fwd.cu", "fwd", ("train_w500_s70_bf16",),
                          "const int n_sink = sink_tiles < end ? sink_tiles : end;",
                          "const int n_sink = 0;"),
    # a tile that crosses the window's edge taken as interior: out-of-window
    # columns the walk visits are not masked
    "out_of_window_tile_unmasked": (
        "flash_fwd_sm90.cuh", "flash_fwd.cu", "fwd", ("train_w512_bf16", "train_w16_bf16_peaked"),
        "tile_in_window(kv_start, kTile, q_start + kTile - 1 + off, window, sinks);", "true;"),
    # the dQ step reads the other ring stage's KV ids: the last step's
    "stale_kv_id_stage": ("flash_bwd_sm90.cuh", "flash_bwd.cu", "bwd", ("train_seg_bf16",),
                          "const uint32_t* pair_bits = sm.bits[s];",
                          "const uint32_t* pair_bits = sm.bits[s ^ 1];"),
    # an empty split's partial written with m = 0, not -inf: merged as a
    # zero score, its weight swamps splits whose scores are far below 0
    "empty_split_merged_as_zero": ("flash_decode.cuh", "flash_fwd.cu", "fwd",
                                   ("decode_w64_bf16_negative",),
                                   "part_m[p] = mb;", "part_m[p] = mb == -INFINITY ? 0.0f : mb;"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_WINDOW_FAULTS))
def test_planted_window_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's windowed checks pass the kernels as built and fail a
    copy with a planted fault (errors printed with ``-s``)."""
    source, unit, kind, failing, old, new = PLANTED_WINDOW_FAULTS[fault]
    mod = ff if kind == "fwd" else fb
    lib = mod.bind(_planted_library(tmp_path, unit, source, old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.window_fwd_cases(gen, failing)

    def check():
        if kind == "fwd":
            return {n: max(onchip.window_fwd_error(c)) for n, c in cases.items()}
        gen.manual_seed(onchip.SEED + 1)
        return {n: max(rel for _, rel in onchip.window_bwd_errors(
            onchip.window_bwd_inputs(c, gen)).values()) for n, c in cases.items()}

    clean = check()
    monkeypatch.setattr(mod, "_lib", lambda: lib)
    faulty = check()
    print(f"\n{fault}, worst error, built -> planted: "
          + ", ".join(f"{n} {clean[n]:.3e} -> {faulty[n]:.3e}" for n in failing))
    for n in failing:
        tol = TOL[cases[n][0].dtype]
        assert clean[n] <= tol
        assert not faulty[n] <= tol, n


# The score transforms, the tanh softcap and ALiBi (rows 1, 5-6 and 11-13):
# each transformed kernel against its plain version (onchip.XF_*_CASES: the
# training, prefill and decode shapes, head dim 64 and 128, bf16 and fp32,
# the ladder, peaked and spike fixtures, caps 0.5 to 30, standard, large and
# small slopes, composed with the window, sinks and segment ids, per-batch
# offsets, not causal), then planted faults.

XF_FWD_NAMES = [c[0] for c in onchip.XF_FWD_CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("name", XF_FWD_NAMES)
def test_xf_forward_matches_plain(cuda, name):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    case = onchip.xf_fwd_cases(gen, (name,))[name]
    err, lse_err = onchip.window_fwd_error(case)
    tol = TOL[case[0].dtype]
    print(f"\n{name}: o {err:.3e}, lse {lse_err:.3e}")
    assert err <= tol and lse_err <= tol, (err, lse_err)


@pytest.mark.gpu
@pytest.mark.parametrize("name", onchip.XF_BWD_CASES)
def test_xf_bwd_matches_plain(cuda, name):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    inputs = onchip.window_bwd_inputs(onchip.xf_fwd_cases(gen, (name,))[name], gen)
    errs = onchip.window_bwd_errors(inputs)
    print(f"\n{name}: " + ", ".join(f"{g} {a:.3e} rel {r:.3e}" for g, (a, r) in errs.items()))
    assert all(rel <= onchip.bwd_limit(g, inputs[0].dtype) for g, (_, rel) in errs.items()), errs


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["train_both_bf16_peaked", "fp32_n512_both"])
def test_xf_d_slopes_per_head(cuda, name):
    """Each q-head's d_slopes from the kernel within ``DSLOPE_HEAD_TOL`` of
    the size of its own terms (the sum of |dS * distance|) of the plain
    version's: the kernel's, the plain version's and the size printed head
    by head with ``-s``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    inputs = onchip.window_bwd_inputs(onchip.xf_fwd_cases(gen, (name,))[name], gen)
    got, want, sizes = onchip.dslope_heads(inputs)
    print(f"\n{name} d_slopes per head (kernel / plain / size of the terms):\n"
          + "\n".join(f"  h{h}: {g:.7e} / {w:.7e} / {z:.4e}"
                      for h, (g, w, z) in enumerate(zip(got, want, sizes))))
    tol = onchip.DSLOPE_HEAD_TOL[inputs[0].dtype]
    assert all(abs(g - w) <= tol * z for g, w, z in zip(got, want, sizes)), (got, want, sizes)


@pytest.mark.gpu
def test_xf_fp32_far_rows_hold_the_lse_scaled_limit(cuda):
    """The fp32 forward and split pair on rows far past the cache
    (``onchip.XF_FAR_FP32``) within their limit scaled to the lse."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    errs = onchip.xf_far_errors(gen)
    print("\n" + ", ".join(f"{g} {e:.3e} (limit {lim:.3e})" for g, (e, lim) in errs.items()))
    assert all(e <= lim for e, lim in errs.values()), errs


@pytest.mark.gpu
def test_xf_bwd_is_deterministic_and_declines_fused(cuda, tmp_path, monkeypatch):
    """The transformed split pair (d_slopes included) gives the same bits
    on every run, and the router takes it under a saved "fused" decision."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    q, k, v, o, do, lse, off, feats = onchip.window_bwd_inputs(
        onchip.xf_fwd_cases(gen, ("train_both_bf16_peaked",))["train_both_bf16_peaked"], gen)
    runs = [fb.flash_attention_bwd(q, k, v, o, do, lse, off, **feats) for _ in range(3)]
    assert len(runs[0]) == 4
    assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))
    cache = tmp_path / "fused.json"
    b, h, n, d = q.shape
    autotune.record_bwd((b, h, k.shape[1], n, d), "fused", {}, cache_path=str(cache))
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", str(cache))
    autotune.reset_memo()
    counts = (fb.flash_bwd_fused.launches, fb.flash_bwd_dkv.launches)
    got = fb.flash_attention_bwd_auto(q, k, v, o, do, lse, off, **feats)
    autotune.reset_memo()
    assert fb.flash_bwd_fused.launches == counts[0] and fb.flash_bwd_dkv.launches == counts[1] + 1
    assert all(torch.equal(a, b) for a, b in zip(runs[0], got))


@pytest.mark.gpu
@pytest.mark.parametrize("name,unfold,feats", onchip.XF_KV_CASES)
def test_xf_kv_kernels_match_plain(cuda, name, unfold, feats):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = {**onchip.kv_cases(gen), **onchip.kv_d128_cases(gen)}
    kernel, args, pos_div, kw = onchip.xf_kv_case(cases, name, unfold, feats)
    err, lse_err = onchip.kv_kernel_error(kernel, args, pos_div, **kw)
    print(f"\n{name} {feats}{' unfolded' if unfold else ''}: o {err:.3e}, lse {lse_err:.3e}")
    assert err <= TOL[args[0].dtype] and lse_err <= TOL[args[0].dtype]


@pytest.mark.gpu
def test_xf_entries_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 4, 64, 64), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 4, 64), device=cuda)
    slopes = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="softcap"):
        ff.flash_attention_fwd(q, q, q, causal=True, softcap=0.0)
    with pytest.raises(ValueError, match="alibi_slopes"):
        ff.flash_attention_fwd(q, q, q, causal=True, alibi_slopes=torch.ones(3, device=cuda))
    with pytest.raises(NotImplementedError, match="pos_div"):
        ff.flash_attention_fwd(q, q[:, :2], q[:, :2], causal=True, pos_div=2, alibi_slopes=slopes)
    with pytest.raises(NotImplementedError, match="fused"):
        fb.flash_attention_bwd_fused(q, q, q, q, q, lse, causal=True, alibi_slopes=slopes)
    # Dropout runs (test_drop_*): it takes no row fold and needs its seed.
    assert ff.flash_attention_fwd(q, q, q, causal=True, dropout_rate=0.1,
                                  dropout_seed=3).shape == q.shape
    with pytest.raises(NotImplementedError, match="pos_div"):
        ff.flash_attention_fwd(q, q[:, :2], q[:, :2], causal=True, pos_div=2, dropout_rate=0.1,
                               dropout_seed=3)
    with pytest.raises(ValueError, match="dropout_seed"):
        ff.flash_attention_fwd(q, q, q, causal=True, dropout_rate=0.1)
    # A position map takes no row fold, as in JAX.
    with pytest.raises(NotImplementedError, match="pos_div"):
        ff.flash_attention_fwd(q, q[:, :2], q[:, :2], causal=True, pos_div=2,
                               kv_positions=torch.zeros((q.shape[0], q.shape[2]),
                                                        dtype=torch.int32))


@pytest.mark.gpu
def test_xf_tanh_choice(cuda, tmp_path, monkeypatch):
    """The bf16 kernels' tanh (tanh.approx.f32, one MUFU op) holds the bound
    on the peaked fixture at caps 20 and 30; beside it the two-op 1 - 2 /
    (2^(2x log2 e) + 1) on ex2 and rcp in its place, the more exact, printed
    with -s (o and lse errors of each: the reason for the choice)."""
    names = ("train_cap20_bf16_peaked", "train_cap30_bf16_peaked", "train_both_bf16_peaked")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.xf_fwd_cases(gen, names)
    built = {n: onchip.window_fwd_error(c) for n, c in cases.items()}
    exact = ('    asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));\n    return y;',
             '    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"((2.0f * kXfLog2e) * '
             'fminf(fmaxf(x, -20.0f), 20.0f)));\n    return 1.0f - __fdividef(2.0f, y + 1.0f);')
    lib = ff.bind(_planted_library(tmp_path, "flash_fwd.cu", "xf.cuh", *exact))
    monkeypatch.setattr(ff, "_lib", lambda: lib)
    other = {n: onchip.window_fwd_error(c) for n, c in cases.items()}
    print("\ntanh.approx.f32 vs ex2+rcp, error of o and of the lse: "
          + ", ".join(f"{n} o {built[n][0]:.3e} vs {other[n][0]:.3e}, lse {built[n][1]:.3e} vs "
                      f"{other[n][1]:.3e}" for n in names))
    assert all(max(err) <= TOL[torch.bfloat16] for err in built.values())


# (source, unit, kind, failing cases, old, new): each fault fails the
# checks of the cases that run it.
PLANTED_XF_FAULTS = {
    # o and l not rescaled when the running max rises between KV tiles, in
    # the wgmma forward's softmax that the transformed walks share
    # (PLANTED_SM90_FWD_FAULTS' no_rescale, held here on transformed cases)
    "xf_no_rescale": ("flash_fwd_sm90.cuh", "flash_fwd.cu", "fwd",
                      ("train_cap30_bf16_peaked", "train_both_bf16_peaked"),
                      "alpha[half] = exp2f(m_i[half] - m_ref[half]);", "alpha[half] = 1.0f;"),
    # the cap applied to the log2-scaled score: cap * tanh(s2 / cap) in
    # place of c2 * tanh(s2 / c2)
    "cap_on_log2_score": (
        "xf.cuh", "flash_fwd.cu", "fwd", ("train_cap30_bf16_peaked",),
        "    pre = cap ? sm_scale / softcap : sm_scale * kXfLog2e;\n"
        "    c2 = cap ? softcap * kXfLog2e : 0.0f;",
        "    pre = cap ? sm_scale * kXfLog2e / softcap : sm_scale * kXfLog2e;\n"
        "    c2 = cap ? softcap : 0.0f;"),
    # ALiBi's row position without the batch's offset
    "alibi_row_without_offset": (
        "flash_fwd_sm90.cuh", "flash_fwd.cu", "fwd",
        ("prefill_both_bf16_off512", "train_both_offs_bf16"),
        "xoff = w.q_offset != nullptr ? w.q_offset[b] : w.fixed_offset;", "xoff = 0;"),
    # dS without the softcap's chain 1 - u^2
    "softcap_chain_dropped": ("xf.cuh", "flash_bwd.cu", "bwd",
                              ("train_cap30_bf16_peaked", "train_cap05_bf16_peaked"),
                              "return 1.0f - u * u;", "return 1.0f;"),
    # d_slopes summed from dS after the chain, not before
    "dslopes_after_chain": ("flash_bwd_sm90.cuh", "flash_bwd.cu", "bwd",
                            ("train_cap05_alibi_bf16_peaked",),
                            "dslope = fmaf(dpt[4 * j + e], dist, dslope);",
                            "dslope = fmaf(dpt[4 * j + e] * chain, dist, dslope);"),
    # d_slopes gathered per KV head: the group's q-heads summed into one
    # partial (the training shape is GQA 2)
    "dslopes_per_kv_head": (
        "flash_bwd_sm90.cuh", "flash_bwd.cu", "bwd", ("train_alibi_bf16",),
        "      if (walk.dslope != nullptr && (i + 1) % blk.per_head == 0) {\n"
        "        const size_t at = (((size_t)b * a.n_heads + h_kv * group + st.g) * gridDim.y +",
        "      if (walk.dslope != nullptr && i + 1 == n_steps) {\n"
        "        const size_t at = (((size_t)b * a.n_heads + h_kv * group) * gridDim.y +"),
    # the KV head's slope for each of its q-heads (dQ)
    "kv_head_slope": ("flash_bwd_sm90.cuh", "flash_bwd.cu", "bwd", ("train_alibi_bf16",),
                      "xf = XfHead(walk.softcap, walk.slopes, blk.bh % a.n_heads, a.sm_scale);",
                      "xf = XfHead(walk.softcap, walk.slopes, h_kv, a.sm_scale);"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_XF_FAULTS))
def test_planted_xf_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's transform checks pass the kernels as built and fail a
    copy with a planted fault (errors printed with ``-s``)."""
    source, unit, kind, failing, old, new = PLANTED_XF_FAULTS[fault]
    mod = ff if kind == "fwd" else fb
    lib = mod.bind(_planted_library(tmp_path, unit, source, old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.xf_fwd_cases(gen, failing)

    def check():
        if kind == "fwd":
            return {n: max(onchip.window_fwd_error(c)) for n, c in cases.items()}
        gen.manual_seed(onchip.SEED + 1)
        return {n: max(rel for _, rel in onchip.window_bwd_errors(
            onchip.window_bwd_inputs(c, gen)).values()) for n, c in cases.items()}

    clean = check()
    monkeypatch.setattr(mod, "_lib", lambda: lib)
    faulty = check()
    print(f"\n{fault}, worst error, built -> planted: "
          + ", ".join(f"{n} {clean[n]:.3e} -> {faulty[n]:.3e}" for n in failing))
    for n in failing:
        tol = TOL[cases[n][0].dtype]
        assert clean[n] <= tol
        assert not faulty[n] <= tol, n


# Attention dropout (rows 1, 5 and 6, `-k drop`): the keep mask bit for
# bit, each dropout kernel against its plain version (onchip.DROP_*_CASES:
# the training shape, D 64 and 128, bf16 and fp32, ladder, peaked and spike
# fixtures, with the window, sinks, softcap and ALiBi together, segment
# ids, shard offsets, per-batch offsets, not causal, one decode token),
# determinism and the declined "fused" decision, the parent's instances at
# their registers and spills, then planted faults.

@pytest.mark.gpu
@pytest.mark.parametrize("name", [c[0] for c in onchip.MASK_CASES])
def test_drop_mask_is_bit_exact(cuda, name):
    """The forward kernel's keep mask (q = k = 0, V the identity: o * n_kv
    is the mask) equal to ``_common.keep_factors`` bit for bit."""
    got, want = onchip.dropout_mask(name)
    print(f"\n{name}: {int((got != want).sum())} of {got.numel()} differ, kept "
          f"{float((want > 0).float().mean()):.4f}")
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c[0] for c in onchip.DROP_FWD_CASES])
def test_drop_forward_matches_plain(cuda, name):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    case = onchip.drop_fwd_cases(gen, (name,))[name]
    err, lse_err = onchip.window_fwd_error(case)
    tol = TOL[case[0].dtype]
    print(f"\n{name}: o {err:.3e}, lse {lse_err:.3e}")
    assert err <= tol and lse_err <= tol, (err, lse_err)


@pytest.mark.gpu
@pytest.mark.parametrize("name", onchip.DROP_BWD_CASES)
def test_drop_bwd_matches_plain(cuda, name):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    inputs = onchip.window_bwd_inputs(onchip.drop_fwd_cases(gen, (name,))[name], gen)
    errs = onchip.window_bwd_errors(inputs)
    print(f"\n{name}: " + ", ".join(f"{g} {a:.3e} rel {r:.3e}" for g, (a, r) in errs.items()))
    assert all(rel <= onchip.bwd_limit(g, inputs[0].dtype) for g, (_, rel) in errs.items()), errs


@pytest.mark.gpu
def test_drop_bwd_is_deterministic_and_declines_fused(cuda, tmp_path, monkeypatch):
    """The dropout split pair gives the same bits on every run, and the
    router takes it under a saved "fused" decision."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    name = "train_drop_bf16_peaked"
    q, k, v, o, do, lse, off, feats = onchip.window_bwd_inputs(
        onchip.drop_fwd_cases(gen, (name,))[name], gen)
    runs = [fb.flash_attention_bwd(q, k, v, o, do, lse, off, **feats) for _ in range(3)]
    assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))
    cache = tmp_path / "fused.json"
    b, h, n, d = q.shape
    autotune.record_bwd((b, h, k.shape[1], n, d), "fused", {}, cache_path=str(cache))
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", str(cache))
    autotune.reset_memo()
    counts = (fb.flash_bwd_fused.launches, fb.flash_bwd_dkv.launches)
    got = fb.flash_attention_bwd_auto(q, k, v, o, do, lse, off, **feats)
    autotune.reset_memo()
    assert fb.flash_bwd_fused.launches == counts[0] and fb.flash_bwd_dkv.launches == counts[1] + 1
    assert all(torch.equal(a, b) for a, b in zip(runs[0], got))


# The kernel instances that carry the dropout flag, by unit: the wgmma
# forward's featured walk and the split pair's transformed walk (each
# segmented and not, at D 64 and 128), and the fp32 forward and split
# pair's templates (D 64 and 128).
DROP_INSTANCES = {
    "flash_fwd.cu": (
        r"sm90::flash_fwd_sm90_kernel<(64|128), sm90::FeatWalk<(true|false), true, true> >",
        r"flash_fwd_kernel<float, float, false, (64|128), true, true, true>"),
    "flash_bwd.cu": (
        r"sm90::flash_bwd_dkv_sm90_kernel<(64|128), sm90::CausalWalkT<(true|false), true, true, true> >",
        r"sm90::flash_bwd_dq_sm90_kernel<(64|128), sm90::CausalWalkT<(true|false), true, true, true> >",
        r"flash_bwd_dkv_kernel<float, (64|128), false, true, true>",
        r"flash_bwd_dq_f32_kernel<(64|128), true, true>"),
}


@pytest.mark.gpu
def test_drop_instances_compile_and_the_unsegmented_wgmma_walks_spill_nothing(cuda):
    """Every dropout instance compiles (18: the wgmma walks segmented and
    not, the fp32 templates, each at D 64 and 128), and the unsegmented
    wgmma walks that the training path runs spill nothing.  Registers and
    spills of every one print with ``-s``; the instances without dropout
    are held against an earlier tree by ``onchip ptxas --csrc``."""
    found = {f"{r['unit']}|{r['kernel']}": r for r in onchip.ptxas_report()
             if any(re.fullmatch(pattern, r["kernel"])
                    for pattern in DROP_INSTANCES.get(r["unit"], ()))}
    print("\n" + "; ".join(
        f"{key} {[r[f] for f in ('registers', 'spill_stores', 'spill_loads', 'stack')]}"
        for key, r in sorted(found.items())))
    assert len(found) == 18, sorted(found)
    unsegmented = {key: (r["spill_stores"], r["spill_loads"]) for key, r in found.items()
                   if "Walk<false," in key or "WalkT<false," in key}
    assert len(unsegmented) == 6 and all(v == (0, 0) for v in unsegmented.values()), unsegmented


# (source, unit, kind, failing cases, old, new): each fault fails the
# checks of the cases that run it.
PLANTED_DROP_FAULTS = {
    # the forward hashes the row's position r + off, not its tensor row
    "hash_on_position": (
        "flash_fwd_sm90.cuh", "flash_fwd.cu", "fwd", ("train_drop_offs_bf16",),
        "drow[half] = drop.row_hash(head, q_start + row + half * 8);",
        "drow[half] = drop.row_hash(head, q_start + row + half * 8 + off);"),
    # an arithmetic shift in mix32 (the hash of a signed int)
    "arithmetic_shift": ("dropout.cuh", "flash_fwd.cu", "fwd", ("train_drop_bf16_peaked",),
                         "  x ^= x >> 16;\n  x *= kMixC;",
                         "  x ^= (uint32_t)((int32_t)x >> 16);\n  x *= kMixC;"),
    # the row sum l over the dropped P
    "row_sum_of_dropped_p": (
        "flash_fwd_sm90.cuh", "flash_fwd.cu", "fwd", ("train_drop_bf16_peaked",),
        "      sum[e >> 1] += p;\n      if constexpr (Mask::kDrop) p *= mask.keep(j, e);",
        "      if constexpr (Mask::kDrop) p *= mask.keep(j, e);\n      sum[e >> 1] += p;"),
    # dV from the undropped P
    "dv_from_undropped_p": ("flash_bwd_sm90.cuh", "flash_bwd.cu", "bwd",
                            ("train_drop_bf16_peaked",),
                            "          st_acc[4 * j + e] = p * keep;",
                            "          st_acc[4 * j + e] = p;"),
    # the dS bracket multiplied by the dropped P (dK/dV)
    "ds_with_dropped_p": (
        "flash_bwd_sm90.cuh", "flash_bwd.cu", "bwd", ("train_drop_bf16_peaked",),
        "          dpt[4 * j + e] = p * (dpt[4 * j + e] * keep - dlt[e & 1]);",
        "          dpt[4 * j + e] = p * keep * (dpt[4 * j + e] * keep - dlt[e & 1]);"),
    # dQ's dP left unmasked
    "dq_dp_unmasked": (
        "flash_bwd_sm90.cuh", "flash_bwd.cu", "bwd", ("train_drop_bf16_peaked",),
        "          dpt[4 * j + e] = p * (dpt[4 * j + e] * keep - dlt[e >> 1]);",
        "          dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt[e >> 1]);"),
    # dK/dV hashes the KV head, not the q-head, under GQA
    "bh_from_kv_head": (
        "flash_bwd_sm90.cuh", "flash_bwd.cu", "bwd", ("train_drop_bf16_peaked",),
        "if constexpr (Walk::kDrop) dhead = blk.drop.head_hash(h_kv * group + st.g);",
        "if constexpr (Walk::kDrop) dhead = blk.drop.head_hash(h_kv);"),
    # the packed row offset ignored
    "row_off_ignored": ("dropout.cuh", "flash_fwd.cu", "fwd", ("train_drop_shard_bf16",),
                        "    return mix32(head + ((uint32_t)r + row_off) * kMixB);",
                        "    return mix32(head + (uint32_t)r * kMixB);"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_DROP_FAULTS))
def test_drop_planted_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's dropout checks pass the kernels as built and fail a
    copy with a planted fault (errors printed with ``-s``)."""
    source, unit, kind, failing, old, new = PLANTED_DROP_FAULTS[fault]
    mod = ff if kind == "fwd" else fb
    lib = mod.bind(_planted_library(tmp_path, unit, source, old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.drop_fwd_cases(gen, failing)

    def check():
        if kind == "fwd":
            return {n: max(onchip.window_fwd_error(c)) for n, c in cases.items()}
        gen.manual_seed(onchip.SEED + 1)
        return {n: max(rel for _, rel in onchip.window_bwd_errors(
            onchip.window_bwd_inputs(c, gen)).values()) for n, c in cases.items()}

    clean = check()
    monkeypatch.setattr(mod, "_lib", lambda: lib)
    faulty = check()
    print(f"\n{fault}, worst error, built -> planted: "
          + ", ".join(f"{n} {clean[n]:.3e} -> {faulty[n]:.3e}" for n in failing))
    for n in failing:
        tol = TOL[cases[n][0].dtype]
        assert clean[n] <= tol
        assert not faulty[n] <= tol, n


# ---------------------------------------------------------------------------
# A rolling cache's position map (kv_positions) on rows 1 and 11: the wgmma
# forward's position walk, the fp32 / 8-bit template's and the decode grid's
# kPos instances against their plain versions (onchip.POS_CASES), planted
# faults; then the rest of one-device serving on the card (test_serve_*:
# the rolling caches, multi_step, speculative and beam decoding,
# snapshot/restore, weight-only int8).
# ---------------------------------------------------------------------------

POS_NAMES = [c[0] for c in onchip.POS_CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("name", POS_NAMES)
def test_pos_kernel_matches_plain(cuda, name):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    case = onchip.pos_cases(gen, (name,))[name]
    err, lse_err = onchip.pos_error(case)
    print(f"\n{name}: o {err:.3e}, lse {lse_err:.3e}")
    tol = TOL[case[1].dtype]
    assert err <= tol and lse_err <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c[0] for c in onchip.POS_SEG_CASES])
def test_pos_seg_kernel_matches_plain(cuda, name):
    """Positions with segment ids on the card (the segmented position walks:
    the wgmma forward's for bf16, decode-sized calls included, the
    template's for fp32) against the plain version, rows of an id no slot
    holds included (lse -inf on both sides)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    case = onchip.pos_cases(gen, (name,), onchip.POS_SEG_CASES)[name]
    before = ff.flash_fwd_general.pos_launches
    err, lse_err = onchip.pos_error(case)
    print(f"\n{name}: o {err:.3e}, lse {lse_err:.3e}")
    tol = TOL[case[1].dtype]
    assert ff.flash_fwd_general.pos_launches == before + 1
    assert err <= tol and lse_err <= tol


# (source, failing cases, old, new): a segmented position walk that
# ignores the ids, reads them from the positions' half of its stage, or
# tests both of a thread's rows against its first row's id.
PLANTED_POS_SEG_FAULTS = {
    "wgmma_seg_ignored": (
        "flash_fwd_sm90.cuh", ("pos_seg_prefill_bf16_peaked", "pos_seg_decode_bf16"),
        "if ((int)ids[j * 8 + (e & 1)] != qid[e >> 1]) return false;", "(void)0;"),
    "wgmma_seg_ids_from_positions": (
        "flash_fwd_sm90.cuh", ("pos_seg_prefill_bf16_peaked", "pos_seg_decode_bf16"),
        "bits + kTile + 2 * t,", "bits + 2 * t,"),
    "wgmma_seg_first_row_id": (
        "flash_fwd_sm90.cuh", ("pos_seg_prefill_bf16_peaked",),
        "if ((int)ids[j * 8 + (e & 1)] != qid[e >> 1]) return false;",
        "if ((int)ids[j * 8 + (e & 1)] != qid[0]) return false;"),
    "template_seg_ignored": (
        "flash_fwd.cu", ("pos_seg_prefill_fp32", "pos_seg_decode_fp32"),
        "if constexpr (kPosSeg) seen[j] = seen[j] && kids[c] == my_seg;", ""),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_POS_SEG_FAULTS))
def test_pos_seg_planted_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """The segmented position checks pass the kernels as built and fail a
    copy with a planted fault (errors printed with ``-s``)."""
    source, failing, old, new = PLANTED_POS_SEG_FAULTS[fault]
    lib = ff.bind(_planted_library(tmp_path, "flash_fwd.cu", source, old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.pos_cases(gen, failing, onchip.POS_SEG_CASES)
    clean = {n: max(onchip.pos_error(c)) for n, c in cases.items()}
    monkeypatch.setattr(ff, "_lib", lambda: lib)
    faulty = {n: max(onchip.pos_error(c)) for n, c in cases.items()}
    print(f"\n{fault}, worst error, built -> planted: "
          + ", ".join(f"{n} {clean[n]:.3e} -> {faulty[n]:.3e}" for n in failing))
    for n in failing:
        tol = TOL[cases[n][1].dtype]
        assert clean[n] <= tol
        assert not faulty[n] <= tol, n


# (source, failing cases, old, new): each fault fails the checks of the
# cases that run its instance (the decode grid: decode rows; the wgmma
# position walk: bf16 prefill; the template: fp32 and 8-bit prefill).
PLANTED_POS_FAULTS = {
    # the slot index used as the column's position
    "decode_slot_index_for_position": (
        "flash_decode.cuh", ("pos_decode_bf16_peaked",),
        "const int cpos = kPos ? pc : kv_start + c;", "const int cpos = kv_start + c;"),
    "wgmma_slot_index_for_position": (
        "flash_fwd_sm90.cuh", ("pos_prefill_bf16_peaked",),
        "const int cp = (int)pos[j * 8 + (e & 1)];", "const int cp = c;"),
    "template_slot_index_for_position": (
        "flash_fwd.cu", ("pos_prefill_fp32",),
        "const int cc = kPos ? sm.kseg[c] : kv_start + c;  // the column's position",
        "const int cc = kv_start + c;"),
    # the pos >= 0 test dropped: slots never written are seen
    "decode_pos_nonnegative_dropped": (
        "flash_decode.cuh", ("pos_decode_bf16_peaked",),
        "if constexpr (kPos) visible = visible && cpos >= 0;", "(void)0;"),
    "wgmma_pos_nonnegative_dropped": (
        "flash_fwd_sm90.cuh", ("pos_prefill_bf16_peaked",),
        "return c < n_kv && cp >= 0 && cp <= p", "return c < n_kv && cp <= p"),
    "template_pos_nonnegative_dropped": (
        "flash_fwd.cu", ("pos_prefill_fp32",),
        "seen[j] = seen[j] && cc >= 0 && (cc >= col_lo || cc < f.sinks);",
        "seen[j] = seen[j] && (cc >= col_lo || cc < f.sinks);"),
    # the index-space skip left on: slots past the rows' last position by
    # index are not walked
    "decode_index_split_skip": (
        "flash_decode.cuh", ("pos_decode_bf16_peaked",),
        "kPos ? n_kv - 1 : causal ?", "kPos ? min(n_kv - 1, (n_q - 1) + off) : causal ?"),
    "wgmma_index_tile_skip": (
        "flash_fwd_sm90.cuh", ("pos_prefill_bf16_peaked",),
        "n_steps = (n_kv + kTile - 1) / kTile;",
        "n_steps = min((n_kv + kTile - 1) / kTile, (q_start + kTile - 1 + off) / kTile + 1);"),
    "template_index_tile_skip": (
        "flash_fwd.cu", ("pos_prefill_fp32",),
        "runs = {0, 0, 0, (n_kv + kBlockN - 1) / kBlockN};",
        "runs = {0, 0, 0, min((n_kv + kBlockN - 1) / kBlockN, "
        "(q_start + rows_valid - 1 + off) / kBlockN + 1)};"),
    # ALiBi's distance measured from the slot index
    "decode_alibi_from_index": (
        "flash_decode.cuh", ("pos_decode_bf16_xf",),
        "const float cbase = kXf ? (float)(cpos - xoff) : 0.0f;",
        "const float cbase = kXf ? (float)(kv_start + c - xoff) : 0.0f;"),
    "wgmma_alibi_from_index": (
        "flash_fwd_sm90.cuh", ("pos_prefill_bf16_xf",),
        "return pos_float((int)pos[j * 8 + (e & 1)]) - rowf[e >> 1];",
        "return pos_float(c0 + j * 8 + (e & 1)) - rowf[e >> 1];"),
    "template_alibi_from_index": (
        "flash_fwd.cu", ("pos_prefill_int8_xf",),
        "p = seen[j] ? exp2f(xf.shifted(s_reg[j], (float)(cc - xpos), m_new)) : 0.0f;",
        "p = seen[j] ? exp2f(xf.shifted(s_reg[j], (float)(kv_start + c - xpos), m_new)) : 0.0f;"),
    # the sinks term dropped: only the window is seen
    "decode_sinks_dropped": (
        "flash_decode.cuh", ("pos_decode_bf16_s70",),
        "if constexpr (kWin) visible = visible && (cpos >= lo[r] || cpos < sinks);",
        "if constexpr (kWin) visible = visible && (cpos >= lo[r] || (!kPos && cpos < sinks));"),
    "wgmma_sinks_dropped": (
        "flash_fwd_sm90.cuh", ("pos_prefill_bf16_s70",),
        "cp <= p && in_window(cp, p, window, sinks);", "cp <= p && in_window(cp, p, window, 0);"),
    "template_sinks_dropped": (
        "flash_fwd.cu", ("pos_prefill_fp32_s70",),
        "seen[j] = seen[j] && cc >= 0 && (cc >= col_lo || cc < f.sinks);",
        "seen[j] = seen[j] && cc >= 0 && cc >= col_lo;"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_POS_FAULTS))
def test_pos_planted_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's position-map checks pass the kernels as built and fail
    a copy with a planted fault (errors printed with ``-s``)."""
    source, failing, old, new = PLANTED_POS_FAULTS[fault]
    lib = qt.bind(ff.bind(_planted_library(tmp_path, "flash_fwd.cu", source, old, new)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.pos_cases(gen, failing)
    clean = {n: max(onchip.pos_error(c)) for n, c in cases.items()}
    monkeypatch.setattr(ff, "_lib", lambda: lib)
    monkeypatch.setattr(qt, "_lib", lambda: lib)
    faulty = {n: max(onchip.pos_error(c)) for n, c in cases.items()}
    print(f"\n{fault}, worst error, built -> planted: "
          + ", ".join(f"{n} {clean[n]:.3e} -> {faulty[n]:.3e}" for n in failing))
    for n in failing:
        tol = TOL[cases[n][1].dtype]
        assert clean[n] <= tol
        assert not faulty[n] <= tol, n


def _small_engine_model(dtype, **model):
    _, cfg = serving.build_engine(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256, max_batch=2,
        max_len=1024, dtype=dtype, device="cpu", **model)
    gen = torch.Generator()
    gen.manual_seed(0)
    return tf.init_params(cfg, gen), cfg


def _serve_on(dev, params, cfg, prompts, max_new=8, **opts):
    eng = serving.DecodeEngine(tf.map_params(lambda p: p.to(dev), params), cfg, max_batch=2,
                               max_len=1024, **opts)
    reqs = [serving.Request(uid=u, prompt=p, max_new_tokens=max_new) for u, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


_LONG = [7 + (i * 5) % 200 for i in range(600)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["rolling", "rolling_int8"])
def test_serve_rolling_cuda_matches_cpu(cuda, mode):
    """Greedy fp32 serving through a rolling cache (W 64, 4 sinks: 256
    slots) past its capacity: the card's position instances emit the CPU's
    tokens, log-probabilities within fp32 rounding (8-bit: a key a step
    apart), and only they launch."""
    params, cfg = _small_engine_model(torch.float32, window=64, sinks=4)
    prompts = [_LONG, [3, 2, 1]]
    opts = serving.SERVING_MODES[mode][0]
    _, want = _serve_on("cpu", params, cfg, prompts, **opts)
    counted = ff.flash_fwd_general if mode == "rolling" else qt.flash_attention_quant
    counted.launches = counted.pos_launches = 0
    _, got = _serve_on("cuda", params, cfg, prompts, **opts)
    assert counted.pos_launches > 0 and counted.pos_launches == counted.launches
    atol = 5e-4 if mode.endswith("int8") else 1e-4
    for a, b in zip(got, want):
        assert a.generated == b.generated
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [None, "no_inflight_tokens"])
def test_serve_rolling_logits_bound_catches_effective_positions(cuda, monkeypatch, fault):
    """The rolling mode's served-logits bound on the card (bf16, prompts
    past the capacity): held as built, exceeded when the step's effective
    positions leave out the tokens in flight."""
    params, cfg = _small_engine_model(torch.bfloat16, window=64, sinks=4)
    if fault:
        monkeypatch.setattr(dec, "_effective_positions", lambda c, t: c.positions.clone())
    params = tf.map_params(lambda p: p.to("cuda"), params)
    worst = max(serving.teacher_forced_errors(params, cfg, [[5, 9, 100], _LONG], 8, 1024,
                                              mode="rolling"))
    bound = serving.SERVING_MODES["rolling"][1]
    print(f"\n{fault}: served logits rel L2 {worst:.3e} (bound {bound})")
    assert (worst < bound) if fault is None else (worst > bound)


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [dict(), dict(paged=True, kv_quant="int8")],
                         ids=["dense", "paged_int8"])
def test_serve_multi_step_cuda_matches_single(cuda, opts):
    """multi_step=4 emits the single-step engine's greedy tokens and
    log-probabilities on the card, EOS overshoot discarded."""
    params, cfg = _small_engine_model(torch.float32)
    prompts = [[3, 2, 1], _LONG[:150]]
    _, one = _serve_on("cuda", params, cfg, prompts, max_new=11, **opts)
    _, four = _serve_on("cuda", params, cfg, prompts, max_new=11, multi_step=4, **opts)
    for a, b in zip(four, one):
        assert a.generated == b.generated and len(a.generated) == 11
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [dict(), dict(kv_quant="int8"), dict(paged=True)],
                         ids=["dense", "int8", "paged"])
def test_serve_speculative_cuda_matches_plain(cuda, opts):
    """Greedy speculative serving on the card (a 1-layer draft; the verify
    chunk of gamma + 1 rows on the decode grid) emits the plain engine's
    tokens."""
    params, cfg = _small_engine_model(torch.float32)
    draft_cfg = dataclasses.replace(cfg, n_layers=1)
    gen = torch.Generator()
    gen.manual_seed(1)
    draft = (tf.map_params(lambda p: p.to("cuda"), tf.init_params(draft_cfg, gen)), draft_cfg)
    prompts = [[3, 2, 1], _LONG[:150]]
    _, want = _serve_on("cuda", params, cfg, prompts, max_new=12, **opts)
    _, got = _serve_on("cuda", params, cfg, prompts, max_new=12, draft=draft, **opts)
    assert [r.generated for r in got] == [r.generated for r in want]


@pytest.mark.gpu
def test_serve_speculative_paged_self_draft_long_cuda(cuda):
    """A paged target as its own draft on the card, 320 new tokens: the
    device runs gamma + 1 tokens a round ahead of the lagged harvest, and
    the pages granted keep ahead of the verify chunk's writes (the greedy
    streams equal the plain engine's)."""
    params, cfg = _small_engine_model(torch.float32)
    cuda_params = tf.map_params(lambda p: p.to("cuda"), params)
    prompts = [[3, 2, 1], _LONG[:150]]
    _, want = _serve_on("cuda", params, cfg, prompts, max_new=320, paged=True)
    eng, got = _serve_on("cuda", params, cfg, prompts, max_new=320, paged=True,
                         draft=(cuda_params, cfg))
    assert eng.steps <= 320 // 5 + 1 + eng.harvest_lag
    assert [r.generated for r in got] == [r.generated for r in want]


@pytest.mark.gpu
def test_serve_beam_and_snapshot_cuda(cuda, tmp_path):
    """Beam search on the card equals the CPU's (tokens; score to fp32
    rounding), and a snapshot taken mid-run on the card, saved and
    restored into a fresh engine, finishes every stream as an uninterrupted
    run does, bit for bit, and so does the engine that went on."""
    from flash_attention_metal_tpu_torch.runtime.beam import beam_search_generate
    from flash_attention_metal_tpu_torch.utils.checkpoint import restore_pytree, save_pytree

    params, cfg = _small_engine_model(torch.float32)
    cuda_params = tf.map_params(lambda p: p.to("cuda"), params)
    want = beam_search_generate(params, cfg, _LONG[:100], beam_width=3, max_new_tokens=8)
    got = beam_search_generate(cuda_params, cfg, _LONG[:100], beam_width=3, max_new_tokens=8)
    assert got[0] == want[0] and abs(got[1] - want[1]) < 1e-3
    plain = serving.DecodeEngine(cuda_params, cfg, max_batch=2, max_len=1024, paged=True)
    for r in serving.make_requests(4, 256, (5, 200), 10, seed=3):
        plain.submit(r)
    plain.run()
    eng = serving.DecodeEngine(cuda_params, cfg, max_batch=2, max_len=1024, paged=True)
    for r in serving.make_requests(4, 256, (5, 200), 10, seed=3):
        eng.submit(r)
    for _ in range(12):  # the first two requests are done on the card, not yet harvested
        eng.step()
    save_pytree(str(tmp_path / "snap.pt"), eng.snapshot())
    before = {u: (list(r.generated), list(r.logprobs)) for u, r in eng.finished.items()}
    eng.run()
    eng2 = serving.DecodeEngine(cuda_params, cfg, max_batch=2, max_len=1024, paged=True, seed=7)
    eng2.restore(restore_pytree(str(tmp_path / "snap.pt")))
    eng2.finished = {}
    eng2.run()
    resumed = {**before, **{u: (r.generated, r.logprobs) for u, r in eng2.finished.items()}}
    want = {u: (r.generated, r.logprobs) for u, r in plain.finished.items()}
    assert resumed == want
    assert {u: (r.generated, r.logprobs) for u, r in eng.finished.items()} == want


@pytest.mark.gpu
def test_serve_weight_int8_cuda_matches_cpu(cuda):
    """The weight-only int8 tree served on the card emits the CPU's greedy
    tokens, log-probabilities within fp32 rounding."""
    from flash_attention_metal_tpu_torch.models.wquant import quantize_weights

    params, cfg = _small_engine_model(torch.float32)
    qparams = quantize_weights(params)
    _, want = _serve_on("cpu", qparams, cfg, [[3, 2, 1], _LONG[:150]])
    _, got = _serve_on("cuda", qparams, cfg, [[3, 2, 1], _LONG[:150]])
    for a, b in zip(got, want):
        assert a.generated == b.generated
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The one-device model families on the card (fp32, small widths): each
# family's path through the kernels against the same path on the CPU, where
# the wrappers take their plain versions.
# ---------------------------------------------------------------------------

def _family_counts():
    counters = {"fwd": ff.flash_fwd_general, "dkv": fb.flash_bwd_dkv, "dq": fb.flash_bwd_dq,
                "paged_quant": pg.flash_attention_paged_quant}
    for c in counters.values():
        c.launches = 0
    return lambda: {name: c.launches for name, c in counters.items()}


def _leaves_close(got, want, tol):
    for g, w in zip(tf.param_leaves(got), tf.param_leaves(want)):
        scale = max(1.0, float(w.abs().max()))
        assert float((g.cpu() - w).abs().max()) <= tol * scale


def _small_moe():
    from flash_attention_metal_tpu_torch.models import moe

    cfg = moe.MoEConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=256, max_seq_len=1024, dtype=torch.float32, n_experts=4,
                        top_k=2, capacity_factor=1.25)
    gen = torch.Generator()
    gen.manual_seed(0)
    return moe, cfg, moe.init_moe_params(cfg, gen)


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [dict(), dict(paged=True, kv_quant="int8")],
                         ids=["dense", "paged_int8"])
def test_family_moe_serves_as_on_the_cpu(cuda, opts):
    """An MoE tree served on the card (the mlp_block hook) emits the CPU's
    greedy tokens, log-probabilities within fp32 rounding (int8: 2e-3, an
    8-bit code a rounding apart moves a key by a step of its absmax / 127,
    and the routed MLP's gates follow it), through the mode's kernel."""
    _, cfg, params = _small_moe()
    prompts = [[3, 2, 1], _LONG[:150]]
    _, want = _serve_on("cpu", params, cfg, prompts, **opts)
    counts = _family_counts()
    _, got = _serve_on("cuda", params, cfg, prompts, **opts)
    assert counts()["paged_quant" if opts else "fwd"] > 0
    for a, b in zip(got, want):
        assert a.generated == b.generated
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=2e-3 if opts else 1e-4, rtol=0)


@pytest.mark.gpu
def test_family_moe_training_matches_the_cpu(cuda):
    """The capacity-bucketed MoE loss with the aux loss, and its gradients,
    on the card against the CPU (fp32: 1e-5 of the loss, 1e-4 of the
    largest gradient)."""
    moe, cfg, params = _small_moe()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 256)))
    loss_c, grads_c = tf.value_and_grad(moe._moe_loss, params, tokens, cfg)
    counts = _family_counts()
    loss_g, grads_g = tf.value_and_grad(moe._moe_loss, tf.map_params(lambda t: t.cuda(), params),
                                        tokens.cuda(), cfg)
    n = counts()
    assert n["fwd"] == 2 * cfg.n_layers and n["dkv"] == n["dq"] == cfg.n_layers
    assert abs(float(loss_g) - float(loss_c)) < 1e-5 * float(loss_c)
    _leaves_close(grads_g, grads_c, 1e-4)


@pytest.mark.gpu
def test_family_encoder_matches_the_cpu(cuda):
    """The encoder's contract (non-causal, pads as segment 0, dropout 0.1 in
    one call): the masked-LM loss and gradients on the card against the
    CPU's plain versions, the same keep mask both ways."""
    from flash_attention_metal_tpu_torch.models import encoder

    cfg = encoder.EncoderConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                                d_ff=256, max_seq_len=256, dtype=torch.float32, attn_dropout=0.1)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = encoder.init_params(cfg, gen)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, 256, (2, 256)))
    mask = torch.from_numpy((np.arange(256)[None] < np.array([[173], [256]])).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, 256, (2, 256)))
    loss_mask = torch.from_numpy((rng.random((2, 256)) < 0.3).astype(np.int32)) * mask
    seeds = torch.tensor([11, 2**30 + 5], dtype=torch.int32)

    def run(dev, p):
        return tf.value_and_grad(
            lambda q: encoder.mlm_loss(q, tokens.to(dev), labels.to(dev), loss_mask.to(dev),
                                       mask.to(dev), cfg=cfg, dropout_seeds=seeds.to(dev)), p)

    loss_c, grads_c = run("cpu", params)
    counts = _family_counts()
    loss_g, grads_g = run("cuda", tf.map_params(lambda t: t.cuda(), params))
    n = counts()
    assert n["fwd"] == n["dkv"] == n["dq"] == cfg.n_layers
    assert abs(float(loss_g) - float(loss_c)) < 1e-5 * float(loss_c)
    _leaves_close(grads_g, grads_c, 1e-4)


@pytest.mark.gpu
def test_family_seq2seq_decodes_as_on_the_cpu(cuda):
    """Cross-attention (n_q != n_kv, kv-side segment ids) and the decoder's
    128-padded target cache at a traced offset: greedy tokens and beam
    scores on the card equal the CPU's (fp32)."""
    from flash_attention_metal_tpu_torch.models import seq2seq

    cfg = seq2seq.Seq2SeqConfig(vocab_size=256, d_model=128, enc_layers=2, dec_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=256, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = seq2seq.init_params(cfg, gen)
    src = [5, 9, 2, 44, 17, 3, 81, 200, 7]
    want = seq2seq.greedy_generate(params, cfg, src, max_new_tokens=12)
    beam_want = seq2seq.beam_generate(params, cfg, src, beam_width=3, max_new_tokens=8,
                                      return_all=True)
    gpu = tf.map_params(lambda t: t.cuda(), params)
    counts = _family_counts()
    got = seq2seq.greedy_generate(gpu, cfg, src, max_new_tokens=12)
    assert counts()["fwd"] == 12 * 2 * cfg.dec_layers + cfg.enc_layers
    assert got == want
    beam_got = seq2seq.beam_generate(gpu, cfg, src, beam_width=3, max_new_tokens=8,
                                     return_all=True)
    assert [t for t, _ in beam_got] == [t for t, _ in beam_want]
    np.testing.assert_allclose([s for _, s in beam_got], [s for _, s in beam_want], atol=1e-4)


@pytest.mark.gpu
def test_family_lora_and_muon_steps_match_the_cpu(cuda):
    """An adapter-only AdamW step (the base untouched) and a Muon step on
    the card against the CPU: adapters within 1e-5 of their largest value;
    Muon's bf16 Newton-Schulz within 5e-2 relative L2 (cuBLAS rounds its
    bf16 products elsewhere than the CPU, and five iterations amplify a
    rounding: tests/test_torch_muon.py)."""
    from flash_attention_metal_tpu_torch.models import lora, muon

    cfg = tf.ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                         head_dim=64, d_ff=256, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    base = tf.init_params(cfg, gen, master_dtype=torch.float32)
    lcfg = lora.LoRAConfig()
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 128)))
    results = {}
    for dev in ("cpu", "cuda"):
        g = torch.Generator()
        g.manual_seed(1)
        b = tf.map_params(lambda t: t.to(dev), base)
        ad = tf.map_params(lambda t: t.to(dev), lora.init_lora(base, lcfg, g))
        ad["layers"][0]["wq"]["b"].fill_(0.01)
        step, init = lora.make_lora_train_step(cfg, lcfg)
        state = init(ad)
        for _ in range(2):
            step(ad, state, b, tokens.to(dev))
        assert all(torch.equal(x.cpu(), y) for x, y in zip(tf.param_leaves(b),
                                                            tf.param_leaves(base)))
        results[dev] = ad
    _leaves_close(results["cuda"], results["cpu"], 1e-5)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(128, 384)).astype(np.float32))
    want = muon.newton_schulz_orthogonalize(g)
    got = muon.newton_schulz_orthogonalize(g.cuda()).cpu()
    assert float(torch.linalg.norm(got - want)) < 5e-2 * float(torch.linalg.norm(want))


@pytest.mark.gpu
def test_family_llama_converted_matches_the_cpu(cuda):
    """A seeded state dict with Hugging Face LLaMA names (GQA group 8, head
    dim 64) converted on the card: its logits against the CPU's within
    1e-4 of the largest, and greedy serving through the decode fold equal."""
    from types import SimpleNamespace

    from flash_attention_metal_tpu_torch.models import convert

    hf = SimpleNamespace(vocab_size=256, hidden_size=512, intermediate_size=384,
                         num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=1,
                         max_position_embeddings=1024, rope_theta=10000.0)
    gen = torch.Generator()
    gen.manual_seed(5)
    sd = {"model.embed_tokens.weight": torch.randn(256, 512, generator=gen) * 0.02,
          "model.norm.weight": torch.ones(512)}
    for i in range(2):
        pre = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (512, 512)), ("self_attn.k_proj", (64, 512)),
                            ("self_attn.v_proj", (64, 512)), ("self_attn.o_proj", (512, 512)),
                            ("mlp.gate_proj", (384, 512)), ("mlp.up_proj", (384, 512)),
                            ("mlp.down_proj", (512, 384))):
            sd[pre + name + ".weight"] = torch.randn(shape, generator=gen) * shape[1] ** -0.5
        sd[pre + "input_layernorm.weight"] = torch.ones(512)
        sd[pre + "post_attention_layernorm.weight"] = torch.ones(512)
    model = SimpleNamespace(config=hf, state_dict=lambda: sd)
    cfg, params = convert.convert_hf_llama(model, device="cpu", dtype=torch.float32)
    _, gpu = convert.convert_hf_llama(model, device="cuda", dtype=torch.float32)
    assert torch.equal(gpu["lm_head"].cpu(), sd["model.embed_tokens.weight"].t())
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (1, 200)))
    with torch.no_grad():
        want = tf.forward(params, tokens, cfg)
        got = tf.forward(gpu, tokens.cuda(), cfg).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))
    _, reqs_c = _serve_on("cpu", params, cfg, [[3, 2, 1], _LONG[:150]])
    _, reqs_g = _serve_on("cuda", gpu, cfg, [[3, 2, 1], _LONG[:150]])
    for a, b in zip(reqs_g, reqs_c):
        assert a.generated == b.generated
