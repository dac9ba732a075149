"""PyTorch port on the card: the CUDA kernels against their plain versions.

Every test here needs an NVIDIA GPU and skips without one (the CUDA kernels
have no CPU mode).  The file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import ctypes
import json
import shutil

import numpy as np
import pytest
import torch

from flash_attention_metal_tpu_torch import bench, flash_attention
from flash_attention_metal_tpu_torch.harness import autotune, onchip, serving
from flash_attention_metal_tpu_torch.kernels import _build
from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
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


def _planted_library(tmp_path, unit: str, source: str, old: str, new: str) -> ctypes.CDLL:
    """``csrc/<unit>`` built alone with one fault planted in ``csrc/<source>``
    (the unit itself or a header it includes): a copy beside the unit's
    copy shadows the original."""
    text = (_build.CSRC / source).read_text()
    assert text.count(old) == 1
    (tmp_path / source).write_text(text.replace(old, new))
    if unit != source:
        shutil.copy(_build.CSRC / unit, tmp_path / unit)
    return ctypes.CDLL(str(_build.compile_library([tmp_path / unit], tmp_path / "planted.so")))


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
    ],
    ids=["prefill_ragged", "non_causal", "decode_fold4", "masked_rows", "prefill_peaked"],
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


# Faults planted in a copy of csrc/flash_fwd.cu: (text, replacement).
PLANTED_FAULTS = {
    # o and l are not rescaled when the running max rises between KV tiles
    "no_rescale": ("const float alpha = exp2f(m_i - m_new);", "const float alpha = 1.0f;"),
    # the KV loop stops one tile before the last visible column
    "last_tile_dropped": ("tile_limit / kBlockN + 1", "tile_limit / kBlockN"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_planted_kernel_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's kernel check on its peaked multi-tile cases passes
    the kernel as built and fails a copy with a planted fault.  The errors
    of o and lse on the ladder fixture are printed too (``-s``)."""
    old, new = PLANTED_FAULTS[fault]
    source = (_build.CSRC / "flash_fwd.cu").read_text()
    assert source.count(old) == 1
    planted = tmp_path / "flash_fwd.cu"
    planted.write_text(source.replace(old, new))
    lib = ff.bind(ctypes.CDLL(str(_build.compile_library([planted], tmp_path / "planted.so"))))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.path_cases(gen)
    names = ("prefill_bf16_off512", "decode_bf16", "prefill_bf16_off512_peaked", "decode_bf16_peaked")
    clean = {n: onchip.kernel_error(cases[n]) for n in names}
    monkeypatch.setattr(ff, "_lib", lambda: lib)
    faulty = {n: onchip.kernel_error(cases[n]) for n in names}
    print(f"\n{fault}, (o, lse) max-abs error, built -> planted:\n" + "\n".join(
        f"  {n}: o {clean[n][0]:.3e} -> {faulty[n][0]:.3e}, "
        f"lse {clean[n][1]:.3e} -> {faulty[n][1]:.3e}" for n in names))
    tol = TOL[torch.bfloat16]
    for name in names:
        assert max(clean[name]) <= tol
    # On the peaked fixture the output alone fails, not only the lse.
    for name in ("prefill_bf16_off512_peaked", "decode_bf16_peaked"):
        assert faulty[name][0] > tol


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ff.flash_fwd_general(q, q, q, causal=True)
    q = torch.zeros((1, 2, 8, 128), device=cuda)
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
    ],
    ids=["ragged_gqa2", "non_causal", "gqa4", "masked_rows", "peaked"],
)
def test_bwd_kernels_match_plain(cuda, dtype, case):
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
    before = (fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches)
    got = fb.flash_attention_bwd(q, k, v, o, do, lse, off, dlse, sm_scale=0.125, causal=causal)
    assert (fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    want = fb.flash_attention_bwd_plain(
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


@pytest.mark.gpu
def test_bwd_kernels_are_deterministic(cuda):
    """Each output tile has one owner block and a fixed summation order:
    two runs give bit-identical gradients."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    inputs = onchip.bwd_inputs(onchip.train_cases(gen)["train_bf16_peaked"])
    q, k, v, o, do, lse, off = inputs
    first = fb.flash_attention_bwd(q, k, v, o, do, lse, off, causal=True)
    second = fb.flash_attention_bwd(q, k, v, o, do, lse, off, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# Faults planted in a copy of csrc/flash_bwd.cu: (text, replacement).
PLANTED_BWD_FAULTS = {
    # dS = P * dP: delta dropped
    "delta_dropped": ("(sm.dp[r * kLdS + c] - delta)", "sm.dp[r * kLdS + c]"),
    # the dK/dV walk starts one Q tile late: the diagonal tile is skipped
    "diagonal_skipped": ("max(0, kv_start - off) / kBlockM", "max(0, kv_start - off) / kBlockM + 1"),
    # only the group's first q-head is summed into dK
    "first_head_only": ("mma_atb_bf16(dk_acc, sm.ds, sm.q, warp);",
                        "if (g == 0) mma_atb_bf16(dk_acc, sm.ds, sm.q, warp);"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_BWD_FAULTS))
def test_planted_bwd_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's backward check at the training shape passes the
    kernels as built and fails a copy with a planted fault (errors printed
    with ``-s``)."""
    old, new = PLANTED_BWD_FAULTS[fault]
    source = (_build.CSRC / "flash_bwd.cu").read_text()
    assert source.count(old) == 1
    planted = tmp_path / "flash_bwd.cu"
    planted.write_text(source.replace(old, new))
    lib = fb.bind(ctypes.CDLL(str(_build.compile_library([planted], tmp_path / "planted.so"))))
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
        assert max(rel for _, rel in clean[name].values()) <= tol
        assert max(rel for _, rel in faulty[name].values()) > tol


@pytest.mark.gpu
def test_bwd_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 64, 64), device=cuda)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(NotImplementedError):
        fb.flash_attention_bwd(q, q, q, q, q, lse, causal=True, pos_div=2)
    with pytest.raises(NotImplementedError):
        fb.flash_attention_bwd(q, q, q, q, q, lse, causal=True, window=16)
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
# (csrc/flash_lean.cu), triangular forward and backward (csrc/flash_tri.cu).
# ---------------------------------------------------------------------------

# (kernel, q shape, kv shape, the wrapper's keywords): ragged lengths (not
# multiples of the 64 tile), GQA 2, static offsets 0, > 0 and < 0 (rows and
# whole tiles that see nothing).
LADDER_FWD_CASES = {
    "naive_causal": ("naive", (2, 2, 300, 64), (2, 2, 300, 64), dict(causal=True)),
    "naive_ragged": ("naive", (2, 2, 130, 64), (2, 2, 257, 64), dict()),
    "naive_causal_kv_longer": ("naive", (1, 2, 64, 64), (1, 2, 100, 64), dict(causal=True)),
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
    ],
    ids=["ragged_off170_dlse", "square", "masked_rows", "peaked"],
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
        q.float(), k.float(), v.float(), o.float(), do.float(), lse, off, dlse, sm_scale=0.125
    )
    torch.cuda.synchronize()
    # dQ in q's dtype; dK and dV fp32, as the Pallas kernel returns them
    # (the split pair returns k's dtype).
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    for g in got:
        assert bool(torch.isfinite(g).all())
    errors = _bwd_errors(got, want)
    assert max(errors.values()) <= BWD_TOL[dtype], errors
    if off == -70:
        assert torch.all(got[0][:, :, :70] == 0)


@pytest.mark.gpu
def test_tri_bwd_is_deterministic(cuda):
    """Each dK/dV tile has one owner block, each dQ slot one writer, and the
    slots are summed in a fixed order: two runs give identical bits."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    q, k, v, o, do, lse, off = onchip.tri_bwd_cases(gen)["tri_bwd_bf16_n2048_peaked"]
    first = ft.flash_attention_bwd_tri(q, k, v, o, do, lse, q_offset=off)
    second = ft.flash_attention_bwd_tri(q, k, v, o, do, lse, q_offset=off)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
        "naive": [(f32, onchip.ladder_inputs(shp, shp, f32, gen), dict(causal=True))],
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
    # causal test c < r in place of c <= r: the diagonal is masked
    "naive_diagonal_masked": ("naive.cu", nv, nv.bind, "naive", "c <= limit", "c < limit"),
    # the row max over the first 64 columns only
    "lean_max_first_tile": ("flash_lean.cu", ff, ff.bind_lean, "flash_lean",
                            "c < n_visible; c += kSub) row_max",
                            "c < min(n_visible, kBlockN); c += kSub) row_max"),
    # the diagonal tile treated as interior: no mask compare on it
    "tri_diagonal_unmasked": ("flash_tri.cu", ft, ft.bind, "flash_tri",
                              "kv_start + kBlockN - 1 <= first_limit",
                              "kv_start <= first_limit"),
    # dS = P * dP: delta dropped
    "tri_bwd_delta_dropped": ("flash_tri.cu", ft, ft.bind, "flash_tri_bwd",
                              "(sm.dp[r * kLdS + c] - delta)", "sm.dp[r * kLdS + c]"),
    # each Q tile's last dQ slot left out of the sum (the shared reduce)
    "tri_bwd_last_slot_dropped": (("flash_tri.cu", "dq_slots.cuh"), ft, ft.bind, "flash_tri_bwd",
                                  "j < n_slots; ++j)", "j < n_slots - 1; ++j)"),
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
def test_kv_kernels_are_deterministic(cuda):
    """One owner block per output tile and a fixed KV order: two runs of
    each kernel at chip_smoke.py's shapes give identical bits."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    for name, (kernel, args, pos_div) in onchip.kv_cases(gen).items():
        wrapper = onchip.KV_KERNELS[kernel][0]
        first, second = wrapper(*args, pos_div), wrapper(*args, pos_div)
        for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (first, second))):
            assert torch.equal(a, b), name


# Faults planted in a copy of csrc/flash_fwd.cu: (kernels whose check must
# fail, text, replacement).
PLANTED_KV_FAULTS = {
    # every column of a KV step takes the step's first V scale: s_v
    # applied to the step's sum instead of to each column of P
    "v_scale_on_the_sum": (("flash_quant", "flash_paged_quant"),
                           "const float v_scale = kScaled ? sm.sv[c] : 1.0f;",
                           "const float v_scale = kScaled ? sm.sv[0] : 1.0f;"),
    # the K scale dropped on one column of each KV tile
    "k_scale_dropped_on_one_column": (("flash_quant", "flash_paged_quant"),
                                      "const float k_scale = kScaled ? sm.sk[c] : 1.0f;",
                                      "const float k_scale = kScaled && c != 5 ? sm.sk[c] : 1.0f;"),
    # logical page j read as physical page j
    "identity_page_table": (("flash_paged", "flash_paged_quant"),
                            "const int phys = min(max(kv.table[(size_t)b * kv.max_pages + logical], "
                            "0), kv.n_pages - 1);",
                            "const int phys = min(logical, kv.n_pages - 1);"),
    # the KV loop reads one page past each row block's diagonal
    "page_past_the_diagonal": (("flash_paged", "flash_paged_quant"),
                               "tile_limit / kBlockN + 1;",
                               "tile_limit / kBlockN + 1 + (kPaged ? kv.page / kBlockN : 0);"),
}


def _kv_check(kernel, gen):
    """The worst error of chip_smoke.py's checks of one kernel (NaN if any
    case reads NaN)."""
    gen.manual_seed(onchip.SEED)
    cases = [c for c in onchip.kv_cases(gen).values() if c[0] == kernel]
    return float(np.max([onchip.kv_kernel_error(*c) for c in cases]))


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_KV_FAULTS))
def test_planted_kv_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's check of the 8-bit and paged kernels passes them as
    built and fails a copy with a planted fault (errors printed with
    ``-s``; NaN counts as a failure)."""
    kernels, old, new = PLANTED_KV_FAULTS[fault]
    text = (_build.CSRC / "flash_fwd.cu").read_text()
    assert text.count(old) == 1
    planted = tmp_path / "flash_fwd.cu"
    planted.write_text(text.replace(old, new))
    lib = qt.bind(ctypes.CDLL(str(_build.compile_library([planted], tmp_path / "planted.so"))))
    gen = torch.Generator(device="cuda")
    clean = {k: _kv_check(k, gen) for k in kernels}
    monkeypatch.setattr(qt, "_lib", lambda: lib)
    monkeypatch.setattr(pg, "_lib", lambda: lib)
    faulty = {k: _kv_check(k, gen) for k in kernels}
    tol = TOL[torch.bfloat16]
    print(f"\n{fault}: worst error built -> planted: " + ", ".join(
        f"{k} {clean[k]:.3e} -> {faulty[k]:.3e}" for k in kernels) + f" (tol {tol})")
    for k in kernels:
        assert clean[k] <= tol
        assert not faulty[k] <= tol, k


@pytest.mark.gpu
def test_kv_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    k = torch.zeros((1, 2, 128, 64), device=cuda)
    qkv = qt.quantize_kv(k, k)
    with pytest.raises(TypeError):
        qt.flash_attention_quant(q.half(), qkv, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        qt.flash_attention_quant(torch.zeros((1, 2, 8, 128), device=cuda),
                                 qt.quantize_kv(torch.zeros((1, 2, 128, 128), device=cuda),
                                                torch.zeros((1, 2, 128, 128), device=cuda)))
    pool = torch.zeros((3, 2, 128, 64), device=cuda)
    table = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    lengths = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        pg.flash_attention_paged(q, pool, pool, table.cpu(), lengths)
    with pytest.raises(TypeError, match="dtype"):
        pg.flash_attention_paged(q, pool.bfloat16(), pool.bfloat16(), table, lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(serving.SERVING_MODES))
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
# the JAX function's (fv.v1_route).  Folded: one KV tile per row, fold 8, 2
# and 4 (ragged: 200 columns, not a multiple of the 64-column chunk).
# Streaming: two 512-column logical blocks, a ragged row of 200 at batch 1
# (fold 1), and 1000 rows in 200-row logical blocks.
V1_CASES = {
    "folded_n128": ((16, 2, 128, 64), False, None),
    "folded_n512_causal": ((4, 2, 512, 64), True, None),
    "folded_ragged_causal": ((4, 1, 200, 64), True, None),
    "stream_n1024": ((2, 2, 1024, 64), False, None),
    "stream_n1024_causal": ((1, 2, 1024, 64), True, None),
    "stream_ragged_n200": ((1, 2, 200, 64), True, None),
    "stream_n1000_blocks200": ((1, 2, 1000, 64), True, (200, 200)),
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
    want = fv.flash_attention_v1_plain(q.float(), k.float(), v.float(), sm_scale=0.125,
                                       causal=causal)
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
                          "const float alpha = m_next == -INFINITY ? 1.0f : exp2f(m_i - m_next);",
                          "const float alpha = 1.0f;"),
    # the folded kernel's row max taken over the first 64-column chunk only
    "folded_partial_row_max": ("flash_v1_folded", "v1_fp32_n128_spike",
                               "for (int ch = 0; ch < n_chunks; ++ch) {  // row max",
                               "for (int ch = 0; ch < 1; ++ch) {  // row max"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_V1_FAULTS))
def test_planted_v1_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's checks of one V1 kernel pass it as built and fail a
    copy with a planted fault on the fixture that shows it (errors printed
    with ``-s``; NaN counts as a failure)."""
    kernel, shows, old, new = PLANTED_V1_FAULTS[fault]
    text = (_build.CSRC / "flash_v1.cu").read_text()
    assert text.count(old) == 1
    planted = tmp_path / "flash_v1.cu"
    planted.write_text(text.replace(old, new))
    lib = fv.bind(ctypes.CDLL(str(_build.compile_library([planted], tmp_path / "planted.so"))))
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
        # GQA 4 (the dK/dV block walks four q-heads, each with its slots)
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


@pytest.mark.gpu
def test_fused_bwd_is_deterministic(cuda):
    """Each dK/dV tile has one owner block, each dQ slot one writer, and the
    slots are summed in KV-tile order: two runs give identical bits."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    q, k, v, o, do, lse, off = onchip.bwd_inputs(onchip.train_cases(gen)["train_bf16_peaked"])
    first = fb.flash_attention_bwd_fused(q, k, v, o, do, lse, off, causal=True)
    second = fb.flash_attention_bwd_fused(q, k, v, o, do, lse, off, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# Faults planted in a copy of csrc/flash_bwd.cu, or of the dQ slot header
# it includes, that only the fused path runs: (file, text, replacement).
PLANTED_FUSED_FAULTS = {
    # each Q tile's last visible dQ partial (the diagonal's) left out
    "dq_partial_dropped": ("dq_slots.cuh", "for (int j = 0; j < n_slots; ++j)",
                           "for (int j = 0; j < n_slots - 1; ++j)"),
    # dK stored without sm_scale on the fused path
    "dk_unscaled": ("flash_bwd.cu", "dk[at + j] = from_float<T>(dk_reg[j] * sm_scale);",
                    "dk[at + j] = from_float<T>(kFused ? dk_reg[j] : dk_reg[j] * sm_scale);"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED_FUSED_FAULTS))
def test_planted_fused_fault_fails_the_check(cuda, tmp_path, monkeypatch, fault):
    """chip_smoke.py's fused-backward check at the training shape passes the
    kernel as built and fails a copy with a planted fault (errors printed
    with ``-s``)."""
    source, old, new = PLANTED_FUSED_FAULTS[fault]
    lib = fb.bind(_planted_library(tmp_path, "flash_bwd.cu", source, old, new))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(onchip.SEED)
    cases = onchip.train_cases(gen)
    names = ("train_bf16", "train_bf16_peaked")
    inputs = {n: onchip.bwd_inputs(cases[n]) for n in names}
    clean = {n: onchip.bwd_kernel_errors(inputs[n], fused=True) for n in names}
    monkeypatch.setattr(fb, "_lib", lambda: lib)
    faulty = {n: onchip.bwd_kernel_errors(inputs[n], fused=True) for n in names}
    print(f"\n{fault}, (dq, dk, dv) normalised max-abs error, built -> planted:\n" + "\n".join(
        f"  {n}: " + ", ".join(f"{g} {clean[n][g][1]:.3e} -> {faulty[n][g][1]:.3e}" for g in clean[n])
        for n in names))
    tol = BWD_TOL[torch.bfloat16]
    for name in names:
        assert max(rel for _, rel in clean[name].values()) <= tol
        assert max(rel for _, rel in faulty[name].values()) > tol


@pytest.mark.gpu
def test_fused_bwd_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 64, 64), device=cuda)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="block_sizes"):
        fb.flash_attention_bwd_fused(q, q, q, q, q, lse, causal=True, block_sizes=fb.BlockSizes())
    with pytest.raises(NotImplementedError):
        fb.flash_attention_bwd_fused(q, q, q, q, q, lse, causal=True, window=16)
    with pytest.raises(TypeError):
        fb.flash_attention_bwd_fused(q.half(), q.half(), q.half(), q.half(), q.half(), lse,
                                     causal=True)


@pytest.mark.gpu
def test_fused_workspace_holds_the_visible_pairs(cuda):
    """The packed dQ workspace (csrc/dq_slots.cuh): the library's slot
    counts at the training shape (528 of 32 x 32 pairs per q-head, causal,
    offset 0), and on the card every slot allocated at a bound that every
    batch meets is written; a batch below the bound leaves some unwritten."""
    assert fb.dq_workspace_shape(4, 16, 2048, 2048, 0) == (4 * 16 * 528, 64, 64)
    assert fb.dq_workspace_shape(4, 16, 2048, 2048, 2047) == (4 * 16 * 1024, 64, 64)
    assert fb.dq_workspace_shape(1, 2, 128, 128, -70) == (2, 64, 64)  # the first tile sees none
    rng = np.random.default_rng(0)
    q = _uniform(rng, (2, 4, 200, 64), cuda, torch.bfloat16)
    k, v = (_uniform(rng, (2, 2, 300, 64), cuda, torch.bfloat16) for _ in range(2))
    for offs, bound in (([100, 100], 100), ([0, 100], 100), ([-70, -70], -70)):
        off = torch.tensor(offs, dtype=torch.int32, device=cuda)
        inputs = onchip.bwd_inputs((q, k, v, q, off))
        allocated, written = onchip.fused_workspace_bytes(inputs, bound)
        slot = 64 * 64 * 4
        assert allocated == 2 * 4 * fb.dq_workspace_shape(1, 1, 200, 300, bound)[0] * slot
        if offs[0] == offs[1]:
            assert written == allocated, (offs, allocated, written)
        else:
            per_head = [fb.dq_workspace_shape(1, 1, 200, 300, x)[0] for x in offs]
            assert written == 4 * sum(per_head) * slot < allocated


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
