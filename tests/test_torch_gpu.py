"""PyTorch port on the card: the CUDA kernels against their plain versions.

Every test here needs an NVIDIA GPU and skips without one (the CUDA kernels
have no CPU mode).  The file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from flash_attention_metal_tpu_torch.harness import onchip, serving
from flash_attention_metal_tpu_torch.kernels import _build
from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
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
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, off, **kw)
    assert flash_attention_fwd.launches == before + 1
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
        flash_attention_fwd(q, q, q, causal=True)
    q = torch.zeros((1, 2, 8, 128), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q, causal=True)
    q = torch.zeros((1, 2, 64, 8), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, q, q, causal=True)


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
    counts = (flash_attention_fwd.launches, fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches)
    loss_gpu, g_gpu = tf.value_and_grad(tf.loss_fn, params_cuda, tokens.to(cuda), cfg)
    after = (flash_attention_fwd.launches, fb.flash_bwd_dkv.launches, fb.flash_bwd_dq.launches)
    assert tuple(a - b for a, b in zip(after, counts)) == (4, 2, 2)
    assert abs(float(loss_gpu) - float(loss_cpu)) < 1e-4
    for a, b in zip(tf.param_leaves(g_gpu), tf.param_leaves(g_cpu)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))
