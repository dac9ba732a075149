"""PyTorch port on the card: the CUDA kernel against its plain version.

Every test here needs an NVIDIA GPU and skips without one (the CUDA kernel
has no CPU mode).  The file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from flash_attention_metal_tpu_torch.harness import onchip, serving
from flash_attention_metal_tpu_torch.kernels import _build
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
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
