"""PyTorch port: the backward kernels' contract and the differentiable op
against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
backward runs its Pallas kernels (``_dkv_kernel``, ``_dq_kernel``) in
interpret mode, as the JAX tests do on the CPU; the port runs the kernels'
plain version, which is what its wrapper takes for CPU tensors.  The CUDA
kernels themselves run only on a card: their tests are in
``test_torch_gpu.py``.

Errors are max-abs differences over the max-abs of the JAX gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_metal_tpu.kernels.flash_bwd import (
    flash_attention_bwd as jax_flash_bwd,
)
from flash_attention_metal_tpu.kernels.flash_fwd import (
    flash_attention_fwd as jax_flash_fwd,
)
from flash_attention_metal_tpu.ops import attention as jax_ops
from flash_attention_metal_tpu.reference import oracle as jax_oracle
from flash_attention_metal_tpu_torch import flash_attention
from flash_attention_metal_tpu_torch.kernels.flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_fused,
)
from flash_attention_metal_tpu_torch.kernels.flash_fwd import flash_attention_fwd
from flash_attention_metal_tpu_torch.reference import oracle

# fp32: the JAX kernels' fp32 products are bf16x3 (~2^-16 relative, the
# fp32 parity floor of ROADMAP.md Queue C) and both sides sum in other
# orders; 1e-4 of the largest gradient leaves room for that, while a wrong
# mask, delta or scale moves gradients by far more than 1e-2.
TOL = 1e-4
# bf16: the JAX kernels round P, dS and Q * scale to bf16 inside the
# products (2^-9 each, relative) and the gradients to bf16 on store; the
# port's plain version keeps fp32 until its final cast.
TOL_BF16 = 2e-2


def _inputs(seed, b, hq, hkv, n_q, n_kv, d=64):
    """uniform(-1, 1) q, k, v, do and a dlse: the verification ladder's
    fixture (bounded values keep the fp32 parity floor below TOL)."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32)

    return u(b, hq, n_q, d), u(b, hkv, n_kv, d), u(b, hkv, n_kv, d), u(b, hq, n_q, d), u(b, hq, n_q)


def _err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want)) / np.max(np.abs(want)))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


@pytest.mark.parametrize(
    "case",
    [
        # causal, offset 0 (training), MHA
        dict(b=2, hq=2, hkv=2, n=128, off=[0, 0], dlse=False),
        # per-batch offset tensor (chunked rows), GQA 2, with an lse cotangent
        dict(b=2, hq=4, hkv=2, n=128, off=[0, 64], dlse=True),
        # the same at head dim 128
        dict(b=2, hq=4, hkv=2, n=128, off=[0, 64], dlse=True, d=128),
    ],
    ids=["causal_mha", "per_batch_offset_gqa2_dlse", "per_batch_offset_gqa2_dlse_d128"],
)
def test_flash_bwd_matches_jax_kernels(case):
    """The port's backward against JAX ``flash_attention_bwd`` on the same
    ``o`` and ``lse``.  The JAX kernels take equal head counts, so K/V are
    repeated for them and their dK/dV summed over each group after, which
    is what the JAX op does."""
    b, hq, hkv, n, d = case["b"], case["hq"], case["hkv"], case["n"], case.get("d", 64)
    q, k, v, do, dlse = _inputs(0, b, hq, hkv, n, n, d)
    group = hq // hkv
    kb, vb = np.repeat(k, group, axis=1), np.repeat(v, group, axis=1)
    off = np.asarray(case["off"], np.int32)
    o, lse = jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(off),
        causal=True, save_lse=True, interpret=True,
    )
    dlse_j = jnp.asarray(dlse) if case["dlse"] else None
    dq_j, dk_j, dv_j = jax_flash_bwd(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), o, jnp.asarray(do), lse,
        jnp.asarray(off), dlse_j, causal=True, interpret=True,
    )
    dk_j = np.asarray(dk_j).reshape(b, hkv, group, n, d).sum(axis=2)
    dv_j = np.asarray(dv_j).reshape(b, hkv, group, n, d).sum(axis=2)
    dq, dk, dv = flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(o), _t(do), _t(np.asarray(lse)[..., 0]), torch.from_numpy(off),
        _t(dlse) if case["dlse"] else None, causal=True,
    )
    assert dq.shape == q.shape and dk.shape == k.shape and dk.dtype == torch.float32
    assert _err(dq, dq_j) < TOL
    assert _err(dk, dk_j) < TOL
    assert _err(dv, dv_j) < TOL


def _jax_grads(q, k, v, do, dlse, off, save_lse):
    def f(q_, k_, v_):
        out = jax_ops.flash_attention(q_, k_, v_, jnp.asarray(off), causal=True, save_lse=save_lse)
        if save_lse:
            o, lse = out
            return jnp.sum(o.astype(jnp.float32) * do) + jnp.sum(lse * dlse)
        return jnp.sum(out.astype(jnp.float32) * do)

    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


def _torch_grads(q, k, v, do, dlse, off, save_lse, impl="auto"):
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = flash_attention(q, k, v, off, causal=True, save_lse=save_lse, impl=impl)
    if save_lse:
        loss = (out[0].float() * do).sum() + (out[1] * dlse).sum()
    else:
        loss = (out.float() * do).sum()
    return torch.autograd.grad(loss, (q, k, v))


@pytest.mark.parametrize(
    "case",
    [
        dict(hq=4, hkv=2, off=[0, 0], save_lse=False),
        dict(hq=8, hkv=2, off=[0, 0], save_lse=False),
        dict(hq=4, hkv=2, off=[0, 64], save_lse=True),
    ],
    ids=["gqa2", "gqa4", "per_batch_offset_save_lse"],
)
def test_flash_attention_grad_matches_jax_grad(case):
    """torch autograd through the port's op against ``jax.grad`` through
    the JAX op (its custom_vjp, broadcast GQA route, interpret mode)."""
    q, k, v, do, dlse = _inputs(1, 2, case["hq"], case["hkv"], 128, 128)
    off = np.asarray(case["off"], np.int32)
    want = _jax_grads(*map(jnp.asarray, (q, k, v, do, dlse)), off, case["save_lse"])
    got = _torch_grads(*map(_t, (q, k, v, do, dlse)), torch.from_numpy(off), case["save_lse"])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _err(g, w) < TOL


def test_flash_attention_grad_bf16_matches_jax_grad():
    q, k, v, do, _ = _inputs(2, 1, 4, 2, 128, 128)
    bf = jnp.bfloat16
    want = _jax_grads(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf), jnp.asarray(do), None,
        np.zeros(1, np.int32), False,
    )
    got = _torch_grads(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16), _t(do), None,
        torch.zeros(1, dtype=torch.int32), False,
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _err(g, np.asarray(w, np.float32)) < TOL_BF16


def test_flash_attention_grad_fp16_matches_jax_grad():
    """fp16 inputs: both packages run the backward in fp32 on casts and
    round the gradients to fp16 (JAX ``flash_bwd.py:887-915``).  Both round
    to fp16 at the end (2^-11 relative), so a gradient may land one fp16
    step apart: 2e-3 of the largest gradient."""
    q, k, v, do, _ = _inputs(6, 1, 4, 2, 128, 128)
    f16 = jnp.float16
    want = _jax_grads(
        jnp.asarray(q, f16), jnp.asarray(k, f16), jnp.asarray(v, f16), jnp.asarray(do), None,
        np.zeros(1, np.int32), False,
    )
    got = _torch_grads(
        _t(q, torch.float16), _t(k, torch.float16), _t(v, torch.float16), _t(do), None,
        torch.zeros(1, dtype=torch.int32), False,
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.float16 and w.dtype == f16
        assert _err(g, np.asarray(w, np.float32)) < 2e-3


def test_fp16_backward_runs_in_fp32_and_rounds_back():
    """``flash_attention_bwd`` and the fused backward on fp16 equal their
    fp32 results on the casts, rounded to fp16."""
    q, k, v, do, _ = _inputs(7, 1, 2, 2, 128, 128)
    q, k, v, do = (_t(x, torch.float16) for x in (q, k, v, do))
    o, lse = flash_attention_fwd(q, k, v, causal=True, save_lse=True)
    assert o.dtype == torch.float16
    for backward in (flash_attention_bwd, flash_attention_bwd_fused):
        got = backward(q, k, v, o, do, lse, causal=True)
        want = backward(q.float(), k.float(), v.float(), o.float(), do.float(), lse, causal=True)
        for g, w in zip(got, want):
            assert g.dtype == torch.float16 and torch.equal(g, w.half())


def test_masked_rows_give_zero_grads():
    """Rows that see no column (lse = -inf) give zero gradients through the
    sentinel, never NaN, in the port and in the JAX kernels (multi-block
    path, as in test_torch_flash_fwd.py)."""
    q, k, v, do, _ = _inputs(3, 1, 2, 2, 256, 256)
    off = np.asarray([-128], np.int32)  # rows 0..127 see nothing
    o, lse = jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off), causal=True,
        save_lse=True, interpret=True,
        block_sizes=JaxBlockSizes(block_q=128, block_k_major=128, block_k=128),
    )
    lse_rows = np.asarray(lse)[..., 0]
    assert np.all(np.isneginf(lse_rows[:, :, :128]))
    dq_j, dk_j, dv_j = jax_flash_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, jnp.asarray(do), lse,
        jnp.asarray(off), causal=True, interpret=True,
    )
    dq, dk, dv = flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(o), _t(do), _t(lse_rows), torch.from_numpy(off), causal=True,
    )
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all())
    assert torch.all(dq[:, :, :128] == 0)
    assert _err(dq, dq_j) < TOL and _err(dk, dk_j) < TOL and _err(dv, dv_j) < TOL


def test_three_opinions_on_the_backward():
    """fp32, GQA 2, per-batch offsets, with an lse cotangent: the plain
    backward (from the saved lse), torch autograd of the fp32 oracle, and
    the oracle's closed form agree."""
    q, k, v, do, dlse = map(_t, _inputs(4, 2, 4, 2, 96, 160))
    off = torch.tensor([64, 10], dtype=torch.int32)
    kernel = _torch_grads(q, k, v, do, dlse, off, True)
    autograd = _torch_grads(q, k, v, do, dlse, off, True, impl="reference")
    for g, w in zip(kernel, autograd):
        assert _err(g, w.numpy()) < 1e-5
    closed = oracle.attention_reference_bwd(q, k, v, do, causal=True, q_offset=off)
    without_dlse = _torch_grads(q, k, v, do, dlse, off, False)
    for g, w in zip(without_dlse, closed):
        assert _err(g, w.numpy()) < 1e-5


def test_oracle_bwd_matches_jax_oracle_bwd():
    q, k, v, do, _ = _inputs(5, 2, 4, 2, 128, 128)
    got = oracle.attention_reference_bwd(_t(q), _t(k), _t(v), _t(do), causal=True)
    # The JAX oracle takes pre-broadcast heads.
    kb, vb = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    dq, dk, dv = jax_oracle.attention_reference_bwd(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(do), causal=True
    )
    assert _err(got[0], dq) < 1e-5
    assert _err(got[1], np.asarray(dk).reshape(2, 2, 2, 128, 64).sum(axis=2)) < 1e-5
    assert _err(got[2], np.asarray(dv).reshape(2, 2, 2, 128, 64).sum(axis=2)) < 1e-5


def test_bwd_rejects_unported_features():
    """The softcap, ALiBi and dropout are the split pair's now: the backward
    returns (dq, dk, dv), and d_slopes last under ALiBi; pos_div still
    raises, and so does dropout without its seed."""
    q = torch.zeros((1, 2, 8, 64))
    lse = torch.zeros((1, 2, 8))
    assert len(flash_attention_bwd(q, q, q, q, q, lse, causal=True, softcap=30.0)) == 3
    grads = flash_attention_bwd(q, q, q, q, q, lse, causal=True, alibi_slopes=torch.ones(2))
    assert len(grads) == 4 and grads[3].shape == (2,) and grads[3].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="pos_div"):
        flash_attention_bwd(q, q, q, q, q, lse, causal=True, pos_div=2)
    assert len(flash_attention_bwd(q, q, q, q, q, lse, causal=True, dropout_rate=0.1,
                                   dropout_seed=2)) == 3
    with pytest.raises(ValueError, match="requires dropout_seed"):
        flash_attention(q.requires_grad_(True), q, q, causal=True, dropout_rate=0.1)
