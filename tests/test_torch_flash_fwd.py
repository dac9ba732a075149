"""PyTorch port: the forward kernel's contract against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
functions run their Pallas kernels in interpret mode, as the JAX tests do
on the CPU; the port runs the kernel's plain version, which is what its
wrapper takes for CPU tensors.  The CUDA kernel itself runs only on a card:
its tests are in ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_metal_tpu.kernels.flash_fwd import (
    flash_attention_fwd as jax_flash_fwd,
)
from flash_attention_metal_tpu.ops import attention as jax_ops
from flash_attention_metal_tpu.reference import oracle as jax_oracle
from flash_attention_metal_tpu_torch import flash_attention
from flash_attention_metal_tpu_torch.config import BlockSizes
from flash_attention_metal_tpu_torch.kernels.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from flash_attention_metal_tpu_torch.ops import attention as ops
from flash_attention_metal_tpu_torch.reference import oracle

# fp32 parity: both sides accumulate in fp32 in different orders (and the
# JAX kernel's online softmax rebases per block); 2e-5 leaves room for that
# and catches any masking or scaling fault, which moves outputs by >1e-2.
TOL = 2e-5


def _qkv(seed, b, hq, hkv, n_q, n_kv, d=64):
    """uniform(-1, 1) inputs, the verification ladder's fixture.  Bounded
    values keep a row that sees one column (o = one V row) inside TOL of
    the JAX kernel, whose fp32 products carry ~2^-16 relative error."""
    rng = np.random.default_rng(seed)

    def u(shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32)

    return u((b, hq, n_q, d)), u((b, hkv, n_kv, d)), u((b, hkv, n_kv, d))


def _diff(got: torch.Tensor, want) -> float:
    return float(np.max(np.abs(got.numpy() - np.asarray(want))))


@pytest.mark.parametrize(
    "case",
    [
        # prefill-like: GQA 4/2, per-batch offsets
        dict(b=2, hq=4, hkv=2, n_q=128, n_kv=256, off=[0, 128], pos_div=1),
        # MHA, per-batch offsets
        dict(b=2, hq=2, hkv=2, n_q=128, n_kv=256, off=[100, 37], pos_div=1),
        # folded decode: 2 q-heads per KV head in 2 rows, offsets incl. 0
        dict(b=4, hq=2, hkv=2, n_q=2, n_kv=256, off=[0, 1, 130, 254], pos_div=2),
    ],
    ids=["prefill_gqa", "mha", "decode_fold"],
)
def test_flash_fwd_matches_jax(case):
    q, k, v = _qkv(0, case["b"], case["hq"], case["hkv"], case["n_q"], case["n_kv"])
    off = np.asarray(case["off"], np.int32)
    o_j, lse_j = jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
        causal=True, save_lse=True, pos_div=case["pos_div"], interpret=True,
    )
    o_t, lse_t = flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(off), causal=True, save_lse=True, pos_div=case["pos_div"],
    )
    assert o_t.dtype == torch.float32 and o_t.shape == q.shape
    assert _diff(o_t, o_j) < TOL
    # The JAX kernel replicates the row lse over 128 lanes.
    assert _diff(lse_t, np.asarray(lse_j)[..., 0]) < TOL


def test_fully_masked_rows_give_zero_and_neg_inf():
    """Rows with no visible column: o = 0 and lse = -inf.

    The JAX kernel meets this on its multi-block path, which the serving
    path takes at max_len 2048.  Its single-KV-block path (n_kv <= 1024 by
    default) returns mean(V) and lse ~ -1.65e38 for such rows instead
    (ROADMAP.md, Queue C), so the reference runs with 128-wide KV blocks.
    """
    q, k, v = _qkv(1, 1, 2, 2, 128, 256)
    off = np.asarray([-64], np.int32)  # rows 0..63 see no column
    o_t, lse_t = flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(off), causal=True, save_lse=True,
    )
    o_j, lse_j = jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
        causal=True, save_lse=True, interpret=True,
        block_sizes=JaxBlockSizes(block_q=128, block_k_major=128, block_k=128),
    )
    assert torch.all(o_t[:, :, :64] == 0) and torch.all(torch.isneginf(lse_t[:, :, :64]))
    assert np.all(np.isneginf(np.asarray(lse_j)[:, :, :64, 0]))
    assert _diff(o_t, o_j) < TOL
    assert _diff(lse_t[:, :, 64:], np.asarray(lse_j)[:, :, 64:, 0]) < TOL


def test_oracle_matches_jax_oracle():
    q, k, v = _qkv(2, 2, 4, 2, 96, 160)
    o_t, lse_t = oracle.attention_reference_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, q_offset=40,
    )
    # The JAX oracle takes pre-broadcast heads and a scalar offset.
    kb, vb = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    o_j, lse_j = jax_oracle.attention_reference_with_lse(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), causal=True, q_offset=40
    )
    assert _diff(o_t, o_j) < 1e-5
    assert _diff(lse_t, lse_j) < 1e-5


def test_plain_matches_oracle_per_batch_offsets():
    """The kernel's plain version against the independent oracle."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 3, 4, 1, 64, 200))
    off = torch.tensor([0, 50, 136], dtype=torch.int32)
    got = flash_attention_fwd_plain(q, k, v, off, sm_scale=0.125, causal=True)
    want = oracle.attention_reference(q, k, v, causal=True, sm_scale=0.125, q_offset=off)
    assert float((got - want).abs().max()) < 1e-5


def test_flash_attention_op_matches_jax_op():
    q, k, v = _qkv(4, 2, 4, 2, 128, 128)
    want = jax_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True
    )
    args = [torch.from_numpy(x) for x in (q, k, v)]
    assert _diff(flash_attention(*args, causal=True), want) < TOL
    assert _diff(flash_attention(*args, causal=True, impl="reference"), want) < TOL
    # Non-causal, int offset ignored.
    want_nc = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert _diff(flash_attention(*args), want_nc) < TOL


@pytest.mark.parametrize("hq,hkv,t", [(4, 2, 1), (8, 2, 3), (4, 4, 2)])
def test_fold_unfold_match_jax(hq, hkv, t):
    x = np.random.default_rng(5).uniform(-1, 1, (2, hq, t, 64)).astype(np.float32)
    folded = ops.fold_gqa_rows(torch.from_numpy(x), hkv)
    np.testing.assert_array_equal(
        folded.numpy(), np.asarray(jax_ops.fold_gqa_rows(jnp.asarray(x), hkv))
    )
    np.testing.assert_array_equal(ops.unfold_gqa_rows(folded, hq, t).numpy(), x)


@pytest.mark.parametrize("hq,hkv,t", [(4, 2, 1), (8, 2, 2)])
def test_gqa_decode_attention_matches_jax(hq, hkv, t):
    q, k, v = _qkv(6, 3, hq, hkv, t, 256)
    lengths = np.asarray([0, 17, 250], np.int32)
    o_j, lse_j = jax_ops.gqa_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        save_lse=True, interpret=True,
    )
    o_t, lse_t = ops.gqa_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), save_lse=True,
    )
    assert _diff(o_t, o_j) < TOL
    assert _diff(lse_t, lse_j) < TOL


@pytest.mark.parametrize(
    "feature",
    [dict(kv_positions=torch.arange(8, dtype=torch.int32)[None]), dict(softcap=30.0),
     dict(dropout_rate=0.1, dropout_seed=3), dict(alibi_slopes=torch.ones(2))],
)
def test_unported_features_raise(feature):
    """Every feature of the JAX op is ported: kv_positions (here the
    identity map, whose position-space mask is the index-space causal one),
    the softcap, ALiBi and dropout: the op and the forward router equal the
    oracle under them (fp32, 1e-5; dropout's mask is the oracle's bit for
    bit)."""
    q = torch.zeros((1, 2, 8, 64))
    rng = np.random.default_rng(3)
    qr, kr, vr = (torch.from_numpy(rng.uniform(-2, 2, (1, 2, 8, 64)).astype(np.float32))
                  for _ in range(3))
    oracle_kw = {name: val for name, val in feature.items() if name != "kv_positions"}
    want = oracle.attention_reference(qr, kr, vr, causal=True, **oracle_kw)
    for fn in (flash_attention, flash_attention_fwd):
        assert float((fn(qr, kr, vr, causal=True, **feature) - want).abs().max()) < 1e-5
    # Each feature's off value is accepted.
    flash_attention(q, q, q, causal=True, window=None, sinks=0, dropout_rate=0.0,
                    kv_positions=None)


def test_requires_grad_raises():
    """An input that requires grad was refused while the port was
    forward-only; now it is differentiated (tests/test_torch_flash_bwd.py
    checks the gradients), under the softcap and dropout too
    (tests/test_torch_dropout.py checks those), and only the forward-only
    position map, or dropout without its seed, still raises."""
    q = torch.zeros((1, 2, 8, 64), requires_grad=True)
    o = flash_attention(q, q.detach(), q.detach(), causal=True)
    assert o.requires_grad and o.grad_fn is not None
    (g,) = torch.autograd.grad(o.sum(), q)
    assert g.shape == q.shape
    o = flash_attention(q, q.detach(), q.detach(), causal=True, softcap=30.0)
    (g,) = torch.autograd.grad(o.sum(), q)
    assert g.shape == q.shape
    o = flash_attention(q, q.detach(), q.detach(), causal=True, dropout_rate=0.1,
                        dropout_seed=4)
    (g,) = torch.autograd.grad(o.sum(), q)
    assert g.shape == q.shape
    with pytest.raises(ValueError, match="requires dropout_seed"):
        flash_attention(q, q.detach(), q.detach(), causal=True, dropout_rate=0.1)
    # The position map is the rolling caches' serving path: forward only.
    with pytest.raises(NotImplementedError, match="forward only"):
        flash_attention(q, q.detach(), q.detach(), causal=True,
                        kv_positions=torch.zeros((1, 8), dtype=torch.int32))


def test_block_sizes_rule():
    assert BlockSizes() == BlockSizes(block_q=64, block_k=64)
    BlockSizes(block_q=16, block_k=32)  # no 128-lane rule on the GPU
    with pytest.raises(ValueError):
        BlockSizes(block_q=24)
