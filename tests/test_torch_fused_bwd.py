"""PyTorch port: the fused 5-matmul backward against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; both take
the same ``o`` and ``lse`` (the JAX forward's).  JAX
``flash_attention_bwd_fused`` runs its Pallas kernel in interpret mode, as
the JAX tests do on the CPU, with 512- and 256-row KV blocks (one and two dQ
partials); the port runs the kernel's plain version (one dQ partial per
64-row KV tile, summed in KV order), which its wrapper takes for CPU
tensors.  The CUDA kernel runs only on a card (``test_torch_gpu.py``).

Tolerance: 1e-4 of the largest gradient (fp32; the JAX kernels' fp32
products are bf16 x 3, ROADMAP.md Queue C), on the uniform(-1, 1) fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_metal_tpu.kernels.flash_bwd import (
    flash_attention_bwd_fused as jax_fused,
)
from flash_attention_metal_tpu.kernels.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_metal_tpu_torch.config import BlockSizes
from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb

TOL = 1e-4


def _inputs(seed, b, hq, hkv, n, d=64):
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32)

    return u(b, hq, n, d), u(b, hkv, n, d), u(b, hkv, n, d), u(b, hq, n, d), u(b, hq, n)


def _err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want)) / np.max(np.abs(want)))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _jax_case(q, kb, vb, do, off, causal, bkv, dlse=None):
    """The JAX forward's ``o``, ``lse`` and the JAX fused backward's grads."""
    off_j = None if off is None else jnp.asarray(off)
    o, lse = jax_fwd(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), off_j, causal=causal,
                     save_lse=True, interpret=True)
    grads = jax_fused(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), o, jnp.asarray(do), lse, off_j,
        None if dlse is None else jnp.asarray(dlse), causal=causal,
        block_sizes=JaxBlockSizes(block_q_fused=256, block_kv_fused=bkv), interpret=True,
    )
    return o, np.asarray(lse)[..., 0], grads


@pytest.mark.parametrize("bkv", [512, 256], ids=["jax_one_partial", "jax_two_partials"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_bwd_matches_jax(causal, bkv):
    q, k, v, do, _ = _inputs(0, 1, 2, 2, 512)
    o, lse, want = _jax_case(q, k, v, do, None, causal, bkv)
    got = fb.flash_attention_bwd_fused(_t(q), _t(k), _t(v), _t(o), _t(do), _t(lse), causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _err(g, w) < TOL


def test_fused_bwd_with_dlse_and_per_batch_offsets_matches_jax():
    """An lse cotangent and an int32 [B] offset tensor (rows of batch 1
    start 64 columns in)."""
    q, k, v, do, dlse = _inputs(1, 2, 2, 2, 512)
    off = np.asarray([0, 64], np.int32)
    o, lse, want = _jax_case(q, k, v, do, off, True, 256, dlse)
    got = fb.flash_attention_bwd_fused(_t(q), _t(k), _t(v), _t(o), _t(do), _t(lse),
                                       torch.from_numpy(off), _t(dlse), causal=True)
    for g, w in zip(got, want):
        assert _err(g, w) < TOL


def test_fused_bwd_at_head_dim_128_matches_jax():
    """Head dim 128 (the CUDA kernel walks 32-row Q steps there): an lse
    cotangent and per-batch offsets, against the JAX kernel with two dQ
    partials."""
    q, k, v, do, dlse = _inputs(7, 2, 2, 2, 256, d=128)
    off = np.asarray([0, 64], np.int32)
    o, lse, want = _jax_case(q, k, v, do, off, True, 128, dlse)
    got = fb.flash_attention_bwd_fused(_t(q), _t(k), _t(v), _t(o), _t(do), _t(lse),
                                       torch.from_numpy(off), _t(dlse), causal=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _err(g, w) < TOL


def test_dq_workspace_bytes_follow_the_head_dim(monkeypatch):
    """The fused kernel's workspace is one fp32 value per element of dQ
    and an int32 counter per 32 query rows of each (batch, q-head), plus
    the work items' ticket: ``dq_workspace_shape``, the bytes the router
    counts and its decision at the boundary agree at both head dims."""
    for d in (64, 128):
        q = torch.zeros((2, 4, 256, d))
        counters = 1 + 2 * 4 * (256 // 32)
        assert fb.dq_counter_count(2, 4, 256) == counters
        assert fb.dq_workspace_shape(2, 4, 256, d) == (2 * 4 * 256 * d + counters,)
        need = 4 * (2 * 4 * 256 * d + counters)
        assert fb.fused_workspace_bytes(q) == need
        monkeypatch.setattr(fb, "_free_device_bytes",
                            lambda device, n=need: n / fb.FUSED_WORKSPACE_SHARE)
        assert fb.fused_workspace_fits(q)
        monkeypatch.setattr(fb, "_free_device_bytes",
                            lambda device, n=need: n / fb.FUSED_WORKSPACE_SHARE - 1)
        assert not fb.fused_workspace_fits(q)
    # A ragged last chunk of rows has a counter of its own.
    assert fb.dq_counter_count(1, 1, 200) == 1 + 7


def test_dq_workspace_bytes_at_the_training_shape():
    """At the training shape (q [4,16,2048,64]) the workspace is the
    33,554,432-byte accumulator and 4 x 16 x 64 + 1 counters: O(B H N D),
    where one 16 KiB slot per visible tile pair took 553,648,128 bytes."""
    assert fb.fused_workspace_bytes(torch.zeros((4, 16, 2048, 64))) == (
        33_554_432 + 4 * (4 * 16 * 64 + 1))
    assert fb.fused_workspace_bytes(torch.zeros((4, 16, 2048, 128))) == (
        67_108_864 + 4 * (4 * 16 * 64 + 1))


def test_fused_bwd_gqa_matches_jax_on_broadcast_kv():
    """The port's native GQA (one KV head under two q-heads) against the
    JAX kernel on K/V repeated to every head, its dK/dV summed over the
    group afterwards (what the JAX op does)."""
    q, k, v, do, _ = _inputs(2, 1, 2, 1, 512)
    kb, vb = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    o, lse, (dq_j, dk_j, dv_j) = _jax_case(q, kb, vb, do, None, True, 256)
    dq, dk, dv = fb.flash_attention_bwd_fused(_t(q), _t(k), _t(v), _t(o), _t(do), _t(lse),
                                              causal=True)
    assert dk.shape == k.shape and dv.shape == v.shape
    assert _err(dq, dq_j) < TOL
    assert _err(dk, np.asarray(dk_j).sum(axis=1, keepdims=True)) < TOL
    assert _err(dv, np.asarray(dv_j).sum(axis=1, keepdims=True)) < TOL


def test_fused_bwd_fully_masked_rows_give_zero_gradients():
    """Rows that see no column (offset -70: rows 0-69) have lse = -inf;
    their P is rebuilt as 0, so their dQ is 0 and they add nothing to dK or
    dV.  The split pair agrees everywhere."""
    q, k, v, do, _ = (torch.from_numpy(x) for x in _inputs(3, 1, 2, 2, 256))
    off = torch.tensor([-70], dtype=torch.int32)
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import flash_attention_fwd

    o, lse = flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)
    assert bool(torch.isneginf(lse[:, :, :70]).all())
    got = fb.flash_attention_bwd_fused(q, k, v, o, do, lse, off, causal=True)
    want = fb.flash_attention_bwd(q, k, v, o, do, lse, off, causal=True)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert bool((got[0][:, :, :70] == 0).all())
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= TOL * float(w.abs().max())


def test_fused_bwd_keeps_k_dtype_and_checks_its_tile():
    """dK/dV in k's dtype; the kernel's 64-row tiles are built in, so a tile
    setting is refused, not ignored."""
    q, k, v, do, _ = (torch.from_numpy(x).bfloat16() for x in _inputs(4, 1, 2, 2, 128))
    o = torch.zeros_like(q)
    lse = torch.zeros(q.shape[:3])
    got = fb.flash_attention_bwd_fused(q, k, v, o, do, lse, causal=True)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    assert fb.DQ_TILE == 64
    with pytest.raises(TypeError, match="block_sizes"):
        fb.flash_attention_bwd_fused(q, k, v, o, do, lse, causal=True, block_sizes=BlockSizes())
    with pytest.raises(NotImplementedError, match="JAX's fused kernel takes neither"):
        fb.flash_attention_bwd_fused(q, k, v, o, do, lse, causal=True, softcap=30.0)
    # The window is ported: the fused route's gradients are the split
    # pair's under it (their plain versions differ only in dQ's summation).
    fused = fb.flash_attention_bwd_fused(q, k, v, o, do, lse, causal=True, window=16, sinks=2)
    split = fb.flash_attention_bwd(q, k, v, o, do, lse, causal=True, window=16, sinks=2)
    for g, w in zip(fused, split):
        assert float((g.float() - w.float()).abs().max()) <= 1e-2 * float(w.float().abs().max())


def test_fused_plain_sums_64_column_partials():
    """The plain version's dQ is the sum of one ``dS K`` partial per 64 KV
    rows: against the split pair's one product over all 512 rows it agrees
    to fp32 rounding, and its dK/dV are the split pair's."""
    q, k, v, do, _ = (torch.from_numpy(x) for x in _inputs(5, 1, 2, 2, 512))
    off = torch.zeros(1, dtype=torch.int32)
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import flash_attention_fwd

    o, lse = flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)
    kw = dict(sm_scale=0.125, causal=True)
    tiles = fb.flash_attention_bwd_fused_plain(q, k, v, o, do, lse, off, **kw)
    delta = fb.bwd_delta(o, do, None)
    whole = fb.flash_bwd_dq_plain(q, k, v, do, lse, delta, off, **kw)
    dk, dv = fb.flash_bwd_dkv_plain(q, k, v, do, lse, delta, off, **kw)
    assert not torch.equal(tiles[0], whole)  # summed in another order
    assert float((tiles[0] - whole).abs().max()) < 1e-5
    assert torch.equal(tiles[1], dk) and torch.equal(tiles[2], dv)


def test_workspace_counts():
    """The bound the fused kernel reads each offset no higher than: a
    static offset itself, a tensor's bound, every column (``n_kv - 1``)
    with neither or without a causal mask."""
    t = torch.zeros(2, dtype=torch.int32)
    assert fb.fused_offset_bound(None, None, 2048, 2048, True) == 0
    assert fb.fused_offset_bound(None, None, 512, 2048, True) == 1536
    assert fb.fused_offset_bound(-70, 5, 128, 128, True) == -70  # a static offset wins
    assert fb.fused_offset_bound(t, 64, 512, 512, True) == 64
    assert fb.fused_offset_bound(t, None, 512, 512, True) == 511
    assert fb.fused_offset_bound(t, 4096, 512, 512, True) == 511
    assert fb.fused_offset_bound(0, None, 512, 512, False) == 511


def test_fused_bwd_reads_offsets_no_higher_than_the_bound():
    """With ``q_offset_max`` each entry of a tensor offset is read no higher
    than it (as the kernel reads it); a bound that holds changes nothing.  An entry the host can
    read above the bound raises instead (the clamp is what a CUDA tensor's
    entries get, which the host does not read): the plain version's clamp
    is checked directly."""
    q, k, v, do, _ = (torch.from_numpy(x) for x in _inputs(6, 2, 2, 2, 256))
    off = torch.tensor([0, 64], dtype=torch.int32)
    from flash_attention_metal_tpu_torch.kernels.flash_fwd import flash_attention_fwd

    o, lse = flash_attention_fwd(q, k, v, off, causal=True, save_lse=True)
    unbounded = fb.flash_attention_bwd_fused(q, k, v, o, do, lse, off, causal=True)
    held = fb.flash_attention_bwd_fused(q, k, v, o, do, lse, off, causal=True, q_offset_max=64)
    with pytest.raises(ValueError, match="q_offset_max"):
        fb.flash_attention_bwd_fused(q, k, v, o, do, lse, off, causal=True, q_offset_max=0)
    clamped = fb.flash_attention_bwd_fused_plain(q, k, v, o, do, lse, off.clamp(max=0),
                                                 sm_scale=0.125, causal=True)
    zeros = fb.flash_attention_bwd_fused(q, k, v, o, do, lse, torch.zeros_like(off), causal=True)
    for a, b, c, z in zip(unbounded, held, clamped, zeros):
        assert torch.equal(a, b) and torch.equal(c, z)
    assert not torch.equal(unbounded[0], clamped[0])


def test_fused_bwd_refuses_an_offset_above_q_offset_max():
    """An offset the host knows (an int, None, a CPU tensor) above
    ``q_offset_max`` raises: the kernel would read it as ``q_offset_max``
    and return a narrower mask's gradients.  At or below it, it runs."""
    q, k, v, do, _ = _inputs(3, 2, 2, 2, 256)
    o, lse, _ = _jax_case(q, k, v, do, None, True, 256)
    args = (_t(q), _t(k), _t(v), _t(o), _t(do), _t(lse))
    with pytest.raises(ValueError, match="q_offset_max"):
        fb.flash_attention_bwd_fused(*args, torch.tensor([0, 64], dtype=torch.int32),
                                     causal=True, q_offset_max=32)
    with pytest.raises(ValueError, match="q_offset_max"):
        fb.flash_attention_bwd_fused(*args, 64, causal=True, q_offset_max=32)
    with pytest.raises(ValueError, match="q_offset_max"):
        fb.flash_attention_bwd_fused(*args, causal=True, q_offset_max=-1)  # None: offset 0
    got = fb.flash_attention_bwd_fused(*args, torch.tensor([0, 64], dtype=torch.int32),
                                       causal=True, q_offset_max=64)
    want = fb.flash_attention_bwd_fused(*args, torch.tensor([0, 64], dtype=torch.int32),
                                        causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
