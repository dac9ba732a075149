"""PyTorch port: block-sparse attention against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
functions run their Pallas kernels (``_fwd_sparse_kernel``,
``_dkv_sparse_kernel``, ``_dq_sparse_kernel``) in interpret mode, as
``tests/test_block_sparse.py`` does on the CPU; the port runs each kernel's
plain version, which its wrapper takes for CPU tensors.  The CUDA kernels
run only on a card (``test_torch_gpu.py``).  The same operator-only
predicates serve both packages (numpy int arrays in the port, traced
arrays in JAX).

Tolerances: the forward, fp32 2e-5 on the uniform(-1, 1) fixture (the JAX
kernel's fp32 products are bf16 x 3, ROADMAP.md Queue C) and bf16 2e-2
(the JAX kernel rounds Q * scale and P to bf16 inside its products);
gradients 1e-4 of the largest gradient (fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.kernels import flash_mask as jfm
from flash_attention_metal_tpu_torch import kernels as port_kernels
from flash_attention_metal_tpu_torch.kernels import flash_mask as fm

N = 512
# tests/test_block_sparse.py's masks, and ladder rung 11's at n = 512.
MASKS = {
    # causal AND (band OR dilated stripes): empty, partial and full blocks
    "banded-stripes": lambda r, c: (c <= r) & (((r - c) < 96) | ((c % 192) < 64)),
    # block-diagonal chunks of 160 (not block-aligned: partial edges)
    "chunked-local": lambda r, c: (r // 160) == (c // 160),
    # dead rows: rows 0-63 see nothing at all
    "dead-rows": lambda r, c: (r >= 64) & (c <= r),
    "rung11": lambda r, c: (c <= r) & (((r - c) < N // 4) | ((c % (3 * N // 8)) < N // 8)),
}
TOL_FP32, TOL_BF16, TOL_GRAD = 2e-5, 2e-2, 1e-4


def _inputs(seed, b, hq, hkv, n, d=64):
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32)

    return u(b, hq, n, d), u(b, hkv, n, d), u(b, hkv, n, d), u(b, hq, n, d)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want)) / np.max(np.abs(want)))


def _masks(name, n=N, block=128):
    return fm.BlockMask(MASKS[name], n, n, block, block), jfm.BlockMask(MASKS[name], n, n, block,
                                                                       block)


@pytest.mark.parametrize("block", [128, 64], ids=["blocks128", "blocks64"])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_block_mask_fields_equal_jax(name, block):
    ours, theirs = _masks(name, block=block)
    for field in ("occupancy", "q_counts", "kv_ids", "kv_counts", "q_ids"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (ours.max_kv, ours.max_q, ours.density) == (theirs.max_kv, theirs.max_q, theirs.density)


def _dense_from_tables(t: fm.MaskTables, n_q: int, n_kv: int, by_kv: bool) -> np.ndarray:
    """The elementwise mask the kernels see, rebuilt from one of the two
    lists (each walked to its count, as the kernels walk it)."""
    ptr, lst = (t.kv_ptr, t.kv_list) if by_kv else (t.q_ptr, t.q_list)
    bits = t.bit_tiles.numpy().view(np.uint32)
    tiles = -(-(n_q if not by_kv else n_kv) // fm.TILE)
    dense = np.zeros((-(-n_q // 64) * 64, -(-n_kv // 64) * 64), bool)
    for a in range(tiles):
        for e in range(int(ptr[a]), int(ptr[a + 1])):
            other, idx = lst[e].tolist()
            i, j = (other, a) if by_kv else (a, other)
            if idx < 0:
                tile = np.ones((64, 64), bool)
            else:
                tile = ((bits[idx][:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(64, 64)
            dense[i * 64:(i + 1) * 64, j * 64:(j + 1) * 64] = tile
    return dense[:n_q, :n_kv]


@pytest.mark.parametrize("name", sorted(MASKS))
def test_tables_hold_the_mask_and_scale_with_visited_pairs(name):
    """Both lists rebuild the elementwise mask exactly, full pairs carry no
    bit tile, and the tables' bytes are 16 per visited pair plus 512 per
    partial one (no [N, N] array)."""
    bm, _ = _masks(name)
    t = bm.tables("cpu")
    want = bm.dense().numpy()
    assert np.array_equal(_dense_from_tables(t, N, N, by_kv=False), want)
    assert np.array_equal(_dense_from_tables(t, N, N, by_kv=True), want)
    nnz, partial = t.q_list.shape[0], t.bit_tiles.shape[0]
    assert t.kv_list.shape[0] == nnz and int(t.q_ptr[-1]) == int(t.kv_ptr[-1]) == nnz
    assert partial == int((t.q_list[:, 1] >= 0).sum())
    assert t.nbytes == 4 * (2 * (N // 64 + 1)) + 16 * nnz + 512 * partial


def test_rung11_mask_at_n2048_has_the_stated_blocks():
    """The chip smoke's mask: 76 full and 24 partial of 256 128-blocks
    (block density 0.39), element density 0.344."""
    n = 2048
    mask_fn = lambda r, c: (c <= r) & (((r - c) < n // 4) | ((c % (3 * n // 8)) < n // 8))  # noqa: E731
    bm = fm.BlockMask(mask_fn, n, n, 128, 128)
    dense = bm.dense().numpy().reshape(16, 128, 16, 128)
    full = int(dense.all(axis=(1, 3)).sum())
    assert (full, int(bm.occupancy.sum()) - full) == (76, 24)
    assert round(bm.density, 2) == 0.39
    assert round(bm.visible_pairs() / n**2, 3) == 0.344


def test_ragged_lengths_mask_the_edge_tiles():
    """n not a multiple of the 64-row tile: the last tiles are partial, and
    their rows and columns past n are off."""
    n = 200
    bm = fm.BlockMask(lambda r, c: c <= r, n, n, 8, 8)
    t = bm.tables("cpu")
    assert np.array_equal(_dense_from_tables(t, n, n, by_kv=False), np.tril(np.ones((n, n), bool)))
    last = [int(x) for x in t.q_list[int(t.q_ptr[3]):int(t.q_ptr[4]), 1]]
    assert all(idx >= 0 for idx in last)


def _jax_fwd(q, k, v, jbm, dtype):
    o, lse = jfm.flash_attention_block_sparse_fwd(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype), jbm, save_lse=True,
        interpret=True)
    return np.asarray(o, np.float32), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_fwd_matches_jax(name, dtype):
    """o and lse of the forward against JAX ``flash_attention_block_sparse_fwd``."""
    tdt, jdt, tol = {"fp32": (torch.float32, jnp.float32, TOL_FP32),
                     "bf16": (torch.bfloat16, jnp.bfloat16, TOL_BF16)}[dtype]
    q, k, v, _ = _inputs(0, 1, 2, 2, N)
    bm, jbm = _masks(name)
    o_j, lse_j = _jax_fwd(q, k, v, jbm, jdt)
    o, lse = fm.flash_attention_block_sparse_fwd(_t(q, tdt), _t(k, tdt), _t(v, tdt), bm,
                                                 save_lse=True)
    assert o.dtype == tdt and lse.dtype == torch.float32 and lse.shape == (1, 2, N)
    assert float(np.max(np.abs(o.float().numpy() - o_j))) < tol
    finite = np.isfinite(lse_j)
    assert np.array_equal(finite, torch.isfinite(lse).numpy())
    assert float(np.max(np.abs(lse.numpy()[finite] - lse_j[finite]))) < tol


def _jax_grads(q, k, v, do, jbm):
    def f(q_, k_, v_):
        return jnp.sum(jfm.flash_attention_block_sparse(q_, k_, v_, jbm, None, True) * do)

    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _torch_grads(q, k, v, do, bm, op=fm.flash_attention_block_sparse):
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = op(*leaves, bm)
    return torch.autograd.grad((o.float() * do).sum(), leaves)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_op_grads_match_jax(name):
    """torch autograd through the op against ``jax.grad`` through the JAX
    custom_vjp (both backward kernels, interpret mode)."""
    q, k, v, do = _inputs(1, 1, 2, 2, N)
    bm, jbm = _masks(name)
    want = _jax_grads(q, k, v, do, jbm)
    got = _torch_grads(*map(_t, (q, k, v, do)), bm)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _err(g, w) < TOL_GRAD


def test_bwd_kernels_plain_versions_match_jax_kernels():
    """``flash_attention_block_sparse_bwd`` (delta, then the dK/dV and dQ
    kernels' plain versions) against the JAX function on the same o and
    lse, equal heads."""
    q, k, v, do = _inputs(2, 2, 2, 2, 256)
    name = "chunked-local"
    bm, jbm = fm.BlockMask(MASKS[name], 256, 256, 128, 128), jfm.BlockMask(MASKS[name], 256, 256,
                                                                           128, 128)
    o, lse = jfm.flash_attention_block_sparse_fwd(*map(jnp.asarray, (q, k, v)), jbm, save_lse=True,
                                                  interpret=True)
    want = jfm.flash_attention_block_sparse_bwd(*map(jnp.asarray, (q, k, v)), o, jnp.asarray(do),
                                                lse, jbm, interpret=True)
    got = fm.flash_attention_block_sparse_bwd(_t(q), _t(k), _t(v), _t(o), _t(do),
                                              _t(np.asarray(lse)[..., 0]), bm)
    for g, w in zip(got, want):
        assert _err(g, w) < TOL_GRAD


def test_gqa_matches_jax_repeat_and_sum():
    """q 4 heads over 2 KV heads: the forward against JAX's native GQA, the
    gradients (dK/dV summed over each group in fp32 by the port's dK/dV
    kernel) against JAX's repeat-and-sum."""
    q, _, _, do = _inputs(3, 1, 4, 2, N)
    _, k, v, _ = _inputs(5, 1, 4, 2, N)
    bm, jbm = _masks("banded-stripes")
    o_j, _ = _jax_fwd(q, k, v, jbm, jnp.float32)
    o = fm.block_sparse_attention(_t(q), _t(k), _t(v), bm)
    assert float(np.max(np.abs(o.numpy() - o_j))) < TOL_FP32
    want = _jax_grads(q, k, v, do, jbm)
    got = _torch_grads(*map(_t, (q, k, v, do)), bm, op=fm.block_sparse_attention)
    assert got[1].shape == k.shape
    for g, w in zip(got, want):
        assert _err(g, w) < TOL_GRAD


def test_dead_rows_give_zero_output_minus_inf_lse_and_zero_grads():
    q, k, v, do = map(_t, _inputs(4, 1, 2, 1, N))
    bm, _ = _masks("dead-rows")
    o, lse = fm.flash_attention_block_sparse_fwd(q, k, v, bm, save_lse=True)
    assert torch.all(o[:, :, :64] == 0) and torch.all(torch.isneginf(lse[:, :, :64]))
    assert bool(torch.isfinite(lse[:, :, 64:]).all())
    dq, dk, dv = _torch_grads(q, k, v, do, bm)
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all())
    assert torch.all(dq[:, :, :64] == 0)


def test_fp16_runs_in_fp32_and_rounds_back():
    q, k, v, do = (_t(x, torch.float16) for x in _inputs(6, 1, 2, 2, 256))
    bm = fm.BlockMask(MASKS["banded-stripes"], 256, 256, 128, 128)
    o = fm.block_sparse_attention(q, k, v, bm)
    assert o.dtype == torch.float16
    assert torch.equal(o, fm.block_sparse_attention(q.float(), k.float(), v.float(), bm).half())
    assert all(g.dtype == torch.float16 for g in _torch_grads(q, k, v, do.float(), bm))
    o, lse = fm.flash_attention_block_sparse_fwd(q, k, v, bm, save_lse=True)
    grads = fm.flash_attention_block_sparse_bwd(q, k, v, o, do, lse, bm)
    want = fm.flash_attention_block_sparse_bwd(q.float(), k.float(), v.float(), o.float(),
                                               do.float(), lse, bm)
    for g, w in zip(grads, want):
        assert g.dtype == torch.float16 and torch.equal(g, w.half())


def test_the_kernels_package_exports_jax_names():
    for name in ("BlockMask", "block_sparse_attention", "flash_attention_block_sparse",
                 "flash_attention_block_sparse_fwd"):
        assert name in port_kernels.__all__ and hasattr(port_kernels, name)


def test_wrong_shapes_and_devices_raise():
    q = torch.zeros((1, 2, 256, 64))
    bm = fm.BlockMask(MASKS["banded-stripes"], 512, 512, 128, 128)
    with pytest.raises(ValueError, match="mask compiled"):
        fm.block_sparse_attention(q, q, q, bm)
    with pytest.raises(ValueError, match="not divisible"):
        fm.BlockMask(MASKS["banded-stripes"], 500, 512, 128, 128)
    meta = torch.zeros((1, 2, 512, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fm.flash_sparse_fwd(meta, meta, meta, bm, sm_scale=0.125)


def test_plain_backward_survives_scores_far_above_the_lse():
    """An invisible score far above its row's lse (the spike fixture: one
    key scored ~100 above the rest, seen by some rows only) must give P = 0
    there, not exp overflow times 0 = NaN."""
    q, k, v, do = map(_t, _inputs(8, 1, 2, 2, 256))
    q[..., 0], k[..., 200, 0] = 8.0, 100.0
    bm = fm.BlockMask(MASKS["banded-stripes"], 256, 256, 128, 128)
    for g in _torch_grads(q, k, v, do, bm):
        assert bool(torch.isfinite(g).all())
