"""The sliding window with attention sinks, packed segment ids and the rest
of the op's masking scaffold in the PyTorch port, against the JAX package.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as the JAX package's own tests run them on the CPU) and the
port's (the kernels' plain versions on CPU tensors).  Tolerances:
* oracle forward and lse 2e-5, oracle backward 1e-4 of the largest
  gradient (fp32, summation order only);
* op outputs and lse 2e-5 (the kernel parity tests' ``TOL``); gradients
  1e-4 of each gradient's largest value (``test_torch_flash_bwd.py``), the
  JAX kernels' fp32 products being bf16x3;
* the dropout mask: bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu import config as jax_config
from flash_attention_metal_tpu.kernels import _common as jax_common
from flash_attention_metal_tpu.kernels.flash_bwd import flash_attention_bwd_fused as jax_fused
from flash_attention_metal_tpu.kernels.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_metal_tpu.ops import attention as jax_ops
from flash_attention_metal_tpu.reference import oracle as jax_oracle
from flash_attention_metal_tpu_torch import AttentionConfig, SegmentIds, flash_attention
from flash_attention_metal_tpu_torch.kernels import _common
from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.reference import oracle

TOL = 2e-5
GRAD_TOL = 1e-4


def _u(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.detach().float().numpy() - want)) / max(1.0, np.max(np.abs(want))))


def _abs(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    return float(np.max(np.abs(got[fin] - want[fin]))) if fin.any() else 0.0


def _ids(batch, n, cuts):
    """int32 ``[batch, n]`` segment ids: a new segment at each cut (ragged)."""
    ids = np.zeros((batch, n), np.int32)
    for b in range(batch):
        for c in cuts[b % len(cuts)]:
            ids[b, c:] += 1
    return ids


def _segs(q_ids, kv_ids):
    return (SegmentIds(torch.from_numpy(q_ids), torch.from_numpy(kv_ids)),
            jax_config.SegmentIds(jnp.asarray(q_ids), jnp.asarray(kv_ids)))


# ---------------------------------------------------------------------------
# The oracle: every variant of the JAX oracle.

ORACLE_CASES = {
    "window": dict(causal=True, window=9),
    "window_sinks": dict(causal=True, window=9, sinks=3),
    "window_offset": dict(causal=True, window=20, sinks=2, q_offset=10),
    "segments_causal": dict(causal=True, segment_ids=((5, 30), (17,))),
    "segments_full": dict(causal=False, segment_ids=((5, 30), (17,))),
    "softcap": dict(causal=True, softcap=0.5),
    "alibi": dict(causal=True, alibi_slopes=(0.5, 0.25)),
    "alibi_offset": dict(causal=False, alibi_slopes=(0.5, 0.25), q_offset=3),
    "composed": dict(causal=True, window=12, sinks=4, segment_ids=((20,), (8, 40)),
                     softcap=2.0, alibi_slopes=(0.1, 0.3)),
}


def _oracle_kw(kw, n_q, n_kv):
    t, j = dict(kw), dict(kw)
    if "segment_ids" in kw:
        cuts = kw["segment_ids"]
        t["segment_ids"], j["segment_ids"] = _segs(_ids(2, n_q, cuts), _ids(2, n_kv, cuts))
    if "alibi_slopes" in kw:
        t["alibi_slopes"] = torch.tensor(kw["alibi_slopes"])
        j["alibi_slopes"] = jnp.asarray(kw["alibi_slopes"], jnp.float32)
    return t, j


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracle_forward_and_lse_match_jax(case):
    rng = np.random.default_rng(0)
    n = 48
    q, k, v = (_u(rng, 2, 2, n, 32) for _ in range(3))
    t_kw, j_kw = _oracle_kw(ORACLE_CASES[case], n, n)
    got = oracle.attention_reference(*map(torch.from_numpy, (q, k, v)), **t_kw)
    want = jax_oracle.attention_reference(*map(jnp.asarray, (q, k, v)), **j_kw)
    assert _abs(got, want) < TOL
    got_o, got_l = oracle.attention_reference_with_lse(*map(torch.from_numpy, (q, k, v)), **t_kw)
    want_o, want_l = jax_oracle.attention_reference_with_lse(*map(jnp.asarray, (q, k, v)), **j_kw)
    assert _abs(got_o, want_o) < TOL and _abs(got_l, want_l) < TOL


@pytest.mark.parametrize("rate,seed", [(0.2, 7), (0.5, -3), (0.1, (11, 5, 9, 1, 1))])
def test_oracle_dropout_matches_jax(rate, seed):
    """Dropout with a scalar seed and with a packed seed of shard offsets."""
    rng = np.random.default_rng(1)
    q, k, v = (_u(rng, 2, 2, 40, 32) for _ in range(3))
    got = oracle.attention_reference(*map(torch.from_numpy, (q, k, v)), causal=True,
                                     dropout_rate=rate, dropout_seed=torch.tensor(seed))
    want = jax_oracle.attention_reference(*map(jnp.asarray, (q, k, v)), causal=True,
                                          dropout_rate=rate,
                                          dropout_seed=jnp.asarray(seed, jnp.int32))
    assert _abs(got, want) < TOL


BWD_CASES = {
    "causal": dict(causal=True),
    "softcap": dict(causal=True, softcap=0.5),
    "alibi": dict(causal=False, alibi_slopes=(0.5, 0.25)),
    "dropout": dict(causal=True, dropout_rate=0.3, dropout_seed=5),
    "all": dict(causal=True, softcap=1.0, alibi_slopes=(0.2, 0.1), dropout_rate=0.2,
                dropout_seed=9),
}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_oracle_backward_matches_jax(case):
    """The closed-form backward with its softcap, ALiBi and dropout terms
    against the JAX oracle's (a vjp of its forward)."""
    rng = np.random.default_rng(2)
    q, k, v, do = (_u(rng, 2, 2, 40, 32) for _ in range(4))
    t_kw, j_kw = _oracle_kw(BWD_CASES[case], 40, 40)
    if "dropout_seed" in t_kw:
        t_kw["dropout_seed"] = torch.tensor(t_kw["dropout_seed"])
        j_kw["dropout_seed"] = jnp.asarray(j_kw["dropout_seed"], jnp.int32)
    got = oracle.attention_reference_bwd(*map(torch.from_numpy, (q, k, v, do)), **t_kw)
    want = jax_oracle.attention_reference_bwd(*map(jnp.asarray, (q, k, v, do)), **j_kw)
    for g, w in zip(got, want):
        assert _rel(g, w) < GRAD_TOL
    # The window, sinks and segment ids, which the JAX backward oracle does
    # not take, against torch autograd through the port's forward oracle.
    seg, _ = _segs(_ids(2, 40, ((7, 22),)), _ids(2, 40, ((7, 22),)))
    kw = dict(causal=True, window=9, sinks=2, segment_ids=seg)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = oracle.attention_reference(*leaves, **kw)
    auto = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    closed = oracle.attention_reference_bwd(*map(torch.from_numpy, (q, k, v, do)), **kw)
    for g, w in zip(closed, auto):
        assert _rel(g, w.numpy()) < GRAD_TOL


# ---------------------------------------------------------------------------
# The dropout hash (ROADMAP Queue C item 6): bit for bit.

@pytest.mark.parametrize("seed", [0, 1, 12345, -1, 2**31 - 1, -(2**31)])
def test_dropout_keep_is_bit_exact(seed):
    """Rows and columns past 2**30 and negative int32 coordinates (their top
    bit set), several rates and a packed seed's offsets."""
    offsets = (2**31 - 1000, -5, 3, 7)
    sv_t = _common.pack_dropout_seed(seed, offsets)
    sv_j = jax_common.pack_dropout_seed(seed, offsets)
    assert np.array_equal(sv_t.numpy(), np.asarray(sv_j))
    bh = np.arange(6, dtype=np.int32).reshape(2, 3, 1, 1)
    rows = (np.arange(70, dtype=np.int64) * 40503 + 2**30).astype(np.int32).reshape(1, 1, 70, 1)
    cols = (np.arange(90, dtype=np.int64) * -977).astype(np.int32).reshape(1, 1, 1, 90)
    for rate in (0.1, 0.5, 0.9):
        got = _common.dropout_keep(sv_t[0], torch.from_numpy(bh), torch.from_numpy(rows),
                                   torch.from_numpy(cols), rate)
        want = jax_common.dropout_keep(sv_j[0], jnp.asarray(bh), jnp.asarray(rows),
                                       jnp.asarray(cols), rate)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_pack_dropout_seed_passes_a_packed_seed_and_checks():
    packed = _common.pack_dropout_seed(4, (1, 2, 3, 4))
    assert torch.equal(_common.pack_dropout_seed(packed), packed)
    with pytest.raises(ValueError):
        _common.pack_dropout_seed(packed, (0, 0, 0, 0))
    with pytest.raises(ValueError):
        _common.pack_dropout_seed(torch.zeros(2, dtype=torch.int32))
    assert AttentionConfig().save_lse is False


# ---------------------------------------------------------------------------
# The op: forward, lse and gradients (the split pair's plain versions)
# against the JAX op in interpret mode.  GQA (4 q-heads over 2 KV heads)
# in every case; windows of 1, 63, 64, 65 and >= n_kv.

OP_CASES = {
    "w1": dict(window=1),
    "w63": dict(window=63),
    "w64": dict(window=64),
    "w65_sinks4": dict(window=65, sinks=4),
    "w_past_n": dict(window=300, sinks=2),
    "w16_sinks70": dict(window=16, sinks=70),
    "w40_int_offset": dict(window=40, sinks=3, n_q=128, off="int"),
    "w40_tensor_offsets": dict(window=40, sinks=3, n_q=128, off="tensor"),
    "segments_causal": dict(segments=((37, 130), (90,))),
    "segments_full": dict(causal=False, segments=((37, 130), (90,))),
    "segments_window": dict(window=50, sinks=5, segments=((37, 130), (90,))),
    "segments_window_offsets": dict(window=50, sinks=5, segments=((60,), (10, 100)), n_q=128,
                                    off="tensor"),
}


def _op_inputs(case, seed=0):
    kw = dict(OP_CASES[case])
    n_q, n_kv = kw.pop("n_q", 256), 256
    off = {None: None, "int": n_kv - n_q - 20,
           "tensor": np.asarray([n_kv - n_q, 64], np.int32)}[kw.pop("off", None)]
    causal = kw.pop("causal", True)
    rng = np.random.default_rng(seed)
    q, do = _u(rng, 2, 4, n_q, 64), _u(rng, 2, 4, n_q, 64)
    k, v = _u(rng, 2, 2, n_kv, 64), _u(rng, 2, 2, n_kv, 64)
    t_kw, j_kw = dict(kw), dict(kw)
    if "segments" in kw:
        # Cuts in position space, so that the row at position p shares the
        # id of column p (every row sees something: the fully-masked-row
        # convention differs between the packages, ROADMAP.md Queue C).
        cuts = t_kw.pop("segments")
        j_kw.pop("segments")
        kv_ids = _ids(2, n_kv, cuts)
        shift = np.broadcast_to(n_kv - n_q if off is None else off, (2,))
        q_ids = np.stack([kv_ids[b, shift[b]:shift[b] + n_q] for b in range(2)])
        t_kw["segment_ids"], j_kw["segment_ids"] = _segs(q_ids, kv_ids)
    return q, k, v, do, off, causal, t_kw, j_kw


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_flash_attention_matches_jax(case):
    q, k, v, do, off, causal, t_kw, j_kw = _op_inputs(case)
    j_off = None if off is None else off if isinstance(off, int) else jnp.asarray(off)
    t_off = None if off is None else off if isinstance(off, int) else torch.from_numpy(off)

    def jax_f(q_, k_, v_):
        return jax_ops.flash_attention(q_, k_, v_, j_off, causal=causal, save_lse=True,
                                       interpret=True, **j_kw)

    (want_o, want_l), vjp = jax.vjp(jax_f, *map(jnp.asarray, (q, k, v)))
    want_g = vjp((jnp.asarray(do), jnp.zeros_like(want_l)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = flash_attention(*leaves, t_off, causal=causal, save_lse=True, **t_kw)
    assert _abs(o, want_o) < TOL and _abs(lse, want_l) < TOL
    got_g = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for g, w in zip(got_g, want_g):
        assert _rel(g, w) < GRAD_TOL
    # impl="reference" (the fp32 oracle) agrees too.
    ref = flash_attention(*map(torch.from_numpy, (q, k, v)), t_off, causal=causal,
                          impl="reference", **t_kw)
    assert _abs(ref, want_o) < TOL


@pytest.mark.parametrize("case", ["w1", "w65_sinks4", "w40_tensor_offsets", "segments_window"])
def test_fused_backward_matches_jax(case):
    """The fused backward's plain version under the features against the
    JAX fused kernel (two 128-row dQ partials)."""
    q, k, v, do, off, causal, t_kw, j_kw = _op_inputs(case, seed=3)
    group = q.shape[1] // k.shape[1]
    kb, vb = (np.repeat(x, group, axis=1) for x in (k, v))  # the JAX kernel takes equal heads
    off_j = None if off is None else jnp.asarray(off)
    o, lse = jax_fwd(*map(jnp.asarray, (q, kb, vb)), off_j, causal=causal, save_lse=True,
                     interpret=True, **j_kw)
    want = jax_fused(*map(jnp.asarray, (q, kb, vb)), o, jnp.asarray(do), lse, off_j, None,
                     causal=causal, block_sizes=jax_config.BlockSizes(
                         block_q_fused=128, block_kv_fused=128), interpret=True, **j_kw)
    t = [torch.from_numpy(np.asarray(x, np.float32)) for x in (q, k, v, o, do)]
    t_off = None if off is None else torch.from_numpy(off)
    got = fb.flash_attention_bwd_fused(*t, torch.from_numpy(np.asarray(lse)[..., 0]), t_off,
                                       causal=causal, **t_kw)
    dk_w = np.asarray(want[1]).reshape(2, 2, group, 256, 64).sum(axis=2)
    dv_w = np.asarray(want[2]).reshape(2, 2, group, 256, 64).sum(axis=2)
    for g, w in zip(got, (want[0], dk_w, dv_w)):
        assert _rel(g, w) < GRAD_TOL


def test_featured_calls_take_the_general_kernel_as_in_jax():
    """A window or segment ids send a static-offset call to the general
    kernel, as the JAX router does (lean and triangular take neither)."""
    seg = SegmentIds(torch.zeros((1, 64), dtype=torch.int32), torch.zeros((1, 64), dtype=torch.int32))
    for causal in (False, True):
        assert ff.fwd_route(64, None, causal=causal) in ("lean", "tri")
        assert ff.fwd_route(64, None, causal=causal, featured=True) == "general"
    q = torch.zeros((1, 2, 64, 64))
    calls = []
    real = ff.flash_fwd_general
    try:
        ff.flash_fwd_general = lambda *a, **kw: (calls.append(kw), real(*a, **kw))[1]
        ff.flash_attention_fwd(q, q, q, causal=False, segment_ids=seg)
        ff.flash_attention_fwd(q, q, q, causal=True, window=8, sinks=2)
        ff.flash_attention_fwd(q, q, q, causal=True, sinks=2)  # sinks alone: no window
    finally:
        ff.flash_fwd_general = real
    assert len(calls) == 2 and calls[1]["window"] == 8 and calls[1]["sinks"] == 2
    qt = torch.zeros((1, 2, 8, 64))
    assert fb.bwd_route(qt, qt, None, causal=True, featured=True) == "split"


def test_feature_arguments_are_checked():
    q = torch.zeros((1, 2, 64, 64))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, causal=False, window=8)
    with pytest.raises(ValueError, match=">= 1"):
        flash_attention(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="sinks"):
        flash_attention(q, q, q, causal=True, window=8, sinks=-1)
    bad = SegmentIds(torch.zeros((1, 63), dtype=torch.int32), torch.zeros((1, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="segment ids"):
        flash_attention(q, q, q, causal=True, segment_ids=bad)
    seg = SegmentIds(torch.zeros((1, 64), dtype=torch.int32), torch.zeros((1, 64), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="pos_div"):
        ff.flash_fwd_general(q, q, q, causal=True, pos_div=2, segment_ids=seg)
    # The softcap, ALiBi, dropout (tests/test_torch_xf.py,
    # tests/test_torch_dropout.py) and a rolling cache's position map
    # (tests/test_torch_rolling.py) compose with the window, and dropout
    # without its seed raises.
    for kw in (dict(softcap=30.0), dict(alibi_slopes=torch.ones(2)),
               dict(dropout_rate=0.1, dropout_seed=3),
               dict(kv_positions=torch.arange(64, dtype=torch.int32)[None])):
        assert flash_attention(q, q, q, causal=True, window=8, **kw).shape == q.shape
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, q, q, causal=True, window=8, dropout_rate=0.1)


def test_split_partials_outside_the_window_are_empty():
    """The decode grid's plain partials: a split wholly outside a row's
    window and sinks has m = -inf, l = 0, o = 0, and the merge of the
    partials is the unsplit forward."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_u(rng, 2, 2, 4, 64))
    k, v = (torch.from_numpy(_u(rng, 2, 1, 1024, 64)) for _ in range(2))
    off = torch.tensor([1000, 700], dtype=torch.int32)
    kw = dict(sm_scale=0.125, causal=True, pos_div=2, window=200, sinks=4)
    o_s, m_s, l_s = ff.split_partials_plain(q, k, v, off, 256, **kw)
    # Batch 0 rows sit at 1000-1001: splits 1 and 2 (columns 256-767) hold
    # neither the sinks nor the window.
    for s in (1, 2):
        assert torch.all(torch.isneginf(m_s[s, 0])) and torch.all(l_s[s, 0] == 0)
        assert torch.all(o_s[s, 0] == 0)
    o, lse = ff.merge_splits_plain(o_s, m_s, l_s)
    want_o, want_l = ff.flash_attention_fwd_plain(q, k, v, off, save_lse=True, **kw)
    assert float((o - want_o).abs().max()) < TOL and float((lse - want_l).abs().max()) < TOL
