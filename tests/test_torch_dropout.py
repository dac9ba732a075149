"""Attention dropout in the PyTorch port against the JAX package.

The keep mask is a stateless hash of a seed and each score's (batch,
q-head, row, column) tensor indices, so the port's kernels' plain versions,
its oracle and the JAX kernels (in interpret mode, as the JAX package's own
``tests/test_dropout.py`` runs them on the CPU) hold the same mask bit for
bit, and dropout is compared at fp32 tolerance, not statistically.  The
same numpy inputs go through both packages.  Tolerances, fp32:
* op outputs and lse 2e-5 (``test_torch_xf.py``'s ``TOL``);
* dQ, dK, dV 1e-4 of each gradient's largest value (the JAX kernels' fp32
  products are bf16x3);
* the model's loss 1e-5, its gradients 1e-4 of each leaf's largest value
  (``test_torch_train.py``'s ``TOL``).
JAX draws the model's per-layer seeds with ``jax.random``, which the port
cannot reproduce: the model tests draw them in JAX and hand them to both.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu import config as jax_config
from flash_attention_metal_tpu.kernels import _common as jax_common
from flash_attention_metal_tpu.kernels.flash_bwd import flash_attention_bwd_auto as jax_bwd_auto
from flash_attention_metal_tpu.kernels.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu.ops import attention as jax_ops
from flash_attention_metal_tpu.reference import oracle as jax_oracle
from flash_attention_metal_tpu_torch import SegmentIds, flash_attention
from flash_attention_metal_tpu_torch.harness import autotune
from flash_attention_metal_tpu_torch.kernels import _common
from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels import flash_tri
from flash_attention_metal_tpu_torch.models import (
    ModelConfig,
    Trainer,
    make_optimizer,
    params_from_jax,
)
from flash_attention_metal_tpu_torch.models import transformer as tf
from flash_attention_metal_tpu_torch.ops import attention as ops
from flash_attention_metal_tpu_torch.reference import oracle

TOL = 2e-5
GRAD_TOL = 1e-4
RATE = 0.2
SEED = 1234
# A seed with its top bit set (the hash takes it as unsigned), shard offsets
# (row, col, batch, head) and a global head count that puts bh past 2^16.
BIG_SEED = -1_234_567_891
OFFSETS = (1000, 333, 30, 7)
HEADS = 4096


def _u(rng, *shape, scale=1.0):
    return (rng.uniform(-1.0, 1.0, shape) * scale).astype(np.float32)


def _abs(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    return float(np.max(np.abs(got[fin] - want[fin]))) if fin.any() else 0.0


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.detach().float().numpy() - want)) / max(1.0, np.max(np.abs(want))))


def _ids(batch, n, cuts):
    ids = np.zeros((batch, n), np.int32)
    for b in range(batch):
        for c in cuts[b % len(cuts)]:
            ids[b, c:] += 1
    return ids


# The op, forward and gradients: 4 q-heads over 2 KV heads, N 128, D 64, q
# scaled by 3.  Causal and not; an int and a per-batch tensor offset (which
# never enter the hash); the window with sinks, the softcap and ALiBi all
# together; segment ids; shard offsets with a global head count and a seed
# with its top bit set.
OP_CASES = {
    "causal": dict(),
    "full": dict(causal=False),
    "int_offset": dict(n_q=96, off="int"),
    "tensor_offsets": dict(n_q=96, off="tensor"),
    "all_features": dict(window=40, sinks=4, softcap=30.0, alibi=(0.25, 0.0625, 0.5, 0.125)),
    "segments": dict(segments=((37, 90), (60,))),
    "shard": dict(seed=BIG_SEED, dropout_offsets=OFFSETS, dropout_heads=HEADS),
}


def _op_inputs(case, seed=0):
    kw = dict(OP_CASES[case])
    n_q, n_kv = kw.pop("n_q", 128), 128
    off = {None: None, "int": n_kv - n_q - 20,
           "tensor": np.asarray([n_kv - n_q, 17], np.int32)}[kw.pop("off", None)]
    causal = kw.pop("causal", True)
    drop_seed = kw.pop("seed", SEED)
    rng = np.random.default_rng(seed)
    q, do = _u(rng, 2, 4, n_q, 64, scale=3.0), _u(rng, 2, 4, n_q, 64)
    k, v = _u(rng, 2, 2, n_kv, 64), _u(rng, 2, 2, n_kv, 64)
    t_kw = dict(kw, dropout_rate=RATE, dropout_seed=drop_seed)
    j_kw = dict(kw, dropout_rate=RATE, dropout_seed=jnp.int32(drop_seed))
    if "alibi" in kw:
        slopes = np.asarray(t_kw.pop("alibi"), np.float32)
        j_kw.pop("alibi")
        t_kw["alibi_slopes"], j_kw["alibi_slopes"] = torch.from_numpy(slopes), jnp.asarray(slopes)
    if "segments" in kw:
        cuts = t_kw.pop("segments")
        j_kw.pop("segments")
        kv_ids = _ids(2, n_kv, cuts)
        q_ids = kv_ids[:, n_kv - n_q:]
        t_kw["segment_ids"] = SegmentIds(torch.from_numpy(q_ids.copy()), torch.from_numpy(kv_ids))
        j_kw["segment_ids"] = jax_config.SegmentIds(jnp.asarray(q_ids), jnp.asarray(kv_ids))
    return q, k, v, do, off, causal, t_kw, j_kw


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_flash_attention_matches_jax(case):
    """Outputs, lse (the undropped one's), dQ, dK and dV of the op against
    the JAX op, and the port's oracle (``impl="reference"``) too."""
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
    for g, w in zip(torch.autograd.grad(o, leaves, torch.from_numpy(do)), want_g):
        assert _rel(g, w) < GRAD_TOL
    ref = flash_attention(*map(torch.from_numpy, (q, k, v)), t_off, causal=causal,
                          impl="reference", **t_kw)
    assert _abs(ref, want_o) < TOL
    # Dropout is in force: the undropped output differs.
    plain = {key: val for key, val in t_kw.items() if not key.startswith("dropout")}
    undropped = flash_attention(*map(torch.from_numpy, (q, k, v)), t_off, causal=causal, **plain)
    assert float((undropped - ref).abs().max()) > 1e-3


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_the_jax_kernel(causal):
    """The general forward's plain version against JAX's ``_fwd_kernel``
    with several KV blocks (its streaming softmax), in interpret mode."""
    rng = np.random.default_rng(1)
    q, k, v = _u(rng, 2, 3, 256, 64), _u(rng, 2, 3, 256, 64), _u(rng, 2, 3, 256, 64)
    bs = jax_config.BlockSizes(block_q=128, block_k_major=128, block_k=128)
    want = jax_fwd(*map(jnp.asarray, (q, k, v)), causal=causal, dropout_rate=RATE,
                   dropout_seed=jnp.int32(SEED), block_sizes=bs, save_lse=True, interpret=True)
    got = ff.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                 dropout_rate=RATE, dropout_seed=SEED, save_lse=True)
    # JAX keeps the lse lane-broadcast, [B, H, N, 128].
    assert _abs(got[0], want[0]) < TOL and _abs(got[1], want[1][..., 0]) < TOL


@pytest.mark.parametrize("case", ["causal", "all_features", "shard"])
def test_split_backward_matches_jax_kernels(case):
    """The split pair's plain versions (``flash_attention_bwd`` from the
    forward's o and lse) against the JAX backward router in interpret mode,
    which sends dropout to its split pair (equal heads: JAX's op repeats
    K/V under dropout)."""
    q, k, v, do, off, causal, t_kw, j_kw = _op_inputs(case, seed=4)
    kb, vb = (np.repeat(x, 2, axis=1) for x in (k, v))
    j_kw["dropout_seed"] = _common.pack_dropout_seed(
        t_kw["dropout_seed"], j_kw.pop("dropout_offsets", None)).numpy()
    t_kw["dropout_seed"] = torch.from_numpy(j_kw["dropout_seed"])
    t_kw.pop("dropout_offsets", None)
    o, lse = ff.flash_attention_fwd(*map(torch.from_numpy, (q, kb, vb)), causal=causal,
                                    save_lse=True, **t_kw)
    lse_lanes = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None], lse.shape + (128,))
    want = jax_bwd_auto(*map(jnp.asarray, (q, kb, vb, o.numpy(), do)), lse_lanes, None,
                        causal=causal, interpret=True, **j_kw)
    got = fb.flash_attention_bwd(*map(torch.from_numpy, (q, kb, vb)), o, torch.from_numpy(do),
                                 lse, causal=causal, **t_kw)
    assert len(got) == len(want)
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) < GRAD_TOL


def test_gqa_grads_match_the_broadcast_oracle():
    """4 q-heads over 2 KV heads: the port's native GQA gradients (the keep
    mask of each q-head, dK/dV summed over the group) against JAX's oracle
    on repeated K/V."""
    rng = np.random.default_rng(2)
    q, do = _u(rng, 1, 4, 128, 64), _u(rng, 1, 4, 128, 64)
    k, v = _u(rng, 1, 2, 128, 64), _u(rng, 1, 2, 128, 64)

    def oracle_f(q_, k_, v_):
        return jax_oracle.attention_reference(q_, jnp.repeat(k_, 2, 1), jnp.repeat(v_, 2, 1),
                                              causal=True, dropout_rate=RATE,
                                              dropout_seed=jnp.int32(SEED))

    _, vjp = jax.vjp(oracle_f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = flash_attention(*leaves, causal=True, dropout_rate=RATE, dropout_seed=SEED)
    for g, w in zip(torch.autograd.grad(o, leaves, torch.from_numpy(do)), want):
        assert _rel(g, w) < GRAD_TOL


def test_dropout_offsets_give_slices_of_the_global_mask():
    """A shard of a call (rows, batches, heads) with ``dropout_offsets``
    (and the global head count) draws the global call's mask: its output
    is that slice of the full output, as JAX
    ``test_dropout_offsets_global_coordinates`` holds for rows."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_u(rng, 2, 4, 256, 64)) for _ in range(3))
    kw = dict(dropout_rate=RATE, dropout_seed=SEED)
    full = oracle.attention_reference(q, k, v, **kw)
    want_j = jax_oracle.attention_reference(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                            dropout_rate=RATE, dropout_seed=jnp.int32(SEED))
    assert _abs(full, want_j) < TOL
    rows = flash_attention(q[:, :, 128:], k, v, q_offset=128, dropout_offsets=(128, 0, 0, 0), **kw)
    assert _abs(rows, full[:, :, 128:].numpy()) < TOL
    batch = flash_attention(q[1:], k[1:], v[1:], dropout_offsets=(0, 0, 1, 0), dropout_heads=4,
                            **kw)
    assert _abs(batch, full[1:].numpy()) < TOL
    heads = flash_attention(q[:, 2:], k[:, 2:], v[:, 2:], dropout_offsets=(0, 0, 0, 2),
                            dropout_heads=4, **kw)
    assert _abs(heads, full[:, 2:].numpy()) < TOL
    # Without the offsets the shard draws another mask.
    assert _abs(flash_attention(q[:, :, 128:], k, v, q_offset=128, **kw),
                full[:, :, 128:].numpy()) > 1e-3


def test_keep_factors_equal_the_jax_mask_bit_for_bit():
    """``keep_factors`` of a [B, H, N_q, N_kv] call (the plain versions'
    mask) against JAX's ``dropout_keep`` at the same global coordinates,
    with shard offsets, a global head count and a seed whose top bit is
    set; the kept share is 1 - rate."""
    shape = (2, 3, 40, 72)
    packed = _common.pack_dropout_seed(BIG_SEED, OFFSETS)
    got = _common.keep_factors(shape, RATE, packed, HEADS).numpy()
    sv = packed.numpy().astype(np.int64)
    bh = ((np.arange(2)[:, None] + sv[3]) * HEADS + np.arange(3)[None, :] + sv[4]).astype(np.int32)
    want = jax_common.dropout_keep(
        jnp.int32(sv[0]), jnp.asarray(bh.reshape(2, 3, 1, 1)),
        jnp.asarray((sv[1] + np.arange(40)).reshape(1, 1, 40, 1).astype(np.int32)),
        jnp.asarray((sv[2] + np.arange(72)).reshape(1, 1, 1, 72).astype(np.int32)), RATE)
    assert np.array_equal(got, np.asarray(want))
    assert abs(float((got > 0).mean()) - (1 - RATE)) < 0.02
    # A column shard's mask is the slice of the global one.
    full = _common.keep_factors((2, 3, 40, 136), RATE, SEED)
    part = _common.keep_factors((2, 3, 40, 72), RATE, _common.pack_dropout_seed(SEED, (0, 64, 0, 0)))
    assert torch.equal(part, full[..., 64:])
    assert ff.check_dropout(RATE, SEED).c_args(4)[1:] == (
        _common.dropout_threshold(RATE), np.float32(1.25).item(), 4)


def test_dropout_arguments_are_checked():
    """JAX's checks and messages (``flash_fwd.py:905-929``,
    ``ops/attention.py:401-440``), and the paths that take no dropout."""
    q = torch.zeros((1, 2, 64, 64))
    lse = torch.zeros((1, 2, 64))
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout_rate must be in"):
            flash_attention(q, q, q, causal=True, dropout_rate=rate, dropout_seed=1)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        ff.flash_attention_fwd(q, q, q, causal=True, dropout_rate=0.1)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        fb.flash_attention_bwd(q, q, q, q, q, lse, causal=True, dropout_rate=0.1)
    with pytest.raises(ValueError, match=r"\(row, col, batch, head\)"):
        flash_attention(q, q, q, causal=True, dropout_rate=0.1, dropout_seed=1,
                        dropout_offsets=(1, 2))
    with pytest.raises(ValueError, match="pre-packed"):
        flash_attention(q, q, q, causal=True, dropout_rate=0.1,
                        dropout_seed=_common.pack_dropout_seed(1), dropout_offsets=(0, 0, 0, 0))
    with pytest.raises(NotImplementedError, match="pos_div"):
        ff.flash_fwd_general(q, q[:, :1], q[:, :1], causal=True, pos_div=2, dropout_rate=0.1,
                             dropout_seed=1)
    with pytest.raises(NotImplementedError, match="dropout"):
        ops.gqa_decode_attention(q[:, :, :1], q, q, torch.zeros(1, dtype=torch.int32),
                                 dropout_rate=0.1, dropout_seed=1)
    with pytest.raises(NotImplementedError, match="dropout"):
        fb.flash_attention_bwd_fused(q, q, q, q, q, lse, causal=True, dropout_rate=0.1,
                                     dropout_seed=1)
    with pytest.raises(NotImplementedError, match="save_lse with dropout"):
        flash_attention(q, q, q, causal=True, impl="reference", save_lse=True,
                        dropout_rate=0.1, dropout_seed=1)
    # A rolling cache's serving path takes no dropout, with JAX's message.
    with pytest.raises(NotImplementedError, match="training-path feature"):
        flash_attention(q, q, q, causal=True, dropout_rate=0.1, dropout_seed=1,
                        kv_positions=torch.zeros((1, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="dropout_heads"):
        flash_attention(q, q, q, causal=True, dropout_rate=0.1, dropout_seed=1, dropout_heads=0)
    # A rate of 0 reads no seed; the kernel path composes save_lse with
    # dropout, its lse the undropped one's (JAX tests/test_dropout.py).
    assert flash_attention(q, q, q, causal=True, dropout_rate=0.0).shape == q.shape
    o, l_drop = flash_attention(q + 1, q, q, causal=True, save_lse=True, dropout_rate=0.1,
                                dropout_seed=1)
    assert torch.equal(l_drop, flash_attention(q + 1, q, q, causal=True, save_lse=True)[1])


def test_dropout_takes_the_general_forward_and_the_split_backward(tmp_path, monkeypatch):
    """A dropout call with a static offset takes the general forward (lean
    and triangular take none, JAX ``flash_fwd.py:829-835, 932-935``) and
    the split backward, a saved "fused" decision included (JAX
    ``flash_bwd.py:496-508``)."""
    q = torch.zeros((1, 2, 64, 64))
    kw = dict(dropout_rate=0.1, dropout_seed=1)
    for causal in (True, False):
        calls = []
        real = ff.flash_fwd_general
        monkeypatch.setattr(ff, "flash_fwd_general",
                            lambda *a, **k: (calls.append(k), real(*a, **k))[1])
        ff.flash_attention_fwd(q, q, q, causal=causal, **kw)
        monkeypatch.setattr(ff, "flash_fwd_general", real)
        assert len(calls) == 1 and calls[0]["dropout_rate"] == 0.1
    assert ff.fwd_route(64, None, causal=True, featured=True) == "general"
    cache = tmp_path / "fused.json"
    autotune.record_bwd((1, 2, 2, 64, 64), "fused", {}, cache_path=str(cache), device="cpu",
                        dtype=torch.float32)
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", str(cache))
    autotune.reset_memo()
    try:
        assert fb.bwd_route(q, q, None, causal=True) == "fused"
        assert fb.bwd_route(q, q, None, causal=True, transformed=True) == "split"
        monkeypatch.setattr(fb, "flash_attention_bwd_fused",
                            lambda *a, **k: pytest.fail("the fused backward took dropout"))
        monkeypatch.setattr(flash_tri, "flash_attention_bwd_tri",
                            lambda *a, **k: pytest.fail("the triangular backward took dropout"))
        lse = torch.zeros((1, 2, 64))
        assert len(fb.flash_attention_bwd_auto(q, q, q, q, q, lse, causal=True, **kw)) == 3
    finally:
        autotune.reset_memo()


# The model: a depth-2 FlashLM in fp32 at the JAX tests' width.
JAX_CFG = jax_tf.ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=jnp.float32, attn_dropout=0.3,
)
CFG = ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=torch.float32, attn_dropout=0.3,
)
MODEL_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)


def _port_params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), CFG,
                           dtype=torch.float32, device="cpu")


def _seeds_of(key) -> torch.Tensor:
    """The per-layer seeds JAX's ``forward_hidden`` draws from ``key``
    (``transformer.py:252-258``)."""
    seeds = jax.random.randint(key, (JAX_CFG.n_layers,), 0, jnp.iinfo(jnp.int32).max,
                               dtype=jnp.int32)
    return torch.from_numpy(np.array(seeds))


def test_model_forward_loss_and_grads_match_jax(jax_params):
    """JAX ``forward`` / ``loss_fn`` with a dropout key against the port's
    with the seeds that key draws: logits, loss and every gradient."""
    tokens = np.random.default_rng(5).integers(0, 256, (2, 128)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    seeds = _seeds_of(key)
    params = _port_params(jax_params)
    want = jax_tf.forward(jax_params, jnp.asarray(tokens), JAX_CFG, dropout_key=key)
    got = tf.forward(params, torch.from_numpy(tokens), CFG, dropout_seeds=seeds)
    assert _rel(got, want) < MODEL_TOL
    loss_j, grads_j = jax.value_and_grad(jax_tf.loss_fn)(jax_params, jnp.asarray(tokens), JAX_CFG,
                                                         key)
    loss_t, grads_t = tf.value_and_grad(tf.loss_fn, params, torch.from_numpy(tokens), CFG, seeds)
    assert abs(float(loss_t) - float(loss_j)) < 1e-5
    flat_w = jax.tree_util.tree_leaves(grads_j)
    flat_g = tf.param_leaves(grads_t)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert _rel(g, w) < MODEL_TOL
    # Remat draws the same mask in its second forward (the hash is
    # stateless): its gradients equal those without it.
    def loss_without_remat(p, t, c, s):
        logits = tf.forward(p, t, c, remat=False, dropout_seeds=s)[:, :-1]
        return -torch.log_softmax(logits, -1).gather(-1, t[:, 1:].long()[..., None])[..., 0].mean()

    _, grads_nr = tf.value_and_grad(loss_without_remat, params, torch.from_numpy(tokens), CFG,
                                    seeds)
    for g, w in zip(tf.param_leaves(grads_nr), flat_g):
        assert float((g - w).abs().max()) <= 1e-6 * max(1.0, float(w.abs().max()))


def test_model_without_seeds_runs_deterministically(jax_params):
    """No seeds (eval, serving): the model with ``attn_dropout`` equals the
    one without it, bit for bit; seeds change the output, and other seeds
    change it again."""
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 64)).astype(np.int32))
    params = _port_params(jax_params)
    plain = tf.forward(params, tokens, dataclasses.replace(CFG, attn_dropout=0.0))
    assert torch.equal(tf.forward(params, tokens, CFG), plain)
    a = tf.forward(params, tokens, CFG, dropout_seeds=torch.tensor([1, 2], dtype=torch.int32))
    b = tf.forward(params, tokens, CFG, dropout_seeds=torch.tensor([3, 4], dtype=torch.int32))
    assert float((a - plain).abs().max()) > 1e-4 and float((a - b).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="dropout_seeds"):
        tf.forward(params, tokens, CFG, dropout_seeds=torch.zeros(3, dtype=torch.int32))


def test_trainer_with_dropout_draws_fresh_seeds_and_repeats_itself(tmp_path):
    """A few AdamW steps with dropout: finite losses; each step draws new
    per-layer seeds from the trainer's generator (one row per microbatch
    under ``grad_accum``); the same seed repeats the run bit for bit, and a
    resumed run continues it bit for bit (the generator's state is in the
    checkpoint)."""
    tokens = [torch.from_numpy(np.random.default_rng(10 + i).integers(0, 256, (4, 64))
                               .astype(np.int32)) for i in range(4)]
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)

    def run(seed=0, grad_accum=1, steps=3, path=None, load=None):
        tr = Trainer(CFG, optimizer=make_optimizer(**opt), seed=seed, grad_accum=grad_accum,
                     device="cpu")
        if load:
            tr.load(load)
        losses = [tr.step(t) for t in tokens[tr.state.step:tr.state.step + steps]]
        if path:
            tr.save(path)
        return tr, losses

    tr, losses = run()
    assert all(np.isfinite(losses)) and len(set(losses)) == len(losses)
    _, again = run()
    assert again == losses
    # The seeds come from the trainer's generator: one [grad_accum, L] draw a step.
    gen_state = tr.state.generator.get_state()
    s1, s2 = tr.dropout_seeds(2), tr.dropout_seeds(1)
    assert s1.shape == (2, 2) and s1.dtype == torch.int32 and not torch.equal(s1[0], s2[0])
    assert int(s1.min()) >= 0
    tr.state.generator.set_state(gen_state)
    assert torch.equal(tr.dropout_seeds(2), s1)
    # With grad_accum 2 the run is finite too; without dropout no seed is drawn.
    _, acc = run(grad_accum=2, steps=2)
    assert all(np.isfinite(acc))
    assert Trainer(dataclasses.replace(CFG, attn_dropout=0.0), device="cpu").dropout_seeds(1) is None
    # Resume: 2 steps, save, then 2 more from the checkpoint == 4 straight.
    ck = str(tmp_path / "ck.pt")
    _, four = run(steps=4)
    _, first = run(steps=2, path=ck)
    _, rest = run(steps=2, load=ck)
    assert first + rest == four
