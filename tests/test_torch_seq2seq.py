"""PyTorch port: FlashSeq2Seq (encoder-decoder, cross-attention over a padded
source, incremental greedy and beam decoding) against the JAX package.

Both packages get the same numpy-made weights.  The JAX side runs its
Pallas kernels in interpret mode, the port the plain versions on CPU
tensors.  The decoder is GQA (4 q-heads over 2 KV heads), so the
cross-attention has ``n_q != n_kv`` in heads as well as in length.

Tolerances (fp32): logits and the loss within 2e-5 of the largest value;
gradients within 1e-4 of the largest; greedy tokens equal; beam tokens
equal and beam scores (sums of fp32 log-probabilities) within 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.models import seq2seq as jax_s2s
from flash_attention_metal_tpu_torch.models import seq2seq as s2s
from flash_attention_metal_tpu_torch.models import transformer as tf

SHAPE = dict(vocab_size=128, d_model=128, enc_layers=2, dec_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=64, d_ff=128, max_src_len=128, max_tgt_len=128)
JAX_CFG = jax_s2s.Seq2SeqConfig(**SHAPE, dtype=jnp.float32)
CFG = s2s.Seq2SeqConfig(**SHAPE, dtype=torch.float32)
FWD_TOL, GRAD_TOL, SCORE_TOL = 2e-5, 1e-4, 1e-4
SRC = [5, 9, 2, 44, 17, 3, 81]
S_PAD = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (``tests/test_torch_paged.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jax_s2s.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return tf.map_params(lambda a: torch.from_numpy(np.array(a, np.float32)),
                         jax.tree_util.tree_map(np.asarray, jax_params))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.detach().numpy() - want)) / max(1.0, np.max(np.abs(want))))


def _batch(seed, lengths=(7, 100)):
    """A source batch padded to 128 with its mask, and 16-token targets."""
    rng = np.random.default_rng(seed)
    src = rng.integers(2, 128, (2, S_PAD)).astype(np.int32)
    mask = (np.arange(S_PAD)[None] < np.array(lengths)[:, None]).astype(np.int32)
    tgt = rng.integers(2, 128, (2, 16)).astype(np.int32)
    return src, mask, tgt


def test_forward_matches_jax(jax_params, params):
    src, mask, tgt = _batch(1)
    want = jax_s2s.forward(jax_params, jnp.asarray(src), jnp.asarray(tgt), JAX_CFG,
                           jnp.asarray(mask))
    got = s2s.forward(params, torch.from_numpy(src), torch.from_numpy(tgt), CFG,
                      torch.from_numpy(mask))
    assert got.shape == (2, 16, 128) and _rel(got, want) < FWD_TOL


def test_loss_and_grads_match_jax(jax_params, params):
    """The target-side loss under a target pad mask, and every gradient
    (encoder, self- and cross-attention, MLP)."""
    src, mask, tgt = _batch(2)
    tgt_mask = (np.arange(16)[None] < np.array([[11], [16]])).astype(np.int32)

    def jloss(p):
        return jax_s2s.loss_fn(p, jnp.asarray(src), jnp.asarray(tgt), JAX_CFG, jnp.asarray(mask),
                               jnp.asarray(tgt_mask))

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(jax_params)
    loss_t, grads_t = tf.value_and_grad(
        lambda p: s2s.loss_fn(p, torch.from_numpy(src), torch.from_numpy(tgt), CFG,
                              torch.from_numpy(mask), torch.from_numpy(tgt_mask)), params)
    assert abs(float(loss_t) - float(loss_j)) < FWD_TOL * max(1.0, abs(float(loss_j)))
    flat_j = jax.tree_util.tree_leaves(grads_j)
    flat_t = tf.param_leaves(grads_t)
    assert len(flat_t) == len(flat_j)
    for g, w in zip(flat_t, flat_j):
        assert g.shape == w.shape and _rel(g, w) < GRAD_TOL


def test_greedy_matches_jax_and_teacher_forcing(jax_params, params):
    """Greedy decode (target cache padded to 128, ``q_offset`` = the
    length) emits JAX's tokens, and the teacher-forced argmax of its own
    chain."""
    want = jax_s2s.greedy_generate(jax_params, JAX_CFG, SRC, bos_id=1, max_new_tokens=8)
    got = s2s.greedy_generate(params, CFG, SRC, bos_id=1, max_new_tokens=8)
    assert got == want and len(got) == 8
    src = torch.zeros((1, S_PAD), dtype=torch.int32)
    src[0, : len(SRC)] = torch.tensor(SRC)
    src_mask = (torch.arange(S_PAD) < len(SRC)).to(torch.int32)[None]
    logits = s2s.forward(params, src, torch.tensor([[1] + got], dtype=torch.int32), CFG, src_mask)
    assert logits[0, :8].argmax(-1).tolist() == got


def test_beam_matches_jax(jax_params, params):
    """Beam search (width 3): every beam's tokens equal JAX's and its score
    within 1e-4; width 1 is greedy."""
    want = jax_s2s.beam_generate(jax_params, JAX_CFG, SRC, beam_width=3, max_new_tokens=6,
                                 return_all=True)
    got = s2s.beam_generate(params, CFG, SRC, beam_width=3, max_new_tokens=6, return_all=True)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=SCORE_TOL, rtol=0)
    one, _ = s2s.beam_generate(params, CFG, SRC, beam_width=1, max_new_tokens=6)
    assert one == s2s.greedy_generate(params, CFG, SRC, max_new_tokens=6)


def test_source_padding_is_inert(params):
    """Pad ids past the source's length change no logit."""
    src, mask, tgt = _batch(3, lengths=(7, 7))
    other = src.copy()
    other[:, 7:] = (other[:, 7:] + 31) % 128
    a = s2s.forward(params, torch.from_numpy(src), torch.from_numpy(tgt), CFG,
                    torch.from_numpy(mask))
    b = s2s.forward(params, torch.from_numpy(other), torch.from_numpy(tgt), CFG,
                    torch.from_numpy(mask))
    assert torch.equal(a, b)


def test_init_params_layout(jax_params):
    gen = torch.Generator()
    gen.manual_seed(0)
    got = s2s.init_params(CFG, gen)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a.shape, jax_params),
                                     is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(t.shape) for t in tf.param_leaves(got)] == [tuple(s) for s in want]
