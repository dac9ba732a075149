"""Beam search in the PyTorch port, against the JAX package.

JAX ``tests/test_beam.py``'s anchors on the same numpy-made weights
(``params_from_jax``): width 1 equals the engine's greedy decode; every
returned score is its sequence's teacher-forced log-probability (1e-4,
fp32); the beams equal JAX's, tokens and scores; wider beams never score
worse; EOS freezes a beam.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu.runtime import beam as jax_beam
from flash_attention_metal_tpu_torch.models import ModelConfig, params_from_jax
from flash_attention_metal_tpu_torch.models.transformer import forward
from flash_attention_metal_tpu_torch.runtime import beam
from flash_attention_metal_tpu_torch.runtime import engine as eng_mod
from flash_attention_metal_tpu_torch.runtime import kv_cache as kv

JAX_CFG = jax_tf.ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2,
                             head_dim=64, d_ff=128, max_seq_len=256, dtype=jnp.float32)
CFG = ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2, head_dim=64,
                  d_ff=128, max_seq_len=256, dtype=torch.float32)
PROMPT = [7, 3, 11, 2]
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the test workers share
    the host's cores, and idle intra-op threads spin on them (as
    ``tests/test_torch_paged.py`` finds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu")


def _teacher_forced_logp(params, prompt, cont):
    logits = forward(params, torch.tensor([prompt + cont]), CFG)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return sum(float(logp[0, len(prompt) - 1 + t, tok]) for t, tok in enumerate(cont))


def test_beam1_equals_greedy_engine(params):
    seq, _ = beam.beam_search_generate(params, CFG, PROMPT, beam_width=1, max_new_tokens=10,
                                       max_len=256)
    eng = eng_mod.DecodeEngine(params, CFG, max_batch=1, max_len=256)
    eng.submit(eng_mod.Request(uid=0, prompt=PROMPT, max_new_tokens=10))
    assert seq == eng.run()[0]


def test_scores_match_teacher_forced_and_jax(params, jax_params):
    beams = beam.beam_search_generate(params, CFG, PROMPT, beam_width=4, max_new_tokens=6,
                                      max_len=256, return_all=True)
    want = jax_beam.beam_search_generate(jax_params, JAX_CFG, PROMPT, beam_width=4,
                                         max_new_tokens=6, max_len=256, return_all=True)
    for (seq, score), (w_seq, w_score) in zip(beams, want):
        assert len(seq) == 6 and seq == w_seq
        assert abs(score - _teacher_forced_logp(params, PROMPT, seq)) < TOL
        assert abs(score - w_score) < TOL
    assert len({tuple(s) for s, _ in beams}) == 4
    scores = [sc for _, sc in beams]
    assert scores == sorted(scores, reverse=True)


def test_wider_beam_not_worse(params):
    scores = {w: beam.beam_search_generate(params, CFG, PROMPT, beam_width=w, max_new_tokens=6,
                                           max_len=256)[1] for w in (1, 2, 4)}
    assert scores[2] >= scores[1] - 1e-5 and scores[4] >= scores[2] - 1e-5


def test_eos_freezes_beam(params, jax_params):
    seq, _ = beam.beam_search_generate(params, CFG, PROMPT, beam_width=1, max_new_tokens=4,
                                       max_len=256)
    eos = seq[0]
    assert beam.beam_search_generate(params, CFG, PROMPT, beam_width=1, max_new_tokens=4,
                                     max_len=256, eos_id=eos)[0] == []
    got = beam.beam_search_generate(params, CFG, PROMPT, beam_width=2, max_new_tokens=4,
                                    max_len=256, eos_id=eos, return_all=True)
    want = jax_beam.beam_search_generate(jax_params, JAX_CFG, PROMPT, beam_width=2,
                                         max_new_tokens=4, max_len=256, eos_id=eos,
                                         return_all=True)
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], atol=TOL, rtol=0)


def test_reorder_and_broadcast_match_jax():
    """The slot-axis gather and the beam-0 broadcast on a dense cache."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 4, 2, 128, 8)).astype(np.float32)
    lengths = np.asarray([3, 5, 7, 9], np.int32)
    parents = np.asarray([2, 2, 0, 3])
    tc = kv.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(-k), torch.from_numpy(lengths))
    jc = jax_beam.reorder_beam_state(
        {"k": jnp.asarray(k), "v": jnp.asarray(-k), "lengths": jnp.asarray(lengths)},
        jnp.asarray(parents))
    beam.reorder_beam_state(tc, torch.from_numpy(parents))
    for name in ("k", "v", "lengths"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(jc[name]))
    beam.broadcast_slot0(tc)
    jb = jax_beam.broadcast_slot0(jc)
    for name in ("k", "v", "lengths"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(jb[name]))
