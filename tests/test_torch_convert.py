"""PyTorch port: the Hugging Face Llama conversion, checked independently
against ``transformers.LlamaForCausalLM`` (random weights from a config, no
download) and against the JAX package's converter.

The port's converter imports no ``transformers``: it reads ``.config`` and
``.state_dict()``, so a plain object with Hugging Face names converts too
(the card's check builds one from a seed).

Tolerances (fp32): logits within 2e-4 of Hugging Face's (JAX's
``tests/test_convert.py`` bound: the two models sum the rotary and the
attention in other orders); converted weights equal JAX's converter's;
greedy streams equal Hugging Face's greedy decoding.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flash_attention_metal_tpu.models import convert as jax_convert  # noqa: E402
from flash_attention_metal_tpu_torch.models import convert  # noqa: E402
from flash_attention_metal_tpu_torch.models import transformer as tf  # noqa: E402
from flash_attention_metal_tpu_torch.runtime import engine as eng_mod  # noqa: E402

LOGIT_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (``tests/test_torch_paged.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hf_model(tied=False, heads=8, kv_heads=1, hidden=512):
    """A random Llama: GQA group 8 at head dim 64 by default (the grouping
    of TinyLlama-1.1B's published widths, 32 / 4 heads)."""
    cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=hidden, intermediate_size=384, num_hidden_layers=2,
        num_attention_heads=heads, num_key_value_heads=kv_heads, max_position_embeddings=512,
        rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False, mlp_bias=False,
        tie_word_embeddings=tied,
    )
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg)
    model.eval()
    return model


@pytest.fixture(scope="module")
def hf_model():
    return _hf_model()


def _tokens(seed, n=64):
    return np.random.default_rng(seed).integers(0, 512, size=(2, n))


def test_converted_logits_match_hf(hf_model):
    cfg, params = convert.convert_hf_llama(hf_model, device="cpu", dtype=torch.float32)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == (8, 1, 64, 384)
    tokens = _tokens(1)
    with torch.no_grad():
        want = hf_model(torch.from_numpy(tokens)).logits
        got = tf.forward(params, torch.from_numpy(tokens).int(), cfg, remat=False)
    assert float((got - want).abs().max()) < LOGIT_TOL * max(1.0, float(want.abs().max()))


def test_converted_weights_equal_jax(hf_model):
    """The port's tree equals the JAX converter's leaf for leaf (the rotary
    permutation, the transposes, the head)."""
    cfg, params = convert.convert_hf_llama(hf_model, device="cpu", dtype=torch.float32)
    jcfg, jparams = jax_convert.convert_hf_llama(hf_model, dtype=jnp.float32)
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.rope_theta) == \
        (jcfg.vocab_size, jcfg.d_model, jcfg.n_layers, jcfg.rope_theta)
    for got, want in zip(tf.param_leaves(params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert convert.config_from_hf_llama(hf_model.config).dtype == torch.bfloat16


def test_tied_embeddings_and_a_plain_state_dict():
    """A tied model (no ``lm_head.weight``) converts with the embedding's
    transpose as the head; a plain object with ``.config`` and
    ``.state_dict()`` (no ``transformers`` class) converts the same."""
    model = _hf_model(tied=True, heads=4, kv_heads=2, hidden=256)
    sd = model.state_dict()
    plain = SimpleNamespace(config=model.config,
                            state_dict=lambda: {k: v for k, v in sd.items() if k != "lm_head.weight"})
    cfg, params = convert.convert_hf_llama(plain, device="cpu", dtype=torch.float32)
    assert torch.equal(params["lm_head"], params["embed"].t())
    tokens = _tokens(2, 32)
    with torch.no_grad():
        want = model(torch.from_numpy(tokens)).logits
        got = tf.forward(params, torch.from_numpy(tokens).int(), cfg, remat=False)
    assert float((got - want).abs().max()) < LOGIT_TOL * max(1.0, float(want.abs().max()))
    bf = convert.params_from_hf_llama(plain, cfg, device="cpu", master_dtype=torch.bfloat16)
    assert bf["layers"][0]["wq"].dtype == torch.bfloat16
    assert bf["layers"][0]["attn_norm"].dtype == torch.float32


def test_interleave_matches_jax():
    w = np.random.default_rng(3).normal(size=(16, 2 * 8)).astype(np.float32)
    got = convert._interleave_rope_channels(torch.from_numpy(w), 2, 8)
    np.testing.assert_array_equal(got.numpy(), jax_convert._interleave_rope_channels(w, 2, 8))


def test_converted_model_serves_hf_greedy(hf_model):
    """The converted checkpoint decodes greedily through ``DecodeEngine``
    as Hugging Face's ``generate`` does."""
    cfg, params = convert.convert_hf_llama(hf_model, device="cpu", dtype=torch.float32)
    prompt = [5, 77, 300, 12, 9]
    with torch.no_grad():
        want = hf_model.generate(torch.tensor([prompt]), max_new_tokens=6, do_sample=False,
                                 pad_token_id=0)[0, len(prompt):].tolist()
    eng = eng_mod.DecodeEngine(params, cfg, max_batch=1, max_len=128)
    req = eng_mod.Request(uid=0, prompt=prompt, max_new_tokens=6)
    eng.submit(req)
    eng.run()
    assert req.generated == want
