"""Weight-only int8 serving trees and single-row sampling in the PyTorch
port, against the JAX package.

``quantize_weights`` must give JAX's int8 bytes and fp32 scales exactly; a
JAX quantized tree carried across by ``params_from_jax`` must give JAX's
logits (1e-4, fp32) and serve JAX's greedy tokens; ``sample`` must take
JAX's greedy token and keep its filters' support.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu.models import wquant as jax_wq
from flash_attention_metal_tpu.runtime import decode as jax_dec
from flash_attention_metal_tpu.runtime import engine as jax_eng
from flash_attention_metal_tpu_torch.models import ModelConfig, params_from_jax
from flash_attention_metal_tpu_torch.models import transformer as tf
from flash_attention_metal_tpu_torch.models import wquant
from flash_attention_metal_tpu_torch.runtime import decode as dec
from flash_attention_metal_tpu_torch.runtime import engine as eng_mod

JAX_CFG = jax_tf.ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2,
                             head_dim=64, d_ff=128, max_seq_len=256, dtype=jnp.float32)
CFG = ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2, head_dim=64,
                  d_ff=128, max_seq_len=256, dtype=torch.float32)
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


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_quantize_weights_bytes_equal_jax(jax_params):
    """Every targeted matrix and lm_head: int8 bytes and fp32 scales equal
    JAX's; norms and the embedding untouched; the tree under 0.45x the fp32
    tree's bytes (JAX ``tests/test_wquant.py:60``)."""
    master = params_from_jax(_host(jax_params), CFG, device="cpu", dtype=torch.float32)
    got = wquant.quantize_weights(master)
    want = _host(jax_wq.quantize_weights(jax_params))
    for layer_t, layer_j in zip(got["layers"], want["layers"]):
        for name in wquant.WEIGHT_QUANT_TARGETS:
            np.testing.assert_array_equal(layer_t[name]["qw"].numpy(), layer_j[name]["qw"])
            np.testing.assert_array_equal(layer_t[name]["scale"].numpy(), layer_j[name]["scale"])
            assert layer_t[name]["qw"].dtype == torch.int8
        assert layer_t["attn_norm"] is not None and torch.is_tensor(layer_t["attn_norm"])
    np.testing.assert_array_equal(got["lm_head"]["qw"].numpy(), want["lm_head"]["qw"])
    assert wquant.weight_bytes(got) == jax_wq.weight_bytes(jax_wq.quantize_weights(jax_params))
    assert wquant.weight_bytes(got) < 0.45 * wquant.weight_bytes(master)
    deq = got["layers"][0]["wq"]["qw"].float() * got["layers"][0]["wq"]["scale"]
    err = (deq - master["layers"][0]["wq"]).abs().amax(dim=0)
    assert torch.all(err <= got["layers"][0]["wq"]["scale"][0] * 0.5 + 1e-9)


def test_from_jax_quantized_tree_logits_and_serving(jax_params):
    """A JAX quantized tree through ``params_from_jax``: forward logits
    equal JAX's, and the engine serves JAX's greedy tokens."""
    jq = jax_wq.quantize_weights(jax_params)
    params = params_from_jax(_host(jq), CFG, device="cpu")
    assert params["layers"][0]["wk"]["qw"].dtype == torch.int8
    toks = np.random.default_rng(0).integers(0, 256, (2, 64)).astype(np.int32)
    got = tf.forward(params, torch.from_numpy(toks), CFG)
    want = np.asarray(jax_tf.forward(jq, jnp.asarray(toks), JAX_CFG))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)

    def run(mod, p, cfg):
        eng = mod.DecodeEngine(p, cfg, max_batch=2, max_len=256)
        reqs = [mod.Request(uid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=8),
                mod.Request(uid=1, prompt=[2, 7, 1, 8], max_new_tokens=8)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return reqs

    for g, w in zip(run(eng_mod, params, CFG), run(jax_eng, jq, JAX_CFG)):
        assert g.generated == w.generated
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=TOL, rtol=0)


def test_quantize_weight_refuses_non_matrices():
    with pytest.raises(ValueError, match="2-D"):
        wquant.quantize_weight(torch.zeros(3))


def test_sample_matches_jax():
    """``sample``: greedy (temperature 0, or no generator) is JAX's argmax;
    a draw under top-k / top-p / min-p stays inside the filtered support
    JAX's filter keeps."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal(256).astype(np.float32) * 3
    assert int(dec.sample(torch.from_numpy(logits))) == int(jax_dec.sample(jnp.asarray(logits)))
    gen = torch.Generator()
    gen.manual_seed(0)
    for kw in (dict(top_k=5), dict(top_p=0.5), dict(min_p=0.2), dict(top_k=8, top_p=0.9)):
        keep = np.isfinite(np.asarray(jax_dec.filter_scaled_logits(
            jnp.asarray(logits / 0.7)[None], jnp.asarray([kw.get("top_k", 0)], jnp.int32),
            jnp.asarray([kw.get("top_p", 1.0)], jnp.float32),
            jnp.asarray([kw.get("min_p", 0.0)], jnp.float32))[0]))
        draws = {int(dec.sample(torch.from_numpy(logits), gen, 0.7, **kw)) for _ in range(64)}
        assert all(keep[t] for t in draws)
    # Unfiltered at a high temperature the draws spread.
    assert len({int(dec.sample(torch.from_numpy(logits), gen, 5.0)) for _ in range(64)}) > 8
