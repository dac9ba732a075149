"""PyTorch port: FlashLM against the JAX package.

The JAX parameters are made from a seed, turned into numpy arrays and
loaded with ``params_from_jax``; the same tokens then go through both
``forward`` functions.  JAX runs its Pallas kernel in interpret mode, the
port the kernel's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu_torch.models import (
    ModelConfig,
    forward,
    init_params,
    params_from_jax,
)
from flash_attention_metal_tpu_torch.models import transformer as tf

# tests/test_model.py's CFG, in fp32.
JAX_CFG = jax_tf.ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=jnp.float32,
)
CFG = ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=torch.float32,
)
# fp32 logits of O(1) after two layers: the two frameworks round matmul
# sums, rsqrt, exp and cos/sin differently at ~1e-6 relative, and the JAX
# kernel's fp32 products are bf16x3 (~2^-16 relative); 1e-4 absolute is
# well above that and far below the ~1e-1 a wrong rotation or mask causes.
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu")


def test_params_from_jax_layout(params, jax_params):
    assert params["embed"].shape == (256, 128)
    assert params["lm_head"].shape == (128, 256)
    for name, w in params["layers"][1].items():
        np.testing.assert_array_equal(w.numpy(), np.asarray(jax_params["layers"][1][name]))


def test_forward_matches_jax(params, jax_params):
    tokens = np.random.default_rng(0).integers(0, 256, (2, 64)).astype(np.int32)
    want = np.asarray(jax_tf.forward(jax_params, jnp.asarray(tokens), JAX_CFG, remat=False))
    got = forward(params, torch.from_numpy(tokens), CFG)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 256)
    assert float(np.max(np.abs(got.numpy() - want))) < TOL
    # The fp32 oracle route computes the same logits.
    ref_cfg = dataclasses.replace(CFG, attn_impl="reference")
    ref = forward(params, torch.from_numpy(tokens), ref_cfg)
    assert float(np.max(np.abs(ref.numpy() - want))) < TOL


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 9, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    pos = rng.integers(0, 2000, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        tf.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jax_tf.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        tf.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jax_tf.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        atol=1e-4,
    )


def test_init_params_seeded_and_typed():
    cfg = ModelConfig(
        vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, dtype=torch.bfloat16,
    )

    def make(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return init_params(cfg, g)

    a, b = make(3), make(3)
    assert torch.equal(a["layers"][0]["wq"], b["layers"][0]["wq"])
    assert a["layers"][0]["wq"].dtype == torch.bfloat16
    assert a["layers"][0]["attn_norm"].dtype == torch.float32
    assert a["layers"][0]["wk"].shape == (128, 2 * 64)
    assert not torch.equal(make(4)["embed"], a["embed"])


def test_model_config_and_loader_reject_bad_input(jax_params):
    with pytest.raises(ValueError):
        ModelConfig(n_heads=6, n_kv_heads=4)
    with pytest.raises(ValueError):
        ModelConfig(attn_impl="xla")
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    # A weight-only int8 matrix ({"qw", "scale"}, models/wquant.py) comes
    # across as it is (tests/test_torch_wquant.py holds its logits to JAX's).
    qw = np.clip(np.round(tree["layers"][0]["wq"] * 100), -127, 127).astype(np.int8)
    tree["layers"][0]["wq"] = {"qw": qw, "scale": np.full((1, qw.shape[1]), 0.01, np.float32)}
    got = params_from_jax(tree, CFG, device="cpu")["layers"][0]["wq"]
    assert got["qw"].dtype == torch.int8 and torch.equal(got["qw"], torch.from_numpy(qw))
    assert got["scale"].dtype == torch.float32
    tree["layers"][0]["w_router"] = np.zeros((1, 1), np.float32)
    with pytest.raises(NotImplementedError, match="MoE"):
        params_from_jax(tree, CFG, device="cpu")
