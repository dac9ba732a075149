"""PyTorch port: LoRA adapters on FlashLM against the JAX package.

Both packages get the same numpy-made base weights and adapters.  The JAX
side runs its Pallas kernels in interpret mode, the port the plain versions
on CPU tensors.

Tolerances (fp32): merged weights within 1e-6; the loss within 2e-5 of its
value; the adapters' gradients within 1e-4 of the largest; AdamW steps at
lr 1e-3 (JAX's default ``optax.adamw(1e-3)``; the standing finding, as
``tests/test_torch_moe.py`` states it): losses within 2e-5, at most 1
element in 1000 beyond 1e-4, none beyond 3 steps x lr.  The base weights
stay bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.models import lora as jax_lora
from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu_torch.models import ModelConfig, lora, params_from_jax
from flash_attention_metal_tpu_torch.models import transformer as tf

SHAPE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
             d_ff=256, max_seq_len=256)
JAX_CFG = jax_tf.ModelConfig(**SHAPE, dtype=jnp.float32)
CFG = ModelConfig(**SHAPE, dtype=torch.float32)
LCFG = lora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "wo", "w_up"))
JAX_LCFG = jax_lora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "wo", "w_up"))
FWD_TOL, GRAD_TOL, STEP_TOL, LR = 2e-5, 1e-4, 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (``tests/test_torch_paged.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_base():
    return jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_base(jax_base):
    return params_from_jax(_np(jax_base), CFG, device="cpu", dtype=torch.float32)


def _adapters(jax_base, seed=1):
    """JAX's adapters with ``b`` made nonzero (a trained state), and the
    port's copy."""
    ad = jax_lora.init_lora(jax.random.PRNGKey(seed), jax_base, JAX_LCFG)
    rng = np.random.default_rng(seed)
    ad = jax.tree_util.tree_map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32) * 0.05) if not np.any(a) else a, ad)
    return ad, tf.map_params(lambda a: torch.from_numpy(np.array(a, np.float32)), _np(ad))


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 256, (2, 64)).astype(np.int32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.detach().numpy() - want)) / max(1.0, np.max(np.abs(want))))


def test_init_lora_starts_at_the_base(jax_base):
    gen = torch.Generator()
    gen.manual_seed(0)
    base = _port_base(jax_base)
    ad = lora.init_lora(base, LCFG, gen)
    want = jax_lora.init_lora(jax.random.PRNGKey(0), jax_base, JAX_LCFG)
    assert lora.lora_num_params(ad) == jax_lora.lora_num_params(want) == 2 * (
        128 * 4 + 4 * 256 + 128 * 4 + 4 * 128 + 256 * 4 + 4 * 128 + 128 * 4 + 4 * 256)
    assert [sorted(layer) for layer in ad["layers"]] == [sorted(layer) for layer in want["layers"]]
    merged = lora.merge_lora(base, ad, LCFG)
    for a, b in zip(tf.param_leaves(merged), tf.param_leaves(base)):
        assert torch.equal(a, b)


def test_merge_lora_matches_jax(jax_base):
    jad, tad = _adapters(jax_base)
    want = jax_lora.merge_lora(jax_base, jad, JAX_LCFG)
    got = lora.merge_lora(_port_base(jax_base), tad, LCFG)
    for g, w in zip(tf.param_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    assert float((got["layers"][0]["wq"] - _port_base(jax_base)["layers"][0]["wq"]).abs().max()) > 1e-3


def test_lora_loss_and_grads_match_jax(jax_base):
    """The loss as a function of the adapters, and their gradients (the
    base gets none)."""
    jad, tad = _adapters(jax_base)
    tokens = _tokens(2)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_lora.lora_loss_fn), static_argnums=(3, 4))(
        jad, jax_base, jnp.asarray(tokens), JAX_CFG, JAX_LCFG)
    loss_t, grads_t = tf.value_and_grad(lora.lora_loss_fn, tad, _port_base(jax_base),
                                        torch.from_numpy(tokens), CFG, LCFG)
    assert abs(float(loss_t) - float(loss_j)) < FWD_TOL * max(1.0, abs(float(loss_j)))
    for g, w in zip(tf.param_leaves(grads_t), jax.tree_util.tree_leaves(grads_j)):
        assert g.shape == w.shape and _rel(g, w) < GRAD_TOL


def test_lora_train_steps_match_jax_and_freeze_the_base(jax_base):
    """Three adapter-only AdamW steps (JAX: ``optax.adamw(1e-3)``, the
    port's default): losses and adapters against JAX's; the base tree is
    unchanged bit for bit."""
    step_j, init_j = jax_lora.make_lora_train_step(JAX_CFG, JAX_LCFG)
    step_t, init_t = lora.make_lora_train_step(CFG, LCFG)
    jad, tad = _adapters(jax_base)
    base = _port_base(jax_base)
    before = [t.clone() for t in tf.param_leaves(base)]
    sj, st = init_j(jad), init_t(tad)
    for seed in (3, 4, 5):
        tokens = _tokens(seed)
        jad, sj, loss_j = step_j(jad, sj, jax_base, jnp.asarray(tokens))
        tad, st, loss_t = step_t(tad, st, base, torch.from_numpy(tokens))
        assert abs(float(loss_t) - float(loss_j)) < FWD_TOL * max(1.0, abs(float(loss_j)))
    diff = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel()
                           for g, w in zip(tf.param_leaves(tad), jax.tree_util.tree_leaves(jad))])
    assert np.mean(diff > STEP_TOL) < 1e-3 and diff.max() < 3 * LR
    for a, b in zip(tf.param_leaves(base), before):
        assert torch.equal(a, b)
    assert st["count"] == 3
