"""PyTorch port: FlashEncoder (bidirectional, pads as segment 0, dropout with
explicit seeds) against the JAX package.

Both packages get the same numpy-made weights.  The JAX side runs its
Pallas kernels in interpret mode, the port the plain versions on CPU
tensors.  JAX draws its per-layer dropout seeds from a key; the test draws
them the same way and hands them to the port, whose mask is JAX's bit for
bit (``kernels/_common.py::dropout_keep``).

Tolerances (fp32): hidden states, pooled embeddings and the loss within
2e-5 of the largest value; gradients within 1e-4 of the largest.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.models import encoder as jax_enc
from flash_attention_metal_tpu_torch.models import encoder as enc
from flash_attention_metal_tpu_torch.models import transformer as tf

SHAPE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
             d_ff=256, max_seq_len=128)
JAX_CFG = jax_enc.EncoderConfig(**SHAPE, dtype=jnp.float32, attn_dropout=0.1)
CFG = enc.EncoderConfig(**SHAPE, dtype=torch.float32, attn_dropout=0.1)
FWD_TOL, GRAD_TOL = 2e-5, 1e-4
B, N = 2, 128
# Row 0 has 77 real tokens then pads; row 1 none.
LENGTHS = (77, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (``tests/test_torch_paged.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jax_enc.init_params(jax.random.PRNGKey(0), JAX_CFG)


def _port(tree):
    return tf.map_params(lambda a: torch.from_numpy(np.array(a, np.float32)),
                         jax.tree_util.tree_map(np.asarray, tree))


def _batch(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, N)).astype(np.int32)
    mask = (np.arange(N)[None] < np.array(LENGTHS)[:, None]).astype(np.int32)
    return tokens, mask


def _seeds(key):
    """JAX's per-layer seeds of ``encode(..., dropout_key=key)``."""
    return np.array(jax.random.randint(key, (SHAPE["n_layers"],), 0,
                                       jnp.iinfo(jnp.int32).max, dtype=jnp.int32))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.detach().numpy() - want)) / max(1.0, np.max(np.abs(want))))


@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
def test_encode_and_mean_pool_match_jax(jax_params, dropout):
    """Hidden states of a padded batch (and their mask-aware mean), with
    dropout 0.1 under the same per-layer seeds or without."""
    tokens, mask = _batch(1)
    key = jax.random.PRNGKey(7) if dropout else None
    want = jax_enc.encode(jax_params, jnp.asarray(tokens), jnp.asarray(mask), cfg=JAX_CFG,
                          dropout_key=key)
    seeds = torch.from_numpy(_seeds(key)) if dropout else None
    got = enc.encode(_port(jax_params), torch.from_numpy(tokens), torch.from_numpy(mask), cfg=CFG,
                     dropout_seeds=seeds)
    assert got.shape == (B, N, 128)
    assert _rel(got, want) < FWD_TOL
    pooled = enc.mean_pool(got, torch.from_numpy(mask))
    assert _rel(pooled, jax_enc.mean_pool(want, jnp.asarray(mask))) < FWD_TOL
    if dropout:  # the seeds are in force
        plain = enc.encode(_port(jax_params), torch.from_numpy(tokens), torch.from_numpy(mask),
                           cfg=CFG)
        assert float((plain - got).abs().max()) > 1e-3


def test_mlm_loss_and_grads_match_jax(jax_params):
    """The masked-LM loss over a padded batch with dropout 0.1 (the
    encoder's training contract: segment ids and dropout in one attention
    call), and every gradient."""
    tokens, mask = _batch(2)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 256, (B, N)).astype(np.int32)
    loss_mask = (rng.random((B, N)) < 0.3).astype(np.int32) * mask
    key = jax.random.PRNGKey(11)

    def jloss(p):
        return jax_enc.mlm_loss(p, jnp.asarray(tokens), jnp.asarray(labels),
                                jnp.asarray(loss_mask), jnp.asarray(mask), cfg=JAX_CFG,
                                dropout_key=key)

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(jax_params)

    def tloss(p):
        return enc.mlm_loss(p, torch.from_numpy(tokens), torch.from_numpy(labels),
                            torch.from_numpy(loss_mask), torch.from_numpy(mask), cfg=CFG,
                            dropout_seeds=torch.from_numpy(_seeds(key)))

    loss_t, grads_t = tf.value_and_grad(tloss, _port(jax_params))
    assert abs(float(loss_t) - float(loss_j)) < FWD_TOL * max(1.0, abs(float(loss_j)))
    flat_j = jax.tree_util.tree_leaves(grads_j)
    flat_t = tf.param_leaves(grads_t)
    assert len(flat_t) == len(flat_j) == 3 + 2 * 9
    for g, w in zip(flat_t, flat_j):
        assert g.shape == w.shape and _rel(g, w) < GRAD_TOL


def test_pads_are_inert(jax_params):
    """A pad token's id changes no real token's hidden state, and the
    dropout seeds must be one per layer."""
    tokens, mask = _batch(4)
    other = tokens.copy()
    other[0, LENGTHS[0]:] = (other[0, LENGTHS[0]:] + 17) % 256
    params = _port(jax_params)
    a = enc.encode(params, torch.from_numpy(tokens), torch.from_numpy(mask), cfg=CFG)
    b = enc.encode(params, torch.from_numpy(other), torch.from_numpy(mask), cfg=CFG)
    assert torch.equal(a[0, : LENGTHS[0]], b[0, : LENGTHS[0]])
    assert not torch.equal(a[0, LENGTHS[0]:], b[0, LENGTHS[0]:])
    with pytest.raises(ValueError, match="one per layer"):
        enc.encode(params, torch.from_numpy(tokens), cfg=CFG,
                   dropout_seeds=torch.zeros(3, dtype=torch.int32))


def test_init_params_layout():
    gen = torch.Generator()
    gen.manual_seed(0)
    params = enc.init_params(CFG, gen)
    want = jax.tree_util.tree_map(np.shape, jax_enc.init_params(jax.random.PRNGKey(0), JAX_CFG))
    assert [tuple(t.shape) for t in tf.param_leaves(params)] == \
        [tuple(s) for s in jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, tuple))]
    assert all(t.dtype == torch.float32 for t in tf.param_leaves(params))
