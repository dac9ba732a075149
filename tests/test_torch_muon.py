"""PyTorch port: the Muon optimizer against the JAX package (optax).

The same numpy-made matrices, gradients and FlashLM weights go to both.

Tolerances: Newton-Schulz iterates in bf16 in both packages (fp32 in and
out); on the same input its output is held within 1e-2 of its largest
entry (on the CPU it reads equal: the same bf16 coefficients, products and
roundings).  The momentum buffers (fp32 arithmetic) within 1e-6.  Inside an
update, the Frobenius norm that scales the iteration's input is summed in
another order by each framework: an ulp there moves some bf16 roundings of
the input, which five iterations amplify (2.5e-2 relative L2 measured on
one of the fixtures' matrices, the others equal), so Muon updates are held
within 5e-2 relative L2 (a wrong coefficient, momentum or scale moves them
by 0.3 or more) and a step's Muon leaves within 5e-2 x muon_lr x the
update's largest entry; AdamW leaves within 1e-6 of each leaf's largest
value.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.models import moe as jax_moe
from flash_attention_metal_tpu.models import muon as jax_muon
from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu_torch.models import ModelConfig, Trainer, muon, params_from_jax
from flash_attention_metal_tpu_torch.models import moe
from flash_attention_metal_tpu_torch.models import transformer as tf

SHAPE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
             d_ff=256, max_seq_len=256)
JAX_CFG = jax_tf.ModelConfig(**SHAPE, dtype=jnp.float32)
CFG = ModelConfig(**SHAPE, dtype=torch.float32)
NS_TOL, MOMENTUM_TOL, UPDATE_REL_L2, ADAM_TOL = 1e-2, 1e-6, 5e-2, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (``tests/test_torch_paged.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mat(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 64), (128, 48), (32, 160)], ids=["square", "tall", "wide"])
def test_newton_schulz_matches_jax(shape):
    g = _mat(sum(shape), shape)
    want = np.asarray(jax_muon.newton_schulz_orthogonalize(jnp.asarray(g)))
    got = muon.newton_schulz_orthogonalize(torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == shape
    assert np.max(np.abs(got.numpy() - want)) < NS_TOL * np.max(np.abs(want))
    # Orthogonal enough: the singular values land near 1 (a Gaussian square
    # matrix's smallest one, far below the rest, is still rising).
    sv = np.linalg.svd(got.numpy(), compute_uv=False)
    assert 0.6 < np.median(sv) and sv.max() < 1.3
    with pytest.raises(ValueError, match="2-D"):
        muon.newton_schulz_orthogonalize(torch.zeros(2, 3, 4))


def test_scale_by_muon_matches_jax():
    """Two updates (Nesterov momentum 0.95): the momentum buffers and the
    scaled orthogonal updates of a tall and a wide matrix."""
    params = [_mat(1, (96, 32)), _mat(2, (32, 64))]
    tx_j = jax_muon.scale_by_muon(0.95)
    tx_t = muon.scale_by_muon(0.95)
    sj = tx_j.init([jnp.asarray(p) for p in params])
    st = tx_t.init([torch.from_numpy(p) for p in params])
    for step in range(2):
        grads = [_mat(10 + 2 * step + i, p.shape) for i, p in enumerate(params)]
        uj, sj = tx_j.update([jnp.asarray(g) for g in grads], sj)
        ut, st = tx_t.update([torch.from_numpy(g) for g in grads], st)
        for a, b in zip(st.momentum, sj.momentum):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=MOMENTUM_TOL, rtol=0)
        for a, b in zip(ut, uj):
            b = np.asarray(b)
            assert np.linalg.norm(a.numpy() - b) < UPDATE_REL_L2 * np.linalg.norm(b)
    # The tall matrix's update is scaled by sqrt(96 / 32).
    assert abs(float(ut[0].norm()) / float(muon.newton_schulz_orthogonalize(
        torch.from_numpy(np.asarray(st.momentum[0]))).norm()) - 3 ** 0.5) < 0.5


def test_label_trees_match_jax():
    jp = jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), CFG, device="cpu")
    assert muon.muon_label_tree(tp) == jax_muon.muon_label_tree(jp)
    mcfg = jax_moe.MoEConfig(**SHAPE, dtype=jnp.float32, n_experts=4)
    mp = jax_moe.init_moe_params(jax.random.PRNGKey(1), mcfg)
    port_mp = params_from_jax(jax.tree_util.tree_map(np.asarray, mp),
                              moe.MoEConfig(**SHAPE, dtype=torch.float32, n_experts=4),
                              device="cpu")
    labels = muon.muon_label_tree(port_mp)
    assert labels == jax_muon.muon_label_tree(mp)
    assert labels["layers"][0]["w_gate"] == "adamw" and labels["layers"][0]["w_router"] == "muon"


def test_muon_optimizer_step_matches_optax():
    """Two steps of ``make_muon_optimizer`` (clip 1.0, Muon lr 0.02, AdamW
    3e-4) on a FlashLM tree with the same gradients: the AdamW leaves in
    fp32, the Muon leaves within the bf16 iteration's error."""
    jp = jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), CFG, device="cpu",
                         dtype=torch.float32)
    opt_j = jax_muon.make_muon_optimizer(jp)
    opt_t = muon.make_muon_optimizer(tp)
    sj, st = opt_j.init(jp), opt_t.init(tp)
    labels = tf.param_leaves(muon.muon_label_tree(tp))
    for step in range(2):
        rng = np.random.default_rng(20 + step)
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.01, jp)
        updates, sj = opt_j.update(jax.tree_util.tree_map(jnp.asarray, grads), sj, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        opt_t.update(tf.map_params(torch.from_numpy, grads), st, tp)
    for g, w, lab in zip(tf.param_leaves(tp), jax.tree_util.tree_leaves(jp), labels):
        w = np.asarray(w)
        err = np.max(np.abs(g.numpy() - w))
        if lab == "muon":  # two steps of 0.02 times updates of entries up to ~0.3
            assert err < UPDATE_REL_L2 * 0.02 * 2 * 0.3, err
        else:
            assert err < ADAM_TOL * max(1.0, np.max(np.abs(w))), err
    assert st["adamw"]["count"] == 2


def test_trainer_takes_muon_and_resumes(tmp_path):
    """``Trainer(optimizer=make_muon_optimizer(...))``: the loss falls over
    a few steps on a repeated batch, and a checkpoint (the Muon state as
    plain containers) resumes bit for bit."""
    gen = torch.Generator()
    gen.manual_seed(0)
    small = dataclasses.replace(CFG, n_layers=1)
    opt = muon.make_muon_optimizer(tf.init_params(small, gen, master_dtype=torch.float32))
    trainer = Trainer(small, optimizer=opt, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 64)))
    losses = [trainer.step(tokens) for _ in range(4)]
    assert losses[-1] < losses[0]
    path = str(tmp_path / "muon.pt")
    trainer.save(path)
    after = trainer.step(tokens)
    again = Trainer(small, optimizer=opt, seed=3, device="cpu")
    again.load(path)
    assert again.step(tokens) == after
