"""PyTorch port: the one-device MoE FlashLM against the JAX package.

Both packages get the same numpy-made weights (``params_from_jax`` carries
the router and the expert stacks across).  The JAX steps run on a one-device
``(dp, ep, tp, sp) = (1, 1, 1, 1)`` mesh, where every collective is the
identity; its attention runs the Pallas kernels in interpret mode, the
port's the plain versions on CPU tensors.

Tolerances: ``topk_dispatch``'s dispatch and combine exact (the same fp32
division of the same top-k probabilities; the router fixtures have no
ties, which ``jax.lax.top_k`` and ``torch.topk`` may order differently);
the routed MLPs (fp32) within 2e-5; logits and losses within 2e-5 of the
largest; gradients within 1e-4 of the largest; SGD steps within 1e-4 of
each leaf's largest value (``tests/test_torch_train.py``'s bound); AdamW
steps at lr 1e-3 (the standing finding: Adam divides each element by its
own gradient scale, so an expert element that few tokens reach, its
gradient near zero, can take its update's sign from rounding and move up
to lr a step): losses within 2e-5, at most 1 element in 1000 beyond 1e-4,
none beyond 3 steps x lr; greedy engine streams equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flash_attention_metal_tpu.models import moe as jax_moe
from flash_attention_metal_tpu.parallel import make_mesh
from flash_attention_metal_tpu.runtime import engine as jax_eng
from flash_attention_metal_tpu_torch.models import moe, params_from_jax, transformer as tf
from flash_attention_metal_tpu_torch.models.trainer import constant_adamw
from flash_attention_metal_tpu_torch.models.wquant import quantize_weights
from flash_attention_metal_tpu_torch.runtime import engine as eng_mod

SHAPE = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
             d_ff=256, max_seq_len=256, n_experts=4, top_k=2)
JAX_CFG = jax_moe.MoEConfig(**SHAPE, dtype=jnp.float32, capacity_factor=8.0)
CFG = moe.MoEConfig(**SHAPE, dtype=torch.float32, capacity_factor=8.0)
# Capacity 1.0: some tokens overflow their experts and ride the residual.
JAX_TIGHT = dataclasses.replace(JAX_CFG, capacity_factor=1.0)
TIGHT = dataclasses.replace(CFG, capacity_factor=1.0)
FWD_TOL, GRAD_TOL, STEP_TOL = 2e-5, 1e-4, 1e-4
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (as
    ``tests/test_torch_paged.py`` finds, idle intra-op threads of the test
    workers spin on the shared cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jax_moe.init_moe_params(jax.random.PRNGKey(0), JAX_CFG)


def _port(jax_params, cfg=CFG, dtype=torch.float32):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), cfg, device="cpu",
                           dtype=dtype)


def _tokens(seed, batch=2, seq=SEQ):
    return np.random.default_rng(seed).integers(0, 256, (batch, seq)).astype(np.int32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


def _probs(seed, t=64, e=4):
    logits = np.random.default_rng(seed).normal(size=(t, e)).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("capacity", [8, 16, 64])
def test_topk_dispatch_matches_jax(capacity):
    """Dispatch and combine equal JAX's bit for bit (capacity 8 drops
    choices, 64 none), the Switch statistics within fp32 summation order."""
    probs = _probs(capacity)
    assert len({tuple(r) for r in np.sort(probs, -1)[:, -3:].round(7)}) == 64  # no ties
    d_j, c_j, (f_j, p_j, t_j) = jax_moe.topk_dispatch(jnp.asarray(probs), 2, capacity)
    d_t, c_t, (f_t, p_t, t_t) = moe.topk_dispatch(torch.from_numpy(probs), 2, capacity)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6)
    assert t_t == float(t_j) == 64
    assert (d_t.sum(dim=(1, 2)) < 2).any() == (capacity < 32)


@pytest.mark.parametrize("n_tokens,factor", [(64, 1.25), (2048, 1.25), (100, 1.0), (7, 8.0)])
def test_capacity_matches_jax(n_tokens, factor):
    assert moe._capacity(n_tokens, dataclasses.replace(CFG, capacity_factor=factor)) == \
        jax_moe._capacity(n_tokens, dataclasses.replace(JAX_CFG, capacity_factor=factor))


def test_moe_mlp_dense_matches_jax(jax_params):
    """The drop-free routed MLP (serving's) of layer 0 on a random stream."""
    x = np.random.default_rng(3).normal(size=(2, SEQ, 128)).astype(np.float32)
    want = jax_moe.moe_mlp_dense(jax_params["layers"][0], jnp.asarray(x), JAX_CFG)
    got = moe.moe_mlp_dense(_port(jax_params)["layers"][0], torch.from_numpy(x), CFG)
    assert _rel(got, want) < FWD_TOL


@pytest.mark.parametrize("tight", [False, True], ids=["no_drops", "drops"])
def test_moe_mlp_capacity_matches_jax(jax_params, tight):
    """The capacity-bucketed routed MLP of training at ep = tp = 1, with and
    without dropped choices, and its Switch statistics."""
    jcfg, cfg = (JAX_TIGHT, TIGHT) if tight else (JAX_CFG, CFG)
    x = np.random.default_rng(4).normal(size=(2, SEQ, 128)).astype(np.float32)
    want, (f_j, p_j, _) = jax_moe._moe_mlp(jax_params["layers"][1], jnp.asarray(x), jcfg, 1, 1)
    got, (f_t, p_t, _) = moe._moe_mlp(_port(jax_params)["layers"][1], torch.from_numpy(x), cfg)
    assert _rel(got, want) < FWD_TOL
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5)
    dense = moe.moe_mlp_dense(_port(jax_params)["layers"][1], torch.from_numpy(x), cfg)
    # At a capacity that drops nothing the two routed MLPs are one function.
    assert (_rel(got, dense.numpy()) < FWD_TOL) != tight


def test_moe_forward_and_serving_path_match_jax(jax_params):
    """``moe_forward`` (capacity path, JAX's oracle) and FlashLM's
    ``forward`` through the ``mlp_block`` hook (drop-free path) equal JAX's
    on a one-device mesh."""
    tokens = _tokens(5)
    params = _port(jax_params)
    want = jax_moe.moe_forward(jax_params, jnp.asarray(tokens), JAX_CFG)
    got = moe.moe_forward(params, torch.from_numpy(tokens), CFG)
    assert _rel(got, want) < FWD_TOL
    served = tf.forward(params, torch.from_numpy(tokens), CFG, remat=False)
    assert _rel(served, want) < FWD_TOL


def _jax_loss_and_grads(params, tokens, cfg):
    mesh = make_mesh((1, 1, 1, 1), axis_names=jax_moe.AXES, devices=jax.devices()[:1])
    specs = jax.tree_util.tree_map(lambda _: P(), jax_moe.moe_param_specs(cfg),
                                   is_leaf=lambda x: isinstance(x, P))
    loss = jax.shard_map(
        lambda p, t: jax_moe._moe_loss(p, t, cfg, 1, 1, 1, "allgather"), mesh=mesh,
        in_specs=(specs, P()), out_specs=P(), check_vma=False)
    return jax.jit(jax.value_and_grad(loss))(params, jnp.asarray(tokens))


@pytest.mark.parametrize("tight", [False, True], ids=["no_drops", "drops"])
def test_moe_loss_and_grads_match_jax(jax_params, tight):
    """Cross entropy plus the Switch aux loss, and every gradient (router
    and expert stacks included), against JAX's one-device shard_map."""
    jcfg, cfg = (JAX_TIGHT, TIGHT) if tight else (JAX_CFG, CFG)
    tokens = _tokens(6)
    loss_j, grads_j = _jax_loss_and_grads(jax_params, tokens, jcfg)
    loss_t, grads_t = tf.value_and_grad(moe._moe_loss, _port(jax_params, cfg),
                                        torch.from_numpy(tokens), cfg)
    assert abs(float(loss_t) - float(loss_j)) < FWD_TOL * max(1.0, abs(float(loss_j)))
    flat_j = jax.tree_util.tree_leaves(grads_j)
    flat_t = tf.param_leaves(grads_t)
    assert len(flat_t) == len(flat_j) == 3 + 2 * 10
    for g, w in zip(flat_t, flat_j):
        assert g.shape == w.shape
        assert _rel(g, w) < GRAD_TOL
    # The aux loss is in the loss: without it the value drops.
    no_aux = dataclasses.replace(cfg, aux_loss_weight=0.0)
    assert float(moe._moe_loss(_port(jax_params, cfg), torch.from_numpy(tokens), no_aux)) < \
        float(loss_t) - 1e-4


def test_moe_sgd_step_applies_the_gradient(jax_params):
    """``make_moe_train_step`` (SGD, lr 1e-2; JAX's at ep = tp = sp = 1):
    the loss and ``p - lr * grad`` of the gradients held to JAX's above."""
    tokens = torch.from_numpy(_tokens(7))
    params = _port(jax_params)
    loss, grads = tf.value_and_grad(moe._moe_loss, params, tokens, CFG)
    want = tf.map_params(lambda p, g: p - 1e-2 * g, params, grads)
    new, loss_t = moe.make_moe_train_step(CFG, lr=1e-2)(params, tokens)
    assert float(loss_t) == float(loss)
    for g, w in zip(tf.param_leaves(new), tf.param_leaves(want)):
        assert torch.allclose(g, w, rtol=0, atol=1e-7)


def test_moe_adamw_steps_match_jax(jax_params):
    """``make_moe_optax_step`` with the port's AdamW against optax's
    ``clip_by_global_norm(1) + adamw(1e-3)`` on the one-device mesh: three
    steps' losses and parameters."""
    mesh = make_mesh((1, 1, 1, 1), axis_names=jax_moe.AXES, devices=jax.devices()[:1])
    opt_j = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    step_j = jax_moe.make_moe_optax_step(mesh, JAX_CFG, opt_j)
    opt_t = constant_adamw(1e-3, grad_clip=1.0)
    step_t = moe.make_moe_optax_step(CFG, opt_t)
    pj, sj = jax_params, opt_j.init(jax_params)
    pt = _port(jax_params)
    st = opt_t.init(pt)
    for seed in (9, 10, 11):
        tokens = _tokens(seed)
        pj, sj, loss_j = step_j(pj, sj, jnp.asarray(tokens))
        pt, st, loss_t = step_t(pt, st, torch.from_numpy(tokens))
        assert abs(float(loss_t) - float(loss_j)) < FWD_TOL * max(1.0, abs(float(loss_j)))
    assert st["count"] == 3
    diff = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel()
                           for g, w in zip(tf.param_leaves(pt), jax.tree_util.tree_leaves(pj))])
    assert np.mean(diff > STEP_TOL) < 1e-3 and diff.max() < 3 * 1e-3


def _serve(mod, params, cfg, prompts, max_new=6, **kw):
    eng = mod.DecodeEngine(params, cfg, max_batch=2, max_len=128, **kw)
    reqs = [mod.Request(uid=u, prompt=p, max_new_tokens=max_new) for u, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


@pytest.mark.parametrize("kw", [dict(), dict(paged=True, kv_quant="int8")],
                         ids=["dense", "paged_int8"])
def test_moe_engine_matches_jax_engine(jax_params, kw):
    """``DecodeEngine`` serves the MoE tree through the ``mlp_block`` hook:
    greedy streams equal the JAX engine's on the same weights, and the
    log-probabilities agree."""
    prompts = [[7, 3, 11, 5], [1 + (i * 7) % 200 for i in range(40)], [9, 9, 2]]
    want = _serve(jax_eng, jax_params, JAX_CFG, prompts, **kw)
    got = _serve(eng_mod, _port(jax_params), CFG, prompts, **kw)
    for g, w in zip(got, want):
        assert g.generated == w.generated and len(g.generated) == 6
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=5e-4 if kw else 1e-4, rtol=0)


def test_from_jax_carries_moe_layers(jax_params):
    """The router comes across fp32, the 3-D expert stacks (and the other
    matrices) in the store dtype; the weight-only int8 tree skips the
    stacks, as JAX's does, and still serves through the hook."""
    bf = dataclasses.replace(CFG, dtype=torch.bfloat16)
    layer = _port(jax_params, bf, dtype=None)["layers"][0]
    assert layer["w_router"].dtype == torch.float32 and layer["w_router"].shape == (128, 4)
    for name, shape in (("w_gate", (4, 128, 256)), ("w_up", (4, 128, 256)),
                        ("w_down", (4, 256, 128))):
        assert layer[name].dtype == torch.bfloat16 and layer[name].shape == shape
    params = _port(jax_params)
    q = quantize_weights(params)["layers"][0]
    assert isinstance(q["wq"], dict) and torch.equal(q["w_gate"], params["layers"][0]["w_gate"])
    assert torch.equal(q["w_router"], params["layers"][0]["w_router"])
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(1, 8, 128)).astype(np.float32))
    assert torch.equal(tf.mlp_block(params["layers"][0], x, CFG),
                       moe.moe_mlp_dense(params["layers"][0], x, CFG))


def test_init_moe_params_shapes_and_storage():
    gen = torch.Generator()
    gen.manual_seed(0)
    masters = moe.init_moe_params(CFG, gen)
    assert all(t.dtype == torch.float32 for t in tf.param_leaves(masters))
    gen.manual_seed(0)
    served = moe.init_moe_params(dataclasses.replace(CFG, dtype=torch.bfloat16), gen,
                                 master_dtype=None)
    layer = served["layers"][1]
    assert layer["w_down"].shape == (4, 256, 128) and layer["w_down"].dtype == torch.bfloat16
    assert layer["w_router"].dtype == torch.float32 and layer["mlp_norm"].dtype == torch.float32
    assert torch.equal(layer["w_router"], masters["layers"][1]["w_router"])
