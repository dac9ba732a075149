"""PyTorch port: MoE expert and tensor parallelism (``models/moe.py`` on a
``(dp, ep, tp, sp)`` mesh) on gloo groups of CPU ranks, against the JAX
package's sharded MoE loss and the port's own single-device step.

One group of 8 ranks (``parallel.spawn``, its store under ``tmp_path``;
the rank side is ``tests/torch_dist_cases.py::ep_cases``), each mesh over
its first ranks: (1, 2, 1, 1) on 2, (2, 2, 1, 1) on 4, (2, 2, 2, 1) on 8.
The model is ``tests/test_moe.py``'s (d 128, 2 layers, 4/2 heads, 4
experts, top-2, fp32), its weights JAX's
``init_moe_params`` brought across, on ``[8, 128]`` tokens.  At capacity
8.0 no token drops; at 1.25 each shard drops the tokens past its own
capacity, as JAX's shards do.  JAX's all-gather attention runs through
its XLA reference (``attn_impl="xla"``, as
``tests/test_torch_parallel_train.py``).  Tolerances: losses 2e-5; updates 1e-4 of the largest
update (AdamW under a binding clip of 1e-6, where the first update reads
the global norm and no element sits where Adam magnifies rounding).

JAX's ep step moves the parameters by the mesh size times its
single-device update: a fault of the reference (ROADMAP.md, Queue C 17)
that the port does not copy.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from flash_attention_metal_tpu.models import moe as jax_moe
from flash_attention_metal_tpu_torch.models import moe
from flash_attention_metal_tpu_torch.models import transformer as tf
from flash_attention_metal_tpu_torch.models.from_jax import params_from_jax
from flash_attention_metal_tpu_torch.models.trainer import constant_adamw
from flash_attention_metal_tpu_torch.parallel import spawn
from flash_attention_metal_tpu_torch.parallel.mesh import Mesh

import torch_dist_cases

SHAPE = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
             d_ff=256, max_seq_len=512, n_experts=4, top_k=2)
FULL, TIGHT = 8.0, 1.25
JAX_CFG = jax_moe.MoEConfig(**SHAPE, dtype=jnp.float32, capacity_factor=FULL, attn_impl="xla")
CFG = moe.MoEConfig(**SHAPE, dtype=torch.float32, capacity_factor=FULL)
BATCH, SEQ = 8, 128
LR, CLIP = 1e-2, 1e-6
LOSS_TOL, UPDATE_TOL = 2e-5, 1e-4
MESHES = [(1, 2, 1, 1), (2, 2, 1, 1), (2, 2, 2, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jax_moe.init_moe_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu",
                           dtype=torch.float32)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, SHAPE["vocab_size"], (BATCH, SEQ), np.int32)


@pytest.fixture(scope="module")
def ranks(params, tokens, tmp_path_factory):
    """``{mesh: [rank results]}``: the losses at both capacities on every
    mesh, and on (2, 2, 2, 1) one SGD and one AdamW step."""
    cfg = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}
    runs = [dict(mesh=mesh, capacities=(FULL, TIGHT), steps=mesh == (2, 2, 2, 1))
            for mesh in MESHES]
    spec = dict(cfg=cfg, params=params, tokens=torch.from_numpy(tokens).long(), runs=runs,
                lr=LR, adam_lr=LR, clip=CLIP)
    got = spawn(torch_dist_cases.ep_cases, 8, (spec,), backend="gloo", device="cpu",
                timeout_s=240, workdir=str(tmp_path_factory.mktemp("ep")))
    out = {mesh: [r[i] for r in got if r[i] is not None] for i, mesh in enumerate(MESHES)}
    assert all(len(out[mesh]) == int(np.prod(mesh)) for mesh in MESHES)
    return out


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), jax_moe.AXES)


@pytest.fixture(scope="module")
def jax_losses(jax_params, tokens):
    """JAX's sharded MoE loss on each mesh at each capacity."""
    out = {}
    for mesh in MESHES:
        _, ep, tp, sp = mesh
        for factor in (FULL, TIGHT):
            cfg = dataclasses.replace(JAX_CFG, capacity_factor=factor)
            fn = jax.jit(jax.shard_map(
                lambda p, t, cfg=cfg: jax_moe._moe_loss(p, t, cfg, ep, tp, sp, "allgather"),
                mesh=_jax_mesh(mesh), in_specs=(jax_moe.moe_param_specs(cfg),
                                                P(("dp", "ep"), "sp")),
                out_specs=P(), check_vma=False))
            out[(mesh, factor)] = float(fn(jax_params, jnp.asarray(tokens)))
    return out


def _port_single_step(params, tokens, optimizer=None):
    t = torch.from_numpy(tokens).long()
    loss, grads = tf.value_and_grad(moe._moe_loss, params, t, CFG)
    if optimizer is None:
        return float(loss), tf.map_params(lambda g: -LR * g, grads)
    p = tf.map_params(torch.clone, params)
    optimizer.update(grads, optimizer.init(p), p)
    return float(loss), tf.map_params(torch.sub, p, params)


@pytest.fixture(scope="module")
def single_sgd(params, tokens):
    return _port_single_step(params, tokens)


def _update_err(got, want):
    got, want = tf.param_leaves(got), tf.param_leaves(want)
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale


def _tree_norm(leaves):
    return float(np.sqrt(sum(float(np.sum(np.square(np.asarray(x, np.float64)))) for x in leaves)))


def test_moe_param_specs_equal_jax():
    want = jax_moe.moe_param_specs(JAX_CFG)
    got = moe.moe_param_specs(CFG)
    assert got["layers"][0] == {k: tuple(v) for k, v in want["layers"][0].items()}
    for k in ("embed", "final_norm", "lm_head"):
        assert got[k] == tuple(want[k])


@pytest.mark.parametrize("factor", [FULL, TIGHT], ids=["no_drops", "drops"])
@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_ep_loss_matches_jax(ranks, jax_losses, mesh, factor):
    """The port's ep loss on every rank against JAX's on the same mesh: at
    capacity 8.0, and at 1.25, where each shard drops the tokens JAX's
    drops (the capacity from the shard's own token count)."""
    for r in ranks[mesh]:
        assert abs(r[f"loss_{factor}"] - jax_losses[(mesh, factor)]) < LOSS_TOL


def test_tight_capacity_drops_tokens(jax_losses):
    """At 1.25 the shards drop tokens: the loss differs from the drop-free
    one on every mesh."""
    for mesh in MESHES:
        assert abs(jax_losses[(mesh, TIGHT)] - jax_losses[(mesh, FULL)]) > 1e-4


def test_ep_sgd_update_equals_the_single_device_update(ranks, single_sgd):
    loss, want = single_sgd
    got = ranks[(2, 2, 2, 1)]
    assert all(abs(r["sgd_loss"] - loss) < LOSS_TOL for r in got)
    assert _update_err(got[0]["sgd"], want) < UPDATE_TOL


def test_ep_adamw_with_a_binding_clip_equals_single_device(ranks, params, tokens):
    """The optax-style step (``make_moe_optax_step`` with the port's AdamW)
    under a binding clip: the global norm counts each expert element once."""
    _, want = _port_single_step(params, tokens, constant_adamw(LR, grad_clip=CLIP))
    got = ranks[(2, 2, 2, 1)][0]
    assert _update_err(got["adamw"], want) < UPDATE_TOL


def _fake_mesh(shape):
    return Mesh(moe.AXES, tuple(shape), 0, "gloo", torch.device("cpu"), {})


@pytest.mark.parametrize("make", ["sgd", "adamw"])
def test_ep_rejects_bad_expert_split(make):
    mesh = _fake_mesh((1, 8, 1, 1))  # 4 experts over 8 ep ranks
    with pytest.raises(ValueError, match="divisible"):
        if make == "sgd":
            moe.make_moe_train_step(mesh, CFG)
        else:
            moe.make_moe_optax_step(mesh, CFG, constant_adamw(LR))


def test_jax_ep_step_moves_params_by_the_mesh_size_times_the_single_update_the_port_by_1(
        ranks, single_sgd, jax_params, tokens):
    """The reference's fault, pinned: JAX's ep SGD update on (2, 2, 2, 1)
    is 8 times the single-device update (the port's, which equals JAX's
    single-device step: ``tests/test_torch_moe.py``); the port's ep update
    is 1 times it."""
    step = jax_moe.make_moe_train_step(_jax_mesh((2, 2, 2, 1)), JAX_CFG, lr=LR)
    new, _ = step(jax_params, jnp.asarray(tokens))
    jax_ep = _tree_norm([np.asarray(a) - np.asarray(b) for a, b in zip(
        jax.tree_util.tree_leaves(new), jax.tree_util.tree_leaves(jax_params))])
    single = _tree_norm(tf.param_leaves(single_sgd[1]))
    port_ep = _tree_norm(tf.param_leaves(ranks[(2, 2, 2, 1)][0]["sgd"]))
    assert abs(jax_ep / single - 8.0) < 1e-3 * 8
    assert abs(port_ep / single - 1.0) < 1e-4
