"""PyTorch port: the pipeline axis (``models/pipeline.py``) on gloo groups of
CPU ranks, against the JAX package's pipelined loss and the port's own
single-device step.

One group of 8 ranks (``parallel.spawn``, its store under ``tmp_path``;
the rank side is ``tests/torch_dist_cases.py::pp_cases``), each mesh over
its first ranks: mesh ``(dp, pp, tp, sp) = (1, 2, 1, 1)`` on 2, (2, 2, 1,
1) and (1, 2, 2, 1) on 4, (2, 2, 2, 1) and, with the ring sequence
attention, (2, 2, 1, 2) on all 8.  The FlashLM is
``tests/test_pipeline.py``'s (d 128, 4 layers, 4/2 heads, fp32), its weights
JAX's ``init_params`` brought across, on ``[8, 128]`` tokens.  JAX's
all-gather attention runs through its XLA reference (``attn_impl="xla"``,
as ``tests/test_torch_parallel_train.py``), which its interpret-mode kernels
match within fp32.  Tolerances: losses 2e-5;
updates 1e-4 of the largest update.

JAX's pipelined step moves the parameters by the mesh size times its
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

from flash_attention_metal_tpu.models import pipeline as jax_pl
from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu_torch.models import pipeline as pl
from flash_attention_metal_tpu_torch.models import transformer as tf
from flash_attention_metal_tpu_torch.models.from_jax import params_from_jax
from flash_attention_metal_tpu_torch.models.trainer import constant_adamw
from flash_attention_metal_tpu_torch.parallel import spawn
from flash_attention_metal_tpu_torch.parallel.mesh import Mesh

import torch_dist_cases

FIELDS = dict(vocab_size=512, d_model=128, n_layers=4, n_heads=4, n_kv_heads=2, head_dim=64,
              d_ff=256, max_seq_len=512)
JAX_CFG = jax_tf.ModelConfig(**FIELDS, dtype=jnp.float32, attn_impl="xla")
CFG = tf.ModelConfig(**FIELDS, dtype=torch.float32)
BATCH, SEQ = 8, 128
LR, CLIP = 1e-2, 1e-6
LOSS_TOL, UPDATE_TOL = 2e-5, 1e-4
LOSS_MESHES = [(1, 2, 1, 1), (2, 2, 1, 1), (1, 2, 2, 1)]
MICRO = (1, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu",
                           dtype=torch.float32)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, FIELDS["vocab_size"], (BATCH, SEQ), np.int32)


# The runs: the losses at every n_micro on the loss meshes; one SGD and one
# AdamW step on (2, 2, 2, 1), one ring SGD step on (2, 2, 1, 2).
RUNS = ([dict(mesh=m, n_micro=n, sp_attn="allgather", steps="loss")
         for m in LOSS_MESHES for n in MICRO]
        + [dict(mesh=(2, 2, 2, 1), n_micro=2, sp_attn="allgather", steps="sgd"),
           dict(mesh=(2, 2, 2, 1), n_micro=2, sp_attn="allgather", steps="adamw"),
           dict(mesh=(2, 2, 1, 2), n_micro=2, sp_attn="ring", steps="sgd")])


@pytest.fixture(scope="module")
def ranks(params, tokens, tmp_path_factory):
    """Rank 0's results of every run, ``{(mesh, n_micro, sp_attn, steps):
    result}``, with every rank of its mesh's losses."""
    cfg = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}
    spec = dict(cfg=cfg, params=params, tokens=torch.from_numpy(tokens).long(), runs=RUNS,
                lr=LR, clip=CLIP)
    got = spawn(torch_dist_cases.pp_cases, 8, (spec,), backend="gloo", device="cpu",
                timeout_s=240, workdir=str(tmp_path_factory.mktemp("pp")))
    out = {}
    for i, run in enumerate(RUNS):
        key = (run["mesh"], run["n_micro"], run["sp_attn"], run["steps"])
        out[key] = got[0][i]
        out[key]["all_losses"] = [r[i]["loss"] for r in got if r[i] is not None]
        assert len(out[key]["all_losses"]) == int(np.prod(run["mesh"]))
    return out


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), jax_pl.AXES)


def _jax_loss(jax_params, tokens, shape, n_micro=2, sp_attn="allgather"):
    mesh = _jax_mesh(shape)
    _, pp, tp, sp = shape
    fn = jax.jit(jax.shard_map(
        lambda p, t: jax_pl._pp_loss(p, t, JAX_CFG, pp, tp, sp, n_micro, sp_attn),
        mesh=mesh, in_specs=(jax_pl.pp_param_specs(JAX_CFG), P("dp", "sp")), out_specs=P(),
        check_vma=False))
    return float(fn(jax_pl.stack_layer_params(jax_params), jnp.asarray(tokens)))


def _port_single_step(params, tokens, optimizer=None):
    t = torch.from_numpy(tokens).long()
    loss, grads = tf.value_and_grad(tf.loss_fn, params, t, CFG)
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


def test_stack_unstack_round_trip(params):
    stacked = pl.stack_layer_params(params)
    assert stacked["layers"]["wq"].shape == (4, 128, 256)
    back = pl.unstack_layer_params(stacked)
    assert all(torch.equal(a, b) for a, b in zip(tf.param_leaves(back), tf.param_leaves(params)))


def test_pp_param_specs_equal_jax():
    want = jax_pl.pp_param_specs(JAX_CFG)
    got = pl.pp_param_specs(CFG)
    assert got["layers"] == {k: tuple(v) for k, v in want["layers"].items()}
    for k in ("embed", "final_norm", "lm_head"):
        assert got[k] == tuple(want[k])


@pytest.fixture(scope="module")
def jax_losses(jax_params, tokens):
    return {mesh: _jax_loss(jax_params, tokens, mesh) for mesh in LOSS_MESHES}


@pytest.mark.parametrize("n_micro", MICRO)
@pytest.mark.parametrize("mesh", LOSS_MESHES, ids=str)
def test_pp_loss_matches_jax(ranks, jax_losses, mesh, n_micro):
    """The port's pipelined loss at every microbatch count against JAX's
    on the same mesh (at two microbatches: JAX's loss does not depend on
    the count, ``test_pipeline.py::test_pp_microbatch_count_invariance``),
    on every rank."""
    want = jax_losses[mesh]
    for loss in ranks[(mesh, n_micro, "allgather", "loss")]["all_losses"]:
        assert abs(loss - want) < LOSS_TOL


@pytest.mark.parametrize("key", [((2, 2, 2, 1), 2, "allgather", "sgd"),
                                 ((2, 2, 1, 2), 2, "ring", "sgd")], ids=["allgather", "ring"])
def test_pp_sgd_update_equals_the_single_device_update(ranks, single_sgd, key):
    """One SGD step: the loss and the unsharded update equal the port's
    single-device step's, on dp x pp x tp and on dp x pp x ring-sp
    (``test_pipeline.py:105``)."""
    loss, want = single_sgd
    got = ranks[key]
    assert all(abs(x - loss) < LOSS_TOL for x in got["all_losses"])
    assert _update_err(got["delta"], want) < UPDATE_TOL


def test_pp_adamw_with_a_binding_clip_equals_single_device(ranks, params, tokens):
    """One AdamW step under a clip of 1e-6 (binding: the gradient's norm
    is ~6): the global norm counts each element once, so the sharded
    update equals the single-device one."""
    _, want = _port_single_step(params, tokens, constant_adamw(LR, grad_clip=CLIP))
    got = ranks[((2, 2, 2, 1), 2, "allgather", "adamw")]
    assert _update_err(got["delta"], want) < UPDATE_TOL


def _fake_mesh(shape):
    return Mesh(pl.AXES, tuple(shape), 0, "gloo", torch.device("cpu"), {})


@pytest.mark.parametrize("make", ["sgd", "adamw"])
def test_pp_rejects_bad_layer_split(make):
    mesh = _fake_mesh((1, 8, 1, 1))  # 8 stages over 4 layers
    with pytest.raises(ValueError, match="divisible"):
        if make == "sgd":
            pl.make_pp_train_step(mesh, CFG, n_micro=2)
        else:
            pl.make_pp_optax_step(mesh, CFG, constant_adamw(LR), n_micro=2)


def test_jax_pp_step_moves_params_by_the_mesh_size_times_the_single_update_the_port_by_1(
        ranks, single_sgd, jax_params, tokens):
    """The reference's fault, pinned: JAX's pipelined SGD update on (2, 2,
    2, 1) is 8 times the single-device update (the port's, which equals
    JAX's single-device step: ``tests/test_torch_train.py``); the port's
    pipelined update is 1 times it."""
    stacked = jax_pl.stack_layer_params(jax_params)
    step = jax_pl.make_pp_train_step(_jax_mesh((2, 2, 2, 1)), JAX_CFG, n_micro=2, lr=LR)
    new, _ = step(stacked, jnp.asarray(tokens))
    jax_pp = _tree_norm([np.asarray(a) - np.asarray(b) for a, b in zip(
        jax.tree_util.tree_leaves(new), jax.tree_util.tree_leaves(stacked))])
    single = _tree_norm(tf.param_leaves(single_sgd[1]))
    port_pp = _tree_norm(tf.param_leaves(ranks[((2, 2, 2, 1), 2, "allgather", "sgd")]["delta"]))
    assert abs(jax_pp / single - 8.0) < 1e-3 * 8
    assert abs(port_pp / single - 1.0) < 1e-4
