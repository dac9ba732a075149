"""PyTorch port: the sharded (dp x tp x sp) training step on gloo groups of
CPU ranks, against the JAX package's sharded loss and single-device step,
and against the port's own single-device step.

Groups (``parallel.spawn``, stores under ``tmp_path``): 8 ranks on mesh
(2, 2, 2), 2 ranks on (1, 2, 1) and on (1, 1, 2), each running
``tests/torch_dist_cases.py::train_cases``.  The FlashLM is the JAX
sharded tests' (d 128, 2 layers, 4/2 heads, fp32), its parameters JAX's
``init_params`` brought across.  The JAX sharded loss runs its Pallas ring
in interpret mode and its all-gather through the XLA reference.
Tolerances: losses 2e-5; updates 1e-4 of the largest update.

JAX's sharded step moves the parameters by the mesh size times the
single-device update (8 on (2, 2, 2)): a fault of the reference that the
port does not copy (ROADMAP.md, Queue C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu.models import parallel_train as jax_pt
from flash_attention_metal_tpu_torch.harness import multichip
from flash_attention_metal_tpu_torch.models import transformer as tf
from flash_attention_metal_tpu_torch.models.from_jax import params_from_jax
from flash_attention_metal_tpu_torch.models.trainer import constant_adamw
from flash_attention_metal_tpu_torch.parallel import spawn

import torch_dist_cases

FIELDS = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
              d_ff=256, max_seq_len=256)
JAX_CFG = jax_tf.ModelConfig(**FIELDS, dtype=jnp.float32, attn_impl="xla")
CFG = tf.ModelConfig(**FIELDS, dtype=torch.float32)
BATCH, SEQ = 2, 256
LR, CLIP, DROPOUT = 1e-2, 1e-6, 0.1
LOSS_TOL, UPDATE_TOL = 2e-5, 1e-4


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


@pytest.fixture(scope="module")
def logits():
    return np.random.default_rng(2).standard_normal((BATCH, SEQ, FIELDS["vocab_size"]),
                                                    np.float32) * 3


SEEDS = torch.tensor([11, 1234567], dtype=torch.int32)


def _spec(params, tokens, mesh, **extra):
    cfg = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}
    return dict(cfg=cfg, mesh=mesh, params=params, tokens=torch.from_numpy(tokens).long(),
                **extra)


@pytest.fixture(scope="module")
def ranks(params, tokens, logits, tmp_path_factory):
    """Each mesh's rank results: one group of 8 ranks for (2, 2, 2) (and
    the dry run), one of 2 for (1, 2, 1) then (1, 1, 2)."""
    out = {}
    for meshes, extra in ((((2, 2, 2),), dict(steps=True, lr=LR, clip=CLIP, dropout_seeds=SEEDS,
                                              dropout_rate=DROPOUT, dryrun=True,
                                              logits=torch.from_numpy(logits))),
                          (((1, 2, 1), (1, 1, 2)), {})):
        specs = [_spec(params, tokens, mesh, **extra) for mesh in meshes]
        got = spawn(torch_dist_cases.train_cases_on_meshes, int(np.prod(meshes[0])), (specs,),
                    backend="gloo", device="cpu", timeout_s=120,
                    workdir=str(tmp_path_factory.mktemp("train")))
        for i, mesh in enumerate(meshes):
            out[mesh] = [r[i] for r in got]
    return out


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), ("dp", "tp", "sp"))


def _jax_loss(jax_params, tokens, shape, sp_attn):
    mesh = _jax_mesh(shape)
    fn = jax.jit(jax.shard_map(
        lambda p, t: jax_pt._sharded_loss(p, t, JAX_CFG, shape[1], shape[2], sp_attn),
        mesh=mesh, in_specs=(jax_pt.param_specs(JAX_CFG), P("dp", "sp")), out_specs=P(),
        check_vma=False))
    return float(fn(jax_params, jnp.asarray(tokens)))


def _update_err(got, want):
    """The largest leaf error over the largest update of the tree."""
    got = [g.numpy() for g in tf.param_leaves(got)]
    want = [np.asarray(w, np.float32) for w in want]
    scale = max(float(np.max(np.abs(w))) for w in want)
    return max(float(np.max(np.abs(g - w))) for g, w in zip(got, want)) / scale


def _tree_norm(leaves):
    return float(np.sqrt(sum(float(np.sum(np.square(np.asarray(x, np.float64)))) for x in leaves)))


def _port_single_step(params, tokens, optimizer=None):
    """The port's single-device update: SGD at LR, or one step of
    ``optimizer``."""
    t = torch.from_numpy(tokens).long()
    loss, grads = tf.value_and_grad(tf.loss_fn, params, t, CFG)
    if optimizer is None:
        return tf.map_params(lambda g: -LR * g, grads)
    p = tf.map_params(torch.clone, params)
    optimizer.update(grads, optimizer.init(p), p)
    return tf.map_params(torch.sub, p, params)


def _jax_delta(jax_params, new):
    return [np.asarray(a) - np.asarray(b) for a, b in zip(jax.tree_util.tree_leaves(new),
                                                          jax.tree_util.tree_leaves(jax_params))]


@pytest.fixture(scope="module")
def port_sgd(params, tokens):
    """The port's single-device SGD update, shared by the tests below."""
    return _port_single_step(params, tokens)


@pytest.fixture(scope="module")
def jax_sgd(jax_params, tokens):
    """JAX's single-device ``(1, 1, 1)`` SGD update, leaf by leaf."""
    step = jax_pt.make_train_step(_jax_mesh((1, 1, 1)), JAX_CFG, lr=LR)
    return _jax_delta(jax_params, step(jax_params, jnp.asarray(tokens))[0])


@pytest.mark.parametrize("mesh", [(2, 2, 2), (1, 2, 1), (1, 1, 2)], ids=str)
def test_shard_unshard_round_trip(ranks, mesh):
    assert all(r["round_trip"] for r in ranks[mesh])


@pytest.mark.parametrize("sp_attn", ["allgather", "ring"])
@pytest.mark.parametrize("mesh", [(2, 2, 2), (1, 2, 1), (1, 1, 2)], ids=str)
def test_sharded_loss_matches_jax(ranks, jax_params, tokens, mesh, sp_attn):
    want = _jax_loss(jax_params, tokens, mesh, sp_attn)
    for r in ranks[mesh]:
        assert abs(r[f"loss_{sp_attn}"] - want) < LOSS_TOL


def test_vocab_sharded_ce_matches_jax(ranks, tokens, logits):
    mesh = _jax_mesh((2, 2, 2))
    fn = jax.jit(jax.shard_map(lambda lg, t: jax_pt.vocab_sharded_ce(lg, t, 2), mesh=mesh,
                               in_specs=(P("dp", "sp", "tp"), P("dp", "sp")), out_specs=P(),
                               check_vma=False))
    want = float(fn(jnp.asarray(logits), jnp.asarray(tokens)))
    for r in ranks[(2, 2, 2)]:
        assert abs(r["ce"] - want) < LOSS_TOL


@pytest.mark.parametrize("sp_attn", ["allgather", "ring"])
def test_sharded_sgd_update_equals_the_single_device_update(ranks, port_sgd, sp_attn):
    got = ranks[(2, 2, 2)][0][f"sgd_{sp_attn}"]
    assert _update_err(got, tf.param_leaves(port_sgd)) < UPDATE_TOL


def test_sharded_sgd_update_equals_jax_single_device_step(ranks, jax_sgd):
    got = ranks[(2, 2, 2)][0]["sgd_allgather"]
    assert _update_err(got, jax_sgd) < UPDATE_TOL


def test_sharded_adamw_with_a_binding_clip_equals_single_device(ranks, params, jax_params,
                                                                tokens):
    """One AdamW step under a binding clip: the port's sharded step against
    its single-device step and against JAX's ``(1, 1, 1)`` optax step
    (clip_by_global_norm, adamw).  The gradient's norm is ~5.9; the clip,
    1e-6, puts the clipped gradients mostly below Adam's eps (1e-8), where
    the first update is ``lr * g * clip / (norm * eps)``: it reads the
    global norm directly, and no element sits at ``|g_c| ~ eps``, where the
    first step magnifies the gradients' fp32 rounding (a clip of 1e-3 reads
    9e-4 of the largest update there, on the same gradients)."""
    got = ranks[(2, 2, 2)][0]["adamw"]
    want = _port_single_step(params, tokens, constant_adamw(LR, grad_clip=CLIP))
    assert _update_err(got, tf.param_leaves(want)) < UPDATE_TOL
    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR))
    step = jax_pt.make_optax_train_step(_jax_mesh((1, 1, 1)), JAX_CFG, opt)
    new, _, _ = step(jax_params, opt.init(jax_params), jnp.asarray(tokens))
    assert _update_err(got, _jax_delta(jax_params, new)) < UPDATE_TOL


def test_jax_2x2x2_step_moves_params_by_8_times_the_single_update_the_port_by_1(
        ranks, port_sgd, jax_sgd, jax_params, tokens):
    """The reference's fault, pinned: its sharded SGD update on (2, 2, 2)
    is 8 times its single-device update; the port's is 1 times."""
    single = _tree_norm(jax_sgd)
    sharded = _tree_norm(_jax_delta(jax_params, jax_pt.make_train_step(
        _jax_mesh((2, 2, 2)), JAX_CFG, lr=LR)(jax_params, jnp.asarray(tokens))[0]))
    assert abs(sharded / single - 8.0) < 1e-3 * 8
    port_single = _tree_norm([g.numpy() for g in tf.param_leaves(port_sgd)])
    port_sharded = _tree_norm([g.numpy() for g in tf.param_leaves(
        ranks[(2, 2, 2)][0]["sgd_allgather"])])
    assert abs(port_sharded / port_single - 1.0) < 1e-4
    assert abs(port_single / single - 1.0) < 1e-4


@pytest.fixture(scope="module")
def dropout_losses(params, tokens):
    """The port's single-device loss with dropout and without."""
    cfg = dataclasses.replace(CFG, attn_dropout=DROPOUT)
    with torch.no_grad():
        return (float(tf.loss_fn(params, torch.from_numpy(tokens).long(), cfg, SEEDS)),
                float(tf.loss_fn(params, torch.from_numpy(tokens).long(), CFG)))


@pytest.mark.parametrize("sp_attn", ["allgather", "ring"])
def test_dropout_sharded_loss_equals_the_single_device_loss(ranks, dropout_losses, sp_attn):
    """Per-layer seeds as ``forward_hidden`` takes them; masks at global
    coordinates, so the (2, 2, 2) loss equals the single-device one."""
    want, plain = dropout_losses
    assert abs(want - plain) > 1e-3  # the dropout acts
    for r in ranks[(2, 2, 2)]:
        assert abs(r[f"dropout_loss_{sp_attn}"] - want) < LOSS_TOL


def test_dryrun_multichip_counterpart_on_8_cpu_ranks(ranks):
    """``harness/multichip.py`` (``MULTICHIP_r05.json``'s five checks), its
    jobs run on the 8-rank group: the loss falls over two steps, the ring-sp
    loss is within 5e-2 of the all-gather loss, greedy int8 decode on the
    (2, 2, 2) mesh (also with ``multi_step=2``) and dense decode with a
    draft equal the one-device engines', and the pipeline's and the ep loss
    fall over two steps on (2, 2, 2, 1)."""
    rep = ranks[(2, 2, 2)][0]["dryrun"]
    jobs = multichip.dryrun_job(8, "cpu")
    assert jobs["train"]["mesh"] == jobs["serve"]["mesh"] == (2, 2, 2)
    assert jobs["pp"]["mesh"] == jobs["ep"]["mesh"] == (2, 2, 2, 1)
    multichip.check_dryrun(rep)
    train = rep["train"]
    assert train["losses"][1] < train["losses"][0]
    assert abs(train["loss_ring"] - train["losses"][0]) < multichip.RING_TOL
    serve = rep["serve"]
    for name, _ in multichip.DRYRUN_SERVE_MODES:
        assert serve[name]["streams"] == serve["single"][name]["streams"]
        assert all(len(toks) == 4 for toks in serve[name]["streams"].values())
    assert serve["int8"]["streams"] == serve["int8_multi_step_2"]["streams"]
    assert rep["pp"]["losses"][1] < rep["pp"]["losses"][0]
    assert rep["ep"]["losses"][1] < rep["ep"]["losses"][0]
