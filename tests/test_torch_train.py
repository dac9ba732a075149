"""PyTorch port: the training step against the JAX package.

One set of JAX-made parameters (turned into numpy and loaded as fp32
masters with ``params_from_jax``) and numpy-made tokens go through both
packages: the loss, its gradient, an SGD step, AdamW ``Trainer`` steps
with and without gradient accumulation, the optimizer against optax, the
blockwise loss, and a bit-exact resume.  The JAX side runs its Pallas
kernels in interpret mode; the port runs its kernels' plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attention_metal_tpu.harness import train_bench as jax_bench
from flash_attention_metal_tpu.models import losses as jax_losses
from flash_attention_metal_tpu.models import trainer as jax_trainer
from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu_torch.harness import train_bench
from flash_attention_metal_tpu_torch.models import (
    ModelConfig,
    Trainer,
    loss_fn_blockwise,
    make_optimizer,
    params_from_jax,
    perplexity,
    sgd_train_step,
)
from flash_attention_metal_tpu_torch.models import losses
from flash_attention_metal_tpu_torch.models import transformer as tf
from flash_attention_metal_tpu_torch.utils import checkpoint, roofline

JAX_CFG = jax_tf.ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=jnp.float32,
)
CFG = ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=torch.float32,
)
SEQ = 128
# fp32 throughout.  Losses of ~5.6 agree to ~1e-6 relative; gradients and
# updated parameters differ by the frameworks' summation orders and the
# JAX kernels' bf16x3 fp32 products (~2^-16 relative), amplified through
# two layers: 1e-4 of each leaf's largest value (1e-4 absolute for leaves
# below 1) bounds that, while a wrong mask, scale, bias correction or
# decay moves a leaf by 1e-2 or more.
TOL = 1e-4


def _leaf_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.detach().numpy() - want)) / max(1.0, np.max(np.abs(want))))


def _assert_trees_close(got, want, tol=TOL):
    flat_want = jax.tree_util.tree_leaves(want)
    flat_got = tf.param_leaves(got)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert g.shape == w.shape
        assert _leaf_err(g, w) < tol


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)


def _port_params(jax_params):
    return params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params), CFG, dtype=torch.float32,
        device="cpu",
    )


def _tokens(seed, batch=2):
    return np.random.default_rng(seed).integers(0, 256, (batch, SEQ)).astype(np.int32)


def test_loss_and_grads_match_jax(jax_params):
    tokens = _tokens(0)
    loss_j, grads_j = jax.value_and_grad(jax_tf.loss_fn)(jax_params, jnp.asarray(tokens), JAX_CFG)
    loss_t, grads_t = tf.value_and_grad(
        tf.loss_fn, _port_params(jax_params), torch.from_numpy(tokens), CFG
    )
    assert abs(float(loss_t) - float(loss_j)) < 1e-5
    _assert_trees_close(grads_t, grads_j)


def test_sgd_train_step_matches_jax(jax_params):
    tokens = _tokens(1)
    new_j, loss_j = jax_tf.sgd_train_step(jax_params, jnp.asarray(tokens), JAX_CFG, lr=0.1)
    new_t, loss_t = sgd_train_step(_port_params(jax_params), torch.from_numpy(tokens), CFG, lr=0.1)
    assert abs(float(loss_t) - float(loss_j)) < 1e-5
    _assert_trees_close(new_t, new_j)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_trainer_steps_match_jax(grad_accum):
    """3 AdamW steps (warmup 2, so lr 0, then half, then full peak) from the
    same parameters on the same batches.  Adam divides each element by its
    own gradient scale, so an element whose gradient is near zero can take
    its update direction from rounding: parameters drift apart by up to
    ~lr per step there.  At lr 1e-3 the drift reads ~2e-5, inside TOL."""
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jt = jax_trainer.Trainer(
        JAX_CFG, optimizer=jax_trainer.make_optimizer(**opt_kw), seed=0, grad_accum=grad_accum
    )
    start = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.state.params), CFG, dtype=torch.float32,
        device="cpu",
    )
    pt = Trainer(CFG, optimizer=make_optimizer(**opt_kw), grad_accum=grad_accum, device="cpu")
    pt.state.params, pt.state.opt_state = start, pt.opt.init(start)
    for step in range(3):
        tokens = _tokens(10 + step, batch=4)
        loss_j = jt.step(jnp.asarray(tokens))
        loss_t = pt.step(torch.from_numpy(tokens))
        assert abs(loss_t - loss_j) < 1e-5 * max(1.0, abs(loss_j))
    assert pt.state.step == int(jt.state.step) == 3
    _assert_trees_close(pt.state.params, jt.state.params)


def test_make_optimizer_matches_optax():
    """lr schedule, global-norm clip (above and below the limit) and weight
    decay on every leaf, step by step against optax on fp32 trees."""
    kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=8, weight_decay=0.1, grad_clip=1.0)
    jopt = jax_trainer.make_optimizer(**kw)
    topt = make_optimizer(**kw)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-2, warmup_steps=3, decay_steps=8, end_value=1e-3
    )
    for count in range(12):
        assert abs(topt.schedule(count) - float(sched(count))) < 1e-9
    assert topt.schedule(0) == 0.0
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((8, 4)).astype(np.float32),
              "norm": np.ones((4,), np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    for step in range(6):
        # Alternate gradients far above and below the clip norm.
        scale = 10.0 if step % 2 == 0 else 0.01
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    # The norm gains decayed too (no mask): they moved off 1.
    assert not torch.allclose(tp["norm"], torch.ones(4))


def test_blockwise_loss_matches_loss_fn_and_jax(jax_params):
    tokens = _tokens(2)
    params = _port_params(jax_params)
    tt = torch.from_numpy(tokens)
    plain, g_plain = tf.value_and_grad(tf.loss_fn, params, tt, CFG)
    block_loss = functools.partial(loss_fn_blockwise, vocab_chunk=64)
    block, g_block = tf.value_and_grad(block_loss, params, tt, CFG)
    assert abs(float(block) - float(plain)) < 1e-5
    for a, b in zip(tf.param_leaves(g_block), tf.param_leaves(g_plain)):
        assert float((a - b).abs().max()) < 1e-5
    want = jax_losses.loss_fn_blockwise(
        jax_params, jnp.asarray(tokens), JAX_CFG, vocab_chunk=64, z_loss=1e-3
    )
    got = loss_fn_blockwise(params, tt, CFG, vocab_chunk=64, z_loss=1e-3)
    assert abs(float(got) - float(want)) < 1e-5
    with pytest.raises(ValueError, match="chunk"):
        losses.blockwise_softmax_xent(torch.zeros(1, 2, 4), torch.zeros(4, 10), torch.zeros(1, 2),
                                      vocab_chunk=4)


def test_perplexity_is_exp_of_the_loss(jax_params):
    params = _port_params(jax_params)
    batches = iter([torch.from_numpy(_tokens(3)), torch.from_numpy(_tokens(4))])
    ppl = perplexity(params, batches, CFG, n_batches=2, vocab_chunk=64)
    loss = np.mean([float(tf.loss_fn(params, torch.from_numpy(_tokens(s)), CFG)) for s in (3, 4)])
    assert abs(ppl - np.exp(loss)) < 1e-3 * ppl


def test_resume_is_bit_exact(tmp_path):
    """Save after 2 steps; a fresh trainer (another seed) that loads the
    checkpoint then repeats the next 2 steps bit for bit, EMA included."""
    opt_kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    batches = [torch.from_numpy(_tokens(20 + i, batch=4)) for i in range(4)]
    a = Trainer(CFG, optimizer=make_optimizer(**opt_kw), seed=0, ema_decay=0.9, grad_accum=2,
                device="cpu")
    for tokens in batches[:2]:
        a.step(tokens)
    path = str(tmp_path / "ckpt" / "state.pt")
    a.save(path)
    losses_a = [a.step(tokens) for tokens in batches[2:]]
    b = Trainer(CFG, optimizer=make_optimizer(**opt_kw), seed=7, ema_decay=0.9, grad_accum=2,
                device="cpu")
    b.load(path)
    assert b.state.step == 2
    losses_b = [b.step(tokens) for tokens in batches[2:]]
    assert losses_a == losses_b
    for x, y in zip(tf.param_leaves(a.state.params), tf.param_leaves(b.state.params)):
        assert torch.equal(x, y)
    for x, y in zip(tf.param_leaves(a.ema_params), tf.param_leaves(b.ema_params)):
        assert torch.equal(x, y)
    assert torch.equal(a.state.generator.get_state(), b.state.generator.get_state())
    with pytest.raises(ValueError, match="EMA"):
        Trainer(CFG, device="cpu").load(path)


def test_train_loop_logs_and_checkpoints(tmp_path):
    from flash_attention_metal_tpu_torch.models import synthetic_batches

    t = Trainer(CFG, optimizer=make_optimizer(warmup_steps=1, total_steps=10), device="cpu")
    lines = []
    path = str(tmp_path / "run.pt")
    out = t.train(synthetic_batches(CFG, 2, 64, device="cpu"), steps=2, checkpoint_path=path,
                  checkpoint_every=2, log_every=1, log=lines.append)
    assert out["final_step"] == 2 and len(out["losses"]) == 2
    assert lines[0].startswith("step 1: loss")
    assert checkpoint.restore_pytree(path)["step"] == 2


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": [torch.arange(3), {"b": torch.ones(2, dtype=torch.bfloat16)}], "n": 7}
    path = str(tmp_path / "t.pt")
    checkpoint.save_pytree(path, tree)
    back = checkpoint.restore_pytree(path)
    assert back["n"] == 7 and torch.equal(back["a"][0], tree["a"][0])
    assert back["a"][1]["b"].dtype == torch.bfloat16


def test_model_flops_per_token_matches_jax():
    jcfg = jax_tf.ModelConfig(vocab_size=32768, d_model=2048, n_layers=8, n_heads=16,
                              n_kv_heads=8, d_ff=4096)
    cfg = train_bench.flashlm_config()
    assert train_bench.model_flops_per_token(cfg, 2048) == jax_bench.model_flops_per_token(jcfg, 2048)


def test_unported_training_features_and_cards_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ModelConfig(attn_dropout=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ModelConfig(attn_softcap=30.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.detect_chip()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_bench.run_train_bench(n_layers=1)
    with pytest.raises(ValueError, match="grad_accum"):
        Trainer(CFG, grad_accum=0, device="cpu")
