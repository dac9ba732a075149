"""Speculative decoding in the PyTorch port, against the JAX package.

The draft model changes how many target forwards a generation takes, never
the greedy tokens (Leviathan et al.).  The same numpy-made weights go to
both packages (``params_from_jax``); greedy streams must equal the target's
plain greedy decode and the JAX speculative path's, in ``speculative_generate``
and through ``DecodeEngine(draft=...)`` over a dense, 8-bit or paged target
cache.  Random draws come from a ``torch.Generator``, so the sampling rule
is held to its distribution (JAX ``tests/test_speculative.py:328``'s
statistical check), not to JAX's draws.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu.runtime import engine as jax_eng
from flash_attention_metal_tpu.runtime import speculative as jax_spec
from flash_attention_metal_tpu_torch.models import ModelConfig, params_from_jax
from flash_attention_metal_tpu_torch.runtime import decode as dec
from flash_attention_metal_tpu_torch.runtime import engine as eng_mod
from flash_attention_metal_tpu_torch.runtime import speculative as spec

JAX_T = jax_tf.ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                           head_dim=64, d_ff=256, max_seq_len=512, dtype=jnp.float32)
JAX_D = jax_tf.ModelConfig(vocab_size=256, d_model=128, n_layers=1, n_heads=2, n_kv_heads=1,
                           head_dim=64, d_ff=128, max_seq_len=512, dtype=jnp.float32)
CFG_T = ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                    head_dim=64, d_ff=256, max_seq_len=512, dtype=torch.float32)
CFG_D = ModelConfig(vocab_size=256, d_model=128, n_layers=1, n_heads=2, n_kv_heads=1,
                    head_dim=64, d_ff=128, max_seq_len=512, dtype=torch.float32)
PROMPTS = [[1, 2, 3], [9, 8, 7, 6, 5, 4], [100, 3]]


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
def jax_models():
    return (jax_tf.init_params(jax.random.PRNGKey(0), JAX_T),
            jax_tf.init_params(jax.random.PRNGKey(1), JAX_D))


@pytest.fixture(scope="module")
def models(jax_models):
    jt, jd = (jax.tree_util.tree_map(np.asarray, p) for p in jax_models)
    return (params_from_jax(jt, CFG_T, device="cpu"), params_from_jax(jd, CFG_D, device="cpu"))


def _plain_greedy(params, cfg, prompts, max_new):
    eng = eng_mod.DecodeEngine(params, cfg, max_batch=len(prompts), max_len=512)
    for u, p in enumerate(prompts):
        eng.submit(eng_mod.Request(uid=u, prompt=p, max_new_tokens=max_new))
    out = eng.run()
    return [out[u] for u in range(len(prompts))]


@pytest.mark.parametrize("gamma", [1, 4])
def test_speculative_generate_greedy_equals_plain_and_jax(models, jax_models, gamma):
    got = spec.speculative_generate(*models[:1], CFG_T, models[1], CFG_D, PROMPTS, 12,
                                    gamma=gamma)
    assert got == _plain_greedy(models[0], CFG_T, PROMPTS, 12)
    want = jax_spec.speculative_generate(jax_models[0], JAX_T, jax_models[1], JAX_D, PROMPTS, 12,
                                         gamma=gamma)
    assert got == want


def test_perfect_draft_accepts_everything(models):
    """The target as its own draft: every round emits gamma + 1 tokens."""
    stats = {}
    got = spec.speculative_generate(models[0], CFG_T, models[0], CFG_T, PROMPTS, 11, gamma=4,
                                    stats=stats)
    assert got == _plain_greedy(models[0], CFG_T, PROMPTS, 11)
    assert stats["emitted"] == 5 * stats["slot_rounds"]


@pytest.mark.parametrize("kw", [dict(), dict(kv_quant="int8"), dict(paged=True)],
                         ids=["dense", "int8", "paged"])
def test_spec_engine_greedy_matches_plain_and_jax(models, jax_models, kw):
    """JAX ``tests/test_speculative.py:245-290``: the engine's speculative
    rounds over a dense, int8 or paged target cache (the draft's dense),
    with slot churn, emit the plain engine's greedy tokens and the JAX
    speculative engine's."""
    def run(mod, params, cfg, draft):
        eng = mod.DecodeEngine(params, cfg, max_batch=2, max_len=512, draft=draft,
                               spec_gamma=3, harvest_lag=2, **kw)
        for uid in range(4):
            eng.submit(mod.Request(uid=uid, prompt=[1 + uid, 2, 3], max_new_tokens=9))
        return eng, eng.run()

    eng, got = run(eng_mod, models[0], CFG_T, (models[1], CFG_D))
    _, plain = run(eng_mod, models[0], CFG_T, None)
    _, want = run(jax_eng, jax_models[0], JAX_T, (jax_models[1], JAX_D))
    assert got == plain == want
    assert type(eng.draft_cache).__name__ == "KVCache"
    assert all(not r.logprobs for r in eng.finished.values())  # as JAX's speculative path
    if kw.get("paged"):
        assert not torch.any(eng.cache.page_table)


def test_spec_engine_paged_self_draft_long_generation(models):
    """A paged target served as its own draft (every proposal accepted, so
    the device runs gamma + 1 tokens a round ahead of the lagged harvest)
    over 320 new tokens, well past the pages granted in the first
    harvest_lag rounds: the pages granted keep ahead of the verify
    chunk's writes, and the greedy streams equal the plain engine's."""
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5, 4]]
    eng = eng_mod.DecodeEngine(models[0], CFG_T, max_batch=2, max_len=512, paged=True,
                               draft=(models[0], CFG_T))
    for u, p in enumerate(prompts):
        eng.submit(eng_mod.Request(uid=u, prompt=p, max_new_tokens=320))
    out = eng.run()
    # Every round emitted gamma + 1 tokens; harvest_lag more rounds ran
    # before the last retirement landed.
    assert eng.steps <= 320 // 5 + 1 + eng.harvest_lag
    assert [out[u] for u in range(2)] == _plain_greedy(models[0], CFG_T, prompts, 320)


def test_spec_engine_penalties_top_k1_matches_plain(models):
    """JAX ``tests/test_speculative.py:290``: with top_k 1 the penalised,
    filtered distribution is a point mass, so the speculative engine emits
    the plain engine's tokens (the window's running counts on the draft and
    the acceptance)."""
    def run(draft):
        eng = eng_mod.DecodeEngine(models[0], CFG_T, max_batch=2, max_len=512, draft=draft,
                                   spec_gamma=3)
        for uid in range(2):
            eng.submit(eng_mod.Request(uid=uid, prompt=[2 + uid, 3, 4], max_new_tokens=10,
                                       temperature=1.0, top_k=1, presence_penalty=2.0,
                                       frequency_penalty=0.5))
        return eng.run()

    assert run((models[1], CFG_D)) == run(None)


def test_acceptance_rule_filtered_distribution():
    """JAX ``tests/test_speculative.py:328``: the first emitted token's
    marginal under top-k / top-p equals the FILTERED target distribution
    (what ``sample_batch`` serves) for a draft proposing from its own
    filtered distribution; nothing outside the support is emitted."""
    vocab, gamma, batch, reps = 16, 2, 512, 6
    rng = np.random.default_rng(0)
    t_log = torch.from_numpy(rng.standard_normal(vocab).astype(np.float32) * 1.5)
    q_log = t_log + torch.from_numpy(rng.standard_normal(vocab).astype(np.float32))
    tau = torch.ones((batch, 1))
    top_ks = torch.full((batch,), 5, dtype=torch.int32)
    top_ps = torch.full((batch,), 0.9)
    greedy = torch.zeros((batch,), dtype=torch.bool)
    q_filt = dec.filter_scaled_logits(q_log.expand(batch, vocab).clone(), top_ks, top_ps)
    gen = torch.Generator()
    gen.manual_seed(100)
    samples = []
    for _ in range(reps):
        d = torch.stack([dec._categorical(q_filt, gen) for _ in range(gamma)], dim=1)
        out, n_acc, bonus = spec.acceptance_rule(
            d, q_log.expand(batch, gamma, vocab), t_log.expand(batch, gamma + 1, vocab),
            greedy, tau, gen, top_ks, top_ps)
        assert torch.equal(out[torch.arange(batch), n_acc], bonus)
        samples.append(out[:, 0].numpy())
    counts = np.bincount(np.concatenate(samples), minlength=vocab)
    emp = counts / counts.sum()
    want = torch.softmax(dec.filter_scaled_logits(t_log[None], top_ks[:1], top_ps[:1])[0],
                         dim=-1).numpy()
    assert 0.5 * np.abs(emp - want).sum() < 0.05
    assert counts[want < 1e-9].sum() == 0


def test_forward_chunk_matches_single_steps(models):
    """The verify chunk's logits (gamma + 1 rows at each slot's offset)
    equal one decode step a token, and leave the lengths alone."""
    from flash_attention_metal_tpu_torch.runtime.kv_cache import init_cache

    params = models[0]
    caches = [init_cache(2, 2, 2, 256, 64, torch.float32) for _ in range(2)]
    for c in caches:
        for b, n in enumerate((3, 40)):
            toks = torch.zeros(128, dtype=torch.int32)
            toks[:n] = torch.arange(1, n + 1)
            dec.prefill_slot(params, CFG_T, c, toks, n, b)
    seq = torch.tensor([[5, 6, 7, 8, 9], [10, 11, 12, 13, 14]], dtype=torch.int32)
    chunk, _ = spec._forward_chunk(params, CFG_T, caches[0], seq)
    assert caches[0].lengths.tolist() == [3, 40]
    active = torch.ones(2, dtype=torch.bool)
    for t in range(5):
        logits, _ = dec.decode_step(params, CFG_T, caches[1], seq[:, t], active)
        np.testing.assert_allclose(chunk[:, t].numpy(), logits.numpy(), atol=1e-4, rtol=0)
