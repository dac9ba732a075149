"""DecodeEngine's multi-step dispatch, snapshot/restore and option checks in
the PyTorch port, against the JAX package and against itself.

Both packages get the same numpy-made weights (``params_from_jax``).  Greedy
token streams must be equal and log-probabilities within 1e-4 (fp32, as
``tests/test_torch_serving.py`` holds the dense engine); multi-step
dispatch must give the single-step engine's streams exactly.  Sampled
tokens come from a ``torch.Generator``, so a snapshot restored into a fresh
engine is held to the engine that took it, bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu.runtime import decode as jax_dec
from flash_attention_metal_tpu.runtime import engine as jax_eng
from flash_attention_metal_tpu.runtime import kv_cache as jax_kv
from flash_attention_metal_tpu_torch.harness import serving
from flash_attention_metal_tpu_torch.models import ModelConfig, params_from_jax
from flash_attention_metal_tpu_torch.runtime import decode as dec
from flash_attention_metal_tpu_torch.runtime import engine as eng_mod
from flash_attention_metal_tpu_torch.runtime import kv_cache as kv
from flash_attention_metal_tpu_torch.utils.checkpoint import restore_pytree, save_pytree

JAX_CFG = jax_tf.ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=jnp.float32,
)
CFG = ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=torch.float32,
)
TOL = 1e-4
PREFIX = [7 + (i * 5) % 200 for i in range(150)]


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
def jax_params():
    return jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu")


def _run(mod, params, cfg, n=3, max_new=6, prompts=None, **kw):
    eng = mod.DecodeEngine(params, cfg, max_batch=2, max_len=256, **kw)
    prompts = prompts or [[1 + uid, 2, 3] for uid in range(n)]
    reqs = [mod.Request(uid=u, prompt=p, max_new_tokens=max_new) for u, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


@pytest.mark.parametrize("kw", [dict(multi_step=2), dict(multi_step=4, paged=True),
                                dict(multi_step=3, paged=True, kv_quant="int8")],
                         ids=["dense_2", "paged_4", "paged_int8_3"])
def test_multi_step_matches_single_step_and_jax(params, jax_params, kw):
    """JAX ``tests/test_paged.py:462-480``: several steps a dispatch emit the
    single-step engine's greedy tokens and log-probabilities (the same
    chain of steps), and the JAX engine's with the same options."""
    single = {k: v for k, v in kw.items() if k != "multi_step"}
    one = _run(eng_mod, params, CFG, **single)
    got = _run(eng_mod, params, CFG, **kw)
    want = _run(jax_eng, jax_params, JAX_CFG, **kw)
    for g, o, w in zip(got, one, want):
        assert g.generated == o.generated == w.generated and len(g.generated) == 6
        assert g.logprobs == o.logprobs
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=5e-4 if "kv_quant" in kw else TOL,
                                   rtol=0)


def test_multi_step_eos_overshoot(params):
    """JAX ``tests/test_paged.py:483-495``: EOS inside a dispatch's window;
    the overshoot tokens are discarded and generation stops where the
    single-step engine's does."""
    def run(multi):
        eng = eng_mod.DecodeEngine(params, CFG, max_batch=2, max_len=256, eos_id=7,
                                   multi_step=multi, harvest_lag=2)
        reqs = [eng_mod.Request(uid=u, prompt=[1 + u, 2, 3], max_new_tokens=40) for u in range(3)]
        for r in reqs:
            eng.submit(r)
        return eng.run()

    one = run(1)
    assert run(4) == one
    assert any(len(v) < 40 for v in one.values())  # some request met EOS


def test_multi_step_penalties_and_stop_sequences(params):
    """JAX ``tests/test_penalties.py:82`` and ``tests/test_stop_minp.py:103``:
    penalties counted on the device between the steps of a dispatch, and a
    stop sequence met mid-window (truncated, logprobs aligned), equal to
    the single-step engine's; the queue's stop lists survive a snapshot."""
    def run(multi, **req_kw):
        eng = eng_mod.DecodeEngine(params, CFG, max_batch=1, max_len=256, multi_step=multi)
        req = eng_mod.Request(uid=0, prompt=[1, 2, 3], max_new_tokens=10, **req_kw)
        eng.submit(req)
        eng.run()
        return req

    pen = dict(presence_penalty=3.0, frequency_penalty=0.5)
    assert run(4, **pen).generated == run(1, **pen).generated != run(1).generated
    base = run(1).generated
    i = next(i for i in range(1, 8) if base[i : i + 2] not in
             [base[j : j + 2] for j in range(i)])
    got = run(4, stop=[base[i : i + 2]])
    assert got.generated == base[:i] and len(got.logprobs) == i and got.done
    eng = eng_mod.DecodeEngine(params, CFG, max_batch=1, max_len=256, multi_step=4)
    eng.submit(eng_mod.Request(uid=0, prompt=[1, 2, 3], max_new_tokens=10, stop=[base[i : i + 2]]))
    snap = eng.snapshot()
    eng2 = eng_mod.DecodeEngine(params, CFG, max_batch=1, max_len=256, multi_step=4)
    eng2.restore(snap)
    eng2.run()
    assert eng2.finished[0].generated == base[:i]


def test_decode_and_sample_multi_matches_jax(params, jax_params):
    """The multi-step call itself: greedy tokens of every step and their
    log-probabilities against JAX's ``decode_and_sample_multi``."""
    prompts = np.asarray([[5, 9, 2], [4, 4, 4]], np.int32)
    jc = jax_kv.init_cache(2, 2, 2, 256, 64, jnp.float32)
    tc = kv.init_cache(2, 2, 2, 256, 64, torch.float32)
    for b in range(2):
        padded = np.zeros(128, np.int32)
        padded[:3] = prompts[b]
        _, jc = jax_dec.prefill_slot(jax_params, JAX_CFG, jc, jnp.asarray(padded), jnp.int32(3), b)
        _, tc = dec.prefill_slot(params, CFG, tc, torch.from_numpy(padded), 3, b)
    tok = np.asarray([11, 12], np.int32)
    active = np.asarray([True, True])
    zeros = np.zeros(2, np.float32)
    j_toks, j_lps, jc = jax_dec.decode_and_sample_multi(
        jax_params, JAX_CFG, jc, jnp.asarray(tok), jnp.asarray(active), jax.random.PRNGKey(0),
        jnp.asarray(zeros), n_steps=5)
    gen = torch.Generator()
    t_toks, t_lps, tc = dec.decode_and_sample_multi(
        params, CFG, tc, torch.from_numpy(tok), torch.from_numpy(active), gen,
        torch.from_numpy(zeros), n_steps=5)
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_allclose(t_lps.numpy(), np.asarray(j_lps), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_zombie_margin_is_jaxs(params, jax_params):
    """``harvest_lag * window + window`` with ``window = max(multi_step,
    spec_pad)`` (JAX ``engine.py:147-153``)."""
    for kw in (dict(), dict(multi_step=4), dict(multi_step=8, harvest_lag=3),
               dict(draft="self"), dict(draft="self", spec_gamma=9, harvest_lag=2)):
        t_kw, j_kw = dict(kw), dict(kw)
        if kw.get("draft"):
            t_kw["draft"], j_kw["draft"] = (params, CFG), (jax_params, JAX_CFG)
        got = eng_mod.DecodeEngine(params, CFG, max_batch=2, max_len=256, **t_kw)
        want = jax_eng.DecodeEngine(jax_params, JAX_CFG, max_batch=2, max_len=256, **j_kw)
        assert got._zombie_margin == want._zombie_margin


def test_engine_refusals_are_jaxs(params):
    """JAX's refusals, in its order: multi_step >= 1; a draft takes no
    multi_step and no rolling cache, nor a shared-prefix paged one; a
    sharded engine (``runtime/sp_decode.py``) takes no rolling cache under
    sp, and no slots that do not divide over dp."""
    from flash_attention_metal_tpu_torch.parallel.mesh import Mesh

    win = dataclasses.replace(CFG, attn_window=64)
    mesh = Mesh(("dp", "sp"), (2, 2), 0, "gloo", torch.device("cpu"), {})
    cases = [(CFG, dict(multi_step=0), ValueError, "multi_step"),
             (CFG, dict(draft=(params, CFG), multi_step=2), ValueError, "draft"),
             (win, dict(draft=(params, CFG), rolling=True), ValueError, "rolling"),
             (CFG, dict(draft=(params, CFG), paged=True, prefix_share=True),
              NotImplementedError, "prefix_share"),
             (win, dict(rolling=True, mesh=mesh, seq_axis="sp"), ValueError, "dp-only"),
             (CFG, dict(mesh=Mesh(("dp",), (4,), 0, "gloo", torch.device("cpu"), {})),
              ValueError, "max_batch")]
    for cfg, kw, err, match in cases:
        with pytest.raises(err, match=match):
            eng_mod.DecodeEngine(params, cfg, max_batch=2, max_len=256, **kw)


def _snapshot_roundtrip(params, cfg, tmp_path, reqs, steps, **kw):
    """Run ``steps`` steps, snapshot, save and restore into a fresh engine;
    returns (the streams of the engine that went on, the restored one's)."""
    eng = eng_mod.DecodeEngine(params, cfg, max_batch=2, max_len=512, seed=5, **kw)
    for r in reqs:
        eng.submit(r)
    for _ in range(steps):
        eng.step()
    save_pytree(str(tmp_path / "snap.pt"), eng.snapshot())
    before = {u: (list(r.generated), list(r.logprobs)) for u, r in eng.finished.items()}
    eng.run()
    eng2 = eng_mod.DecodeEngine(params, cfg, max_batch=2, max_len=512, seed=77, **kw)
    eng2.restore(restore_pytree(str(tmp_path / "snap.pt")))
    eng2.finished = {}
    eng2.run()
    got = {**before, **{u: (r.generated, r.logprobs) for u, r in eng2.finished.items()}}
    return {u: (r.generated, r.logprobs) for u, r in eng.finished.items()}, got, eng2


@pytest.mark.parametrize("kw", [dict(), dict(paged=True, prefix_share=True),
                                dict(kv_quant="int8", multi_step=2)],
                         ids=["dense", "paged_prefix_shared", "int8_multi_step"])
def test_snapshot_restore_through_checkpoint(params, tmp_path, kw):
    """A snapshot mid-run (sampled and greedy requests, penalties) saved by
    ``utils.checkpoint`` and restored into a fresh engine: every stream and
    log-probability equals the engine that went on, bit for bit (the
    generator's state, the allocator's and the registry's included), and
    both equal an uninterrupted run's (the snapshot applies none of the
    lagged bookkeeping, so it moves no retirement or admission)."""
    def requests():
        return [eng_mod.Request(uid=u, prompt=PREFIX + [u], max_new_tokens=7,
                                temperature=0.9 if u % 2 else 0.0, top_k=20 if u % 2 else 0,
                                presence_penalty=0.5) for u in range(4)]

    want, got, eng2 = _snapshot_roundtrip(params, CFG, tmp_path, requests(), 9, **kw)
    assert got == want and len(want) == 4
    if kw.get("prefix_share"):
        assert len(eng2._prefix_registry) == 1
        assert eng2._allocator.free_pages == eng2.cache.n_pages - 2
    plain = eng_mod.DecodeEngine(params, CFG, max_batch=2, max_len=512, seed=5, **kw)
    for r in requests():
        plain.submit(r)
    plain.run()
    assert {u: (r.generated, r.logprobs) for u, r in plain.finished.items()} == want


def test_snapshot_restore_rolling(tmp_path):
    """The rolling cache's position map round-trips too."""
    cfg = dataclasses.replace(CFG, attn_window=64, attn_sinks=4)
    gen = torch.Generator()
    gen.manual_seed(0)
    from flash_attention_metal_tpu_torch.models.transformer import init_params

    params = init_params(cfg, gen)
    reqs = [eng_mod.Request(uid=u, prompt=PREFIX * 2 + [u], max_new_tokens=6) for u in range(3)]
    want, got, _ = _snapshot_roundtrip(params, cfg, tmp_path, reqs, 2, rolling=True)
    assert got == want


@pytest.mark.parametrize("mode", ["multi_step_8", "weight_int8", "speculative"])
def test_new_modes_served_logits_within_bounds(mode):
    """``teacher_forced_errors`` of each new serving mode with bf16 weights,
    as chip_smoke.py runs it (the speculative mode through its verify
    chunks of gamma + 1 rows), inside the mode's bound."""
    eng, cfg = serving.build_engine(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256, max_batch=2,
        max_len=512, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(6)
    prompts = [[5, 9, 100, 31, 7], rng.integers(1, 256, 150).tolist()]
    errs = serving.teacher_forced_errors(eng.params, cfg, prompts, 10, 512, mode=mode)
    assert len(errs) == 2 * 11 and max(errs) < serving.SERVING_MODES[mode][1]


def test_multi_step_served_logits_catch_a_stale_token(monkeypatch):
    """The multi-step mode's served-logits check runs the dispatch itself:
    a dispatch that feeds every step its first token, not the token the
    step before chose, exceeds the mode's bound."""
    eng, cfg = serving.build_engine(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256, max_batch=2,
        max_len=512, dtype=torch.bfloat16, device="cpu")
    prompts = [[5, 9, 100, 31, 7], np.random.default_rng(6).integers(1, 256, 150).tolist()]

    def stale(params, cfg, cache, tokens, active, gen, temps, *_, n_steps, with_logits=False):
        toks, lps, logits = [], [], []
        for _ in range(n_steps):
            lg, cache = dec.decode_step(params, cfg, cache, tokens, active)
            tok, lp = dec._sample_step(lg, active, gen, temps, *[None] * 6)
            toks.append(tok), lps.append(lp), logits.append(lg)
        return torch.stack(toks), torch.stack(lps), cache, torch.stack(logits)

    bound = serving.SERVING_MODES["multi_step_8"][1]
    assert max(serving.teacher_forced_errors(eng.params, cfg, prompts, 10, 512,
                                             mode="multi_step_8")) < bound
    monkeypatch.setattr(serving, "decode_and_sample_multi", stale)
    assert max(serving.teacher_forced_errors(eng.params, cfg, prompts, 10, 512,
                                             mode="multi_step_8")) > bound
