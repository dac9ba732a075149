"""PyTorch port: KV cache, prefill/decode, sampling and DecodeEngine
against the JAX package, and the served-path check's tolerance.

Both packages get the same numpy-made weights, prompts and logits.  The
JAX side runs its Pallas kernels in interpret mode; the port runs on CPU
tensors, so its kernel wrapper takes the plain version.  Random draws
differ between ``torch.Generator`` and ``jax.random``, so sampled tokens
are never compared: greedy tokens, filters, logits and log-probabilities
are.
"""

import warnings

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
from flash_attention_metal_tpu_torch.models import transformer as tf
from flash_attention_metal_tpu_torch.ops import attention as ops
from flash_attention_metal_tpu_torch.runtime import decode as dec
from flash_attention_metal_tpu_torch.runtime import engine as eng_mod
from flash_attention_metal_tpu_torch.runtime import kv_cache as kv

JAX_CFG = jax_tf.ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=jnp.float32,
)
CFG = ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=torch.float32,
)
MAX_LEN = 256
# fp32 logits and log-probabilities: see tests/test_torch_model.py.
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu")


def _close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


def test_pad_to_matches_jax():
    for n in (1, 127, 128, 129):
        x = list(range(1, n + 1))
        np.testing.assert_array_equal(eng_mod._pad_to(x, 128), jax_eng._pad_to(x, 128))


def test_append_tokens_clamps_like_dynamic_update_slice():
    rng = np.random.default_rng(0)
    lengths = np.asarray([0, 5, 127, 126], np.int32)  # 127/126: clamped starts
    k_new = rng.standard_normal((4, 2, 3, 64)).astype(np.float32)
    v_new = rng.standard_normal((4, 2, 3, 64)).astype(np.float32)
    jc = jax_kv.init_cache(2, 4, 2, 128, 64, jnp.float32)
    jc = jax_kv.KVCache(jc.k, jc.v, jnp.asarray(lengths))
    jc = jax_kv.append_tokens(jc, 1, jnp.asarray(k_new), jnp.asarray(v_new))
    tc = kv.init_cache(2, 4, 2, 128, 64, torch.float32)
    tc.lengths.copy_(torch.from_numpy(lengths))
    tc = kv.append_tokens(tc, 1, torch.from_numpy(k_new), torch.from_numpy(v_new))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    tc = kv.bump_lengths(tc, 3, torch.tensor([True, False, True, False]))
    np.testing.assert_array_equal(tc.lengths.numpy(), [3, 5, 130, 126])
    tc = kv.reset_slot(tc, 2)
    assert int(tc.lengths[2]) == 0


@pytest.mark.parametrize("chunk", [None, 128])
def test_prefill_and_decode_match_jax(params, jax_params, chunk):
    """Teacher-forced: prefill slot 1 (padded rows included), then decode
    with slot 0 inactive; logits and the whole cache agree with JAX."""
    prompt_len = 150 if chunk else 100
    tokens = np.random.default_rng(2).integers(1, 256, 160).astype(np.int32)
    padded = np.zeros(256 if chunk else 128, np.int32)
    padded[:prompt_len] = tokens[:prompt_len]

    jc = jax_kv.init_cache(2, 2, 2, MAX_LEN, 64, jnp.float32)
    jl, jc = jax_dec.prefill_slot(
        jax_params, JAX_CFG, jc, jnp.asarray(padded), jnp.int32(prompt_len), 1, chunk=chunk
    )
    tc = kv.init_cache(2, 2, 2, MAX_LEN, 64, torch.float32)
    tl, tc = dec.prefill_slot(
        params, CFG, tc, torch.from_numpy(padded), prompt_len, 1, chunk=chunk
    )
    _close(tl, jl)
    assert tc.lengths.tolist() == [0, prompt_len] == np.asarray(jc.lengths).tolist()
    _close(tc.k, jc.k)  # padded rows' KV written too
    _close(tc.v, jc.v)

    active = np.asarray([False, True])
    for t in range(prompt_len, prompt_len + 4):
        step = np.asarray([7, tokens[t]], np.int32)
        jl, jc = jax_dec.decode_step(
            jax_params, JAX_CFG, jc, jnp.asarray(step), jnp.asarray(active)
        )
        tl, tc = dec.decode_step(
            params, CFG, tc, torch.from_numpy(step), torch.from_numpy(active)
        )
        _close(tl[1], jl[1])
    assert tc.lengths.tolist() == [0, prompt_len + 4] == np.asarray(jc.lengths).tolist()
    _close(tc.k, jc.k)


def test_sample_batch_filters_and_penalties_match_jax():
    rng = np.random.default_rng(3)
    logits = np.round(rng.standard_normal((4, 64)), 1).astype(np.float32)  # ties
    top_k = np.asarray([0, 5, 0, 3], np.int32)
    top_p = np.asarray([1.0, 1.0, 0.8, 0.9], np.float32)
    min_p = np.asarray([0.0, 0.0, 0.05, 0.1], np.float32)
    want = np.asarray(
        jax_dec.filter_scaled_logits(
            jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(min_p)
        )
    )
    got = dec.filter_scaled_logits(
        torch.from_numpy(logits), torch.from_numpy(top_k), torch.from_numpy(top_p),
        torch.from_numpy(min_p),
    ).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])

    counts = rng.integers(0, 3, (4, 64)).astype(np.int32)
    presence = np.asarray([0.0, 0.5, 1.0, 2.0], np.float32)
    frequency = np.asarray([0.0, 0.3, 0.0, 1.0], np.float32)
    temps = np.zeros(4, np.float32)  # greedy, penalised
    want_tok = jax_dec.sample_batch(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temps),
        jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(counts),
        jnp.asarray(presence), jnp.asarray(frequency), jnp.asarray(min_p),
    )
    got_tok = dec.sample_batch(
        torch.from_numpy(logits), torch.Generator().manual_seed(0),
        torch.from_numpy(temps), torch.from_numpy(top_k), torch.from_numpy(top_p),
        torch.from_numpy(counts), torch.from_numpy(presence),
        torch.from_numpy(frequency), torch.from_numpy(min_p),
    )
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))


def test_sampled_tokens_stay_in_filtered_set():
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 100)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    top_k = torch.tensor([1, 5, 0], dtype=torch.int32)
    temps = torch.tensor([0.7, 1.0, 0.5])
    kept = dec.filter_scaled_logits(logits / temps[:, None], top_k)
    for _ in range(20):
        tok = dec.sample_batch(logits, gen, temps, top_k)
        assert torch.isfinite(kept[torch.arange(3), tok.long()]).all()
    assert tok[0] == torch.argmax(logits[0])  # top-k 1 is greedy


def _jax_margins(jax_params, seqs):
    """JAX top-1 minus top-2 logit at every position of each sequence."""
    width = max(len(s) for s in seqs)
    tokens = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        tokens[i, : len(s)] = s
    logits = np.asarray(jax_tf.forward(jax_params, jnp.asarray(tokens), JAX_CFG, remat=False))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_engine_matches_jax_greedy(params, jax_params):
    """Greedy fp32 serving: 4 requests on 2 slots (slot reuse), one with a
    stop sequence.  Token streams are equal and log-probabilities agree."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).tolist() for n in (3, 17, 9, 30)]

    def requests(cls, stop0):
        return [
            cls(uid=i, prompt=p, max_new_tokens=8, stop=[stop0] if i == 0 and stop0 else [])
            for i, p in enumerate(prompts)
        ]

    # A stop sequence that occurs: tokens 3-4 of request 0's own output.
    free = eng_mod.DecodeEngine(params, CFG, max_batch=2, max_len=MAX_LEN, harvest_lag=2)
    for r in requests(eng_mod.Request, None):
        free.submit(r)
    stop0 = free.run()[0][3:5]

    je = jax_eng.DecodeEngine(jax_params, JAX_CFG, max_batch=2, max_len=MAX_LEN, harvest_lag=2)
    te = eng_mod.DecodeEngine(params, CFG, max_batch=2, max_len=MAX_LEN, harvest_lag=2)
    j_reqs, t_reqs = requests(jax_eng.Request, stop0), requests(eng_mod.Request, stop0)
    for jr, tr in zip(j_reqs, t_reqs):
        je.submit(jr)
        te.submit(tr)
    je.run()
    te.run()

    # Request 0 stopped at its stop sequence, which is cut off.
    assert len(t_reqs[0].generated) <= 3
    margins = _jax_margins(jax_params, [r.prompt + r.generated for r in j_reqs])
    for i, (jr, tr) in enumerate(zip(j_reqs, t_reqs)):
        n = len(jr.generated)
        near_tie = np.nonzero(margins[i, len(jr.prompt) - 1 : len(jr.prompt) - 1 + n] < TOL)[0]
        if near_tie.size:
            n = int(near_tie[0])
            warnings.warn(
                f"request {i}: JAX's top-2 logit margin at step {n} is below "
                f"{TOL}, so greedy tokens from step {n} on may differ on rounding"
            )
            assert tr.generated[:n] == jr.generated[:n]
            continue
        assert tr.generated == jr.generated, i
        np.testing.assert_allclose(tr.logprobs, jr.logprobs, atol=TOL, rtol=0)


def test_engine_rejects_unported_options(params):
    for kw in (dict(paged=True), dict(rolling=True), dict(kv_quant="int8"),
               dict(multi_step=4), dict(draft=(params, CFG)), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng_mod.DecodeEngine(params, CFG, max_batch=2, max_len=MAX_LEN, **kw)


def test_serving_bench_on_cpu():
    eng, cfg = serving.build_engine(
        n_layers=1, d_model=128, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        max_batch=2, max_len=256, dtype=torch.float32, device="cpu", harvest_lag=3,
    )
    reqs = serving.make_requests(5, cfg.vocab_size, (4, 40), 6, seed=0)
    result = serving.run_serving_bench(eng, reqs, log=lambda s: None)
    assert result["total_generated_tokens"] == 30
    assert all(r.done and len(r.generated) == 6 for r in reqs)
    assert [r.temperature for r in reqs[:2]] == [0.0, 0.8]
    assert all(lp <= 0 for r in reqs for lp in r.logprobs)


def _rope_half_split(x, positions, theta, rope=tf.rope):
    """RoPE over the half-split pairs (j, j + D/2): Hugging Face's Llama."""
    d = x.shape[-1]
    perm = torch.cat([torch.arange(0, d, 2), torch.arange(1, d, 2)])
    return rope(x[..., torch.argsort(perm)], positions, theta)[..., perm]


@pytest.mark.parametrize(
    "fault", [None, "one_position_too_few", "one_position_too_many", "rope_half_split"]
)
def test_served_logits_tolerance_catches_faults(monkeypatch, fault):
    """``teacher_forced_errors`` with bf16 weights, activations and cache,
    as chip_smoke.py runs it: the clean path stays inside
    LOGITS_REL_L2_TOL, and each injected fault lands outside it."""
    eng, cfg = serving.build_engine(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256,
        max_batch=2, max_len=MAX_LEN, dtype=torch.bfloat16, device="cpu",
    )
    if fault in ("one_position_too_few", "one_position_too_many"):
        shift = -1 if fault == "one_position_too_few" else 1
        kernel = ops.flash_attention_fwd

        def shifted(q, k, v, q_offset=None, **kw):
            return kernel(q, k, v, q_offset + shift, **kw)

        monkeypatch.setattr(ops, "flash_attention_fwd", shifted)
    elif fault == "rope_half_split":
        def projections(layer, x, cfg, positions):
            with monkeypatch.context() as m:
                m.setattr(tf, "rope", _rope_half_split)
                return tf.qkv_projections(layer, x, cfg, positions)

        monkeypatch.setattr(dec, "qkv_projections", projections)
    # A short pair and a long pair (several KV tiles), as chip_smoke.py has.
    long_prompts = np.random.default_rng(6).integers(1, 256, (2, 200))
    prompts = [[5, 9, 100, 31, 7], list(range(40, 51)),
               long_prompts[0, :150].tolist(), long_prompts[1].tolist()]
    worst = max(serving.teacher_forced_errors(eng.params, cfg, prompts, 16, MAX_LEN))
    if fault is None:
        assert worst < serving.LOGITS_REL_L2_TOL
    else:
        assert worst > serving.LOGITS_REL_L2_TOL
