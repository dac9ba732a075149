"""Rolling (wrapped) KV caches and position-space attention in the PyTorch
port, against the JAX package.

A rolling cache keeps O(window) slots and the position each slot holds
(-1: never written); the kernels mask in position space (``kv_positions``).
The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as the JAX package's own tests run them on the CPU) and the
port's (the kernels' plain versions on CPU tensors).  Tolerances: kernel
outputs and lse 2e-5 (fp32, the parity tests' ``TOL``); the caches' arrays
exactly; served greedy tokens equal and log-probabilities within 1e-4 (5e-4
for the 8-bit cache, as ``tests/test_torch_paged.py``'s ``LOGP_TOL``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_metal_tpu.kernels import quant as jax_quant
from flash_attention_metal_tpu.kernels.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu.runtime import decode as jax_dec
from flash_attention_metal_tpu.runtime import engine as jax_eng
from flash_attention_metal_tpu.runtime import kv_cache as jax_kv
from flash_attention_metal_tpu_torch.harness import serving
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels import quant
from flash_attention_metal_tpu_torch.models import ModelConfig, params_from_jax
from flash_attention_metal_tpu_torch.ops.attention import flash_attention
from flash_attention_metal_tpu_torch.runtime import decode as dec
from flash_attention_metal_tpu_torch.runtime import engine as eng_mod
from flash_attention_metal_tpu_torch.runtime import kv_cache as kv

TOL = 2e-5
LOGP_TOL = {"rolling": 1e-4, "rolling_int8": 5e-4}
CAP = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the test workers share
    the host's cores, and idle intra-op threads spin on them (as
    ``tests/test_torch_paged.py`` finds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _slots(p, cap, sinks):
    return np.where(p < sinks, p, sinks + (p - sinks) % (cap - sinks))


def _wrapped(seed, cur, sinks=0, batch=1, n_q=128, heads=2, kv_heads=2, holes=0):
    """JAX ``tests/test_kernels_fwd.py``'s rolling fixture: the last
    positions of a history of ``cur`` (per batch) in a ``CAP``-slot cache,
    later writers winning, then ``holes`` slots set to -1.  Returns q, the
    cache's k, v, positions and the per-batch offsets ``cur - n_q``."""
    rng = np.random.default_rng(seed)
    curs = np.broadcast_to(np.asarray(cur), (batch,))
    q = rng.uniform(-1, 1, (batch, heads, n_q, 64)).astype(np.float32)
    kc = np.zeros((batch, kv_heads, CAP, 64), np.float32)
    vc = np.zeros((batch, kv_heads, CAP, 64), np.float32)
    pos = -np.ones((batch, CAP), np.int32)
    for b, c in enumerate(curs):
        hk = rng.uniform(-1, 1, (kv_heads, c, 64)).astype(np.float32)
        hv = rng.uniform(-1, 1, (kv_heads, c, 64)).astype(np.float32)
        for p in range(c):
            s = _slots(p, CAP, sinks)
            kc[b, :, s], vc[b, :, s], pos[b, s] = hk[:, p], hv[:, p], p
        if holes:
            pos[b, rng.choice(CAP, holes, replace=False)] = -1
    return q, kc, vc, pos, (curs - n_q).astype(np.int32)


# (name, history length(s), sinks, batch, query rows, holes, features):
# JAX's wrap with a 120 window, with sinks, ALiBi with the softcap in
# position space, a short history (most slots -1) with holes, decode rows
# of two histories.
POS_CASES = {
    "wrap_w120": (300, 0, 1, 128, 0, dict(window=120)),
    "wrap_w120_sinks": (300, 4, 1, 128, 0, dict(window=120, sinks=4)),
    "wrap_alibi_softcap": (300, 0, 1, 128, 0, dict(window=120, softcap=20.0, alibi=True)),
    "short_holes": (200, 4, 1, 128, 9, dict(window=64, sinks=4)),
    "decode_two_histories": ((700, 130), 4, 2, 1, 5, dict(window=64, sinks=4, alibi=True)),
}


def _feats(feats, heads=2):
    t_kw, j_kw = dict(feats), dict(feats)
    if t_kw.pop("alibi", False):
        j_kw.pop("alibi")
        slopes = np.asarray([0.5, 0.125][:heads], np.float32)
        t_kw["alibi_slopes"], j_kw["alibi_slopes"] = torch.from_numpy(slopes), jnp.asarray(slopes)
    return t_kw, j_kw


def _abs(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    return float(np.max(np.abs(got[fin] - want[fin])))


@pytest.mark.parametrize("case", sorted(POS_CASES))
def test_kv_positions_forward_matches_jax(case):
    """The position-space forward (the op and the router, the plain
    version) against the JAX kernel in interpret mode: o and lse."""
    cur, sinks, batch, n_q, holes, feats = POS_CASES[case]
    q, kc, vc, pos, off = _wrapped(5, cur, sinks, batch, n_q, holes=holes)
    t_kw, j_kw = _feats(feats)
    o_j, lse_j = jax_fwd(*map(jnp.asarray, (q, kc, vc)), jnp.asarray(off), causal=True,
                         kv_positions=jnp.asarray(pos), save_lse=True, interpret=True,
                         block_sizes=JaxBlockSizes(block_q=128, block_k_major=128, block_k=128)
                         if n_q == 128 else None, **j_kw)
    t = [torch.from_numpy(x) for x in (q, kc, vc, off, pos)]
    o, lse = ff.flash_attention_fwd(*t[:4], causal=True, kv_positions=t[4], save_lse=True, **t_kw)
    assert _abs(o, o_j) < TOL and _abs(lse, np.asarray(lse_j)[..., 0]) < TOL
    o_op = flash_attention(*t[:4], causal=True, kv_positions=t[4], **t_kw)
    assert torch.equal(o_op, o)


@pytest.mark.parametrize("case", ["wrap_w120_sinks", "wrap_alibi_softcap",
                                  "decode_two_histories"])
def test_kv_positions_quant_matches_jax(case):
    """The 8-bit cache's position-space forward against the JAX quant
    kernel on the same int8 bytes and scales."""
    cur, sinks, batch, n_q, holes, feats = POS_CASES[case]
    q, kc, vc, pos, off = _wrapped(6, cur, sinks, batch, n_q, holes=holes)
    t_kw, j_kw = _feats(feats)
    qkv = quant.quantize_kv(torch.from_numpy(kc), torch.from_numpy(vc), torch.int8)
    jqkv = jax_quant.QuantizedKV(
        jnp.asarray(qkv.k_q.numpy()), jnp.asarray(qkv.v_q.numpy()),
        jnp.asarray(qkv.k_scale.numpy().reshape(batch, 2, CAP // 128, 128)),
        jnp.asarray(qkv.v_scale.numpy().reshape(batch, 2, CAP // 128, 128)))
    o_j, lse_j = jax_quant.flash_attention_quant(
        jnp.asarray(q), jqkv, jnp.asarray(off), jnp.asarray(pos), causal=True, save_lse=True,
        interpret=True, **j_kw)
    o, lse = quant.flash_attention_quant(torch.from_numpy(q), qkv, torch.from_numpy(off),
                                         torch.from_numpy(pos), causal=True, save_lse=True, **t_kw)
    assert _abs(o, o_j) < TOL and _abs(lse, np.asarray(lse_j)[..., 0]) < TOL


def test_kv_positions_with_segment_ids_matches_jax():
    """Positions and segment ids together (JAX takes both): the plain
    version on CPU tensors against the JAX kernel, the op too; rows and
    slots of two packed segments, on the wrapped, sinked fixture."""
    from flash_attention_metal_tpu.config import SegmentIds as JaxSegmentIds
    from flash_attention_metal_tpu_torch.config import SegmentIds

    q, kc, vc, pos, off = _wrapped(7, 300, 4, 1, 128, holes=6)
    rng = np.random.default_rng(7)
    q_ids = (np.arange(128)[None] >= 60).astype(np.int32)
    kv_ids = rng.integers(0, 2, (1, CAP)).astype(np.int32)
    t_kw, j_kw = _feats(dict(window=120, sinks=4, alibi=True))
    o_j, lse_j = jax_fwd(*map(jnp.asarray, (q, kc, vc)), jnp.asarray(off), causal=True,
                         kv_positions=jnp.asarray(pos), save_lse=True, interpret=True,
                         segment_ids=JaxSegmentIds(jnp.asarray(q_ids), jnp.asarray(kv_ids)),
                         block_sizes=JaxBlockSizes(block_q=128, block_k_major=128, block_k=128),
                         **j_kw)
    t = [torch.from_numpy(x) for x in (q, kc, vc, off, pos)]
    seg = SegmentIds(torch.from_numpy(q_ids), torch.from_numpy(kv_ids))
    o, lse = ff.flash_attention_fwd(*t[:4], causal=True, kv_positions=t[4], save_lse=True,
                                    segment_ids=seg, **t_kw)
    assert _abs(o, o_j) < TOL and _abs(lse, np.asarray(lse_j)[..., 0]) < TOL
    o_op = flash_attention(*t[:4], causal=True, kv_positions=t[4], segment_ids=seg, **t_kw)
    assert torch.equal(o_op, o)
    want = ff.flash_attention_fwd(*t[:4], causal=True, kv_positions=t[4], **t_kw)
    assert float((o - want).abs().max()) > 1e-2  # the ids mask something


def test_kv_positions_identity_map_equals_index_space():
    """Slots holding their own index: the position-space mask is the
    index-space one, with and without the window, on every route."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
               for s in ((2, 4, 16, 64), (2, 2, 192, 64), (2, 2, 192, 64)))
    off = torch.tensor([100, 176], dtype=torch.int32)
    ident = torch.arange(192, dtype=torch.int32).expand(2, 192)
    for kw in (dict(), dict(window=40, sinks=3), dict(window=40, alibi_slopes=torch.ones(4))):
        want = ff.flash_attention_fwd(q, k, v, off, causal=True, **kw)
        got = ff.flash_attention_fwd(q, k, v, off, causal=True, kv_positions=ident, **kw)
        assert float((got - want).abs().max()) < 1e-6


def test_kv_positions_contract_checks():
    """As JAX: positions need causal and take no row fold or dropout; the
    map is [B, N_kv]."""
    q = torch.zeros((1, 2, 8, 64))
    pos = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="causal"):
        ff.flash_attention_fwd(q, q, q, kv_positions=pos)
    with pytest.raises(NotImplementedError, match="pos_div"):
        ff.flash_attention_fwd(q, q[:, :1], q[:, :1], causal=True, pos_div=2, kv_positions=pos)
    with pytest.raises(NotImplementedError, match="training-path"):
        ff.flash_attention_fwd(q, q, q, causal=True, dropout_rate=0.1, dropout_seed=1,
                               kv_positions=pos)
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        ff.flash_attention_fwd(q, q, q, causal=True, kv_positions=pos[:, :4])
    qkv = quant.quantize_kv(q, q)
    with pytest.raises(ValueError, match="causal"):
        quant.flash_attention_quant(q, qkv, None, pos)


# ---------------------------------------------------------------------------
# The caches' arrays against JAX's
# ---------------------------------------------------------------------------


def test_rolling_slots_match_jax():
    p = np.arange(0, 1000, 7).astype(np.int32)
    for cap, sinks in ((256, 0), (256, 4), (768, 4), (384, 70)):
        want = np.asarray(jax_kv.rolling_slots(jnp.asarray(p), cap, sinks))
        np.testing.assert_array_equal(kv.rolling_slots(torch.from_numpy(p), cap, sinks).numpy(),
                                      want)


@pytest.mark.parametrize("sinks", [0, 4])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_rolling_appends_and_positions_match_jax(sinks, quantized):
    """Appends at wrapped write heads (lengths before, at and past the
    capacity), the in-flight positions, then the bump under a mask: every
    array equal to JAX's (the 8-bit bytes and scales to its jitted path)."""
    rng = np.random.default_rng(sinks)
    lengths = np.asarray([0, 250, 256, 600], np.int32)
    t = 9
    k_new, v_new = (rng.standard_normal((4, 2, t, 64)).astype(np.float32) for _ in range(2))
    if quantized:
        jc = jax_kv.init_rolling_quant_cache(2, 4, 2, CAP, 64, sinks=sinks)
        tc = kv.init_rolling_quant_cache(2, 4, 2, CAP, 64, sinks=sinks)
        append_j = jax.jit(jax_kv.append_tokens_rolling_quant, static_argnums=1)
        append_t = kv.append_tokens_rolling_quant
        names = ("k_q", "v_q", "k_scale", "v_scale")
    else:
        jc = jax_kv.init_rolling_cache(2, 4, 2, CAP, 64, jnp.float32, sinks=sinks)
        tc = kv.init_rolling_cache(2, 4, 2, CAP, 64, torch.float32, sinks=sinks)
        append_j, append_t, names = jax_kv.append_tokens_rolling, kv.append_tokens_rolling, ("k", "v")
    # A history: positions of earlier tokens already in the map.
    hist = rng.integers(-1, 500, (4, CAP)).astype(np.int32)
    jc = dataclasses.replace(jc, lengths=jnp.asarray(lengths), positions=jnp.asarray(hist))
    tc.lengths.copy_(torch.from_numpy(lengths))
    tc.positions.copy_(torch.from_numpy(hist))
    jc = append_j(jc, 1, jnp.asarray(k_new), jnp.asarray(v_new))
    tc = append_t(tc, 1, torch.from_numpy(k_new), torch.from_numpy(v_new))
    for name in names:
        got, want = getattr(tc, name), np.asarray(getattr(jc, name))
        if got.dtype == torch.int8:
            got = got.view(torch.int8)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dec._effective_positions(tc, t).numpy(),
                                  np.asarray(jax_dec._effective_positions(jc, t)))
    mask = np.asarray([True, False, True, True])
    jc = jax_kv.bump_rolling_positions(jc, t, jnp.asarray(mask))
    tc = kv.bump_rolling_positions(tc, t, torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.positions.numpy(), np.asarray(jc.positions))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    tc = kv.reset_slot(tc, 2)
    jc = jax_kv.reset_slot(jc, 2)
    np.testing.assert_array_equal(tc.positions.numpy(), np.asarray(jc.positions))
    with pytest.raises(ValueError, match="wrap region"):
        big = torch.zeros((4, 2, CAP - sinks + 1, 64))
        append_t(tc, 0, big, big)


# ---------------------------------------------------------------------------
# DecodeEngine(rolling=True) against the JAX engine and the dense cache
# ---------------------------------------------------------------------------

JAX_CFG = jax_tf.ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=jnp.float32, attn_window=64, attn_sinks=4,
)
CFG = ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=torch.float32, attn_window=64, attn_sinks=4,
)
# Prompts past the 256-slot cache (W 64 + 4 sinks: ceil(68 / 128) * 128 +
# 128), one short: slots wrap during prefill and decode.
PROMPTS = [[3, 2, 1], [7 + (i * 5) % 200 for i in range(300)]]


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu")


def _serve(mod, params, cfg, prompts, max_new=5, **kw):
    eng = mod.DecodeEngine(params, cfg, max_batch=2, max_len=512, **kw)
    reqs = [mod.Request(uid=u, prompt=p, max_new_tokens=max_new) for u, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


@pytest.mark.parametrize("mode", ["rolling", "rolling_int8"])
def test_rolling_engine_matches_jax(params, jax_params, mode):
    """Greedy fp32 serving through the rolling cache, dense and int8: the
    token streams equal the JAX engine's, log-probabilities agree."""
    opts = serving.SERVING_MODES[mode][0]
    _, want = _serve(jax_eng, jax_params, JAX_CFG, PROMPTS, **opts)
    eng, got = _serve(eng_mod, params, CFG, PROMPTS, **opts)
    assert eng.cache.capacity == CAP and eng._prefill_chunk == 128
    for g, w in zip(got, want):
        assert g.generated == w.generated and len(g.generated) == 5
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=LOGP_TOL[mode], rtol=0)


@pytest.mark.parametrize("transforms", [dict(), dict(attn_softcap=25.0, attn_alibi=True)],
                         ids=["plain", "softcap_alibi"])
def test_rolling_engine_equals_dense_windowed(params, transforms):
    """JAX ``tests/test_model.py``'s rolling == dense windowed engine, past
    the capacity (a 300-token prompt and 40 tokens, slot reuse), also under
    the softcap and ALiBi (the distance in position space)."""
    cfg = dataclasses.replace(CFG, **transforms)
    prompts = PROMPTS + [[9, 8, 7, 6]]
    _, dense = _serve(eng_mod, params, cfg, prompts, max_new=40)
    eng, rolled = _serve(eng_mod, params, cfg, prompts, max_new=40, rolling=True)
    for r, d in zip(rolled, dense):
        assert r.generated == d.generated
        np.testing.assert_allclose(r.logprobs, d.logprobs, atol=1e-4, rtol=0)
    assert eng.cache.k.shape[3] == CAP  # O(window) slots, not max_len


def test_rolling_engine_refusals(params):
    plain = dataclasses.replace(CFG, attn_window=None, attn_sinks=0)
    with pytest.raises(ValueError, match="attn_window"):
        eng_mod.DecodeEngine(params, plain, max_batch=2, max_len=512, rolling=True)
    with pytest.raises(ValueError, match="paged"):
        eng_mod.DecodeEngine(params, CFG, max_batch=2, max_len=512, rolling=True, paged=True)
    with pytest.raises(ValueError, match="rolling"):
        eng_mod.DecodeEngine(params, CFG, max_batch=2, max_len=512, rolling=True,
                             draft=(params, CFG))
    eng = eng_mod.DecodeEngine(params, CFG, max_batch=1, max_len=512, rolling=True)
    toks = torch.zeros((384,), dtype=torch.int32)
    with pytest.raises(ValueError, match="rolling prefill chunk"):
        dec.prefill_slot(params, CFG, eng.cache, toks, 300, 0, chunk=256)


def _no_inflight(cache, t_new):
    return cache.positions.clone()


def _off_by_one(cache, t_new):
    eff = _EFFECTIVE(cache, t_new)
    return torch.where(eff >= 0, eff + 1, eff)


_EFFECTIVE = dec._effective_positions


@pytest.mark.parametrize("fault", [None, "no_inflight_tokens", "positions_off_by_one"])
@pytest.mark.parametrize("mode", ["rolling", "rolling_int8"])
def test_rolling_served_logits_bound_catches_faults(monkeypatch, mode, fault):
    """``teacher_forced_errors`` with bf16 weights through the rolling
    caches at prompts past the capacity, as chip_smoke.py runs it: the
    clean path stays inside the mode's bound, and effective positions
    without the in-flight tokens, or positions one off, land outside it."""
    eng, cfg = serving.build_engine(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256, max_batch=2,
        max_len=512, dtype=torch.bfloat16, device="cpu", window=64, sinks=4)
    if fault:
        monkeypatch.setattr(dec, "_effective_positions",
                            _no_inflight if fault == "no_inflight_tokens" else _off_by_one)
    rng = np.random.default_rng(4)
    prompts = [[5, 9, 100], rng.integers(1, 256, 300).tolist()]
    worst = max(serving.teacher_forced_errors(eng.params, cfg, prompts, 8, 512, mode=mode))
    bound = serving.SERVING_MODES[mode][1]
    assert (worst < bound) if fault is None else (worst > bound)
