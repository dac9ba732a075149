"""PyTorch port: paged KV caches, the page allocator, the paged kernels'
plain versions, and DecodeEngine's 8-bit, paged and prefix-shared serving,
checked against the JAX package.

Both packages get the same numpy-made inputs and weights.  The JAX side
runs its Pallas kernels in interpret mode; the port runs on CPU tensors, so
its kernel wrappers take their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.kernels import paged as jax_paged
from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu.runtime import engine as jax_eng
from flash_attention_metal_tpu.runtime import paged_kv as jax_pkv
from flash_attention_metal_tpu_torch.harness import serving
from flash_attention_metal_tpu_torch.kernels import paged, quant
from flash_attention_metal_tpu_torch.models import ModelConfig, params_from_jax
from flash_attention_metal_tpu_torch.runtime import decode as dec
from flash_attention_metal_tpu_torch.runtime import engine as eng_mod
from flash_attention_metal_tpu_torch.runtime import paged_kv as pkv

PS = 128  # page size
FORMATS = {
    "int8": (torch.int8, jnp.int8),
    "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
    "e5m2": (torch.float8_e5m2, jnp.float8_e5m2),
}
# Plain version against the JAX kernel in interpret mode, fp32 q on the
# uniform(-1, 1) fixture: summation order only.
KERNEL_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the test workers share
    the host's cores, and each worker's idle intra-op threads spin on them
    (the engine tests ran ~100x slower beside five other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host(x) -> np.ndarray:
    """A tensor or array as numpy, 8-bit ones as their bytes."""
    if torch.is_tensor(x):
        return (x.contiguous().view(torch.uint8) if x.element_size() == 1 else x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.itemsize == 1 else x


def _scrambled(batch, kv_heads, n_kv, seed, head_dim=64):
    """Dense uniform K/V ``[B, H_kv, n_kv, head_dim]`` and a shuffled page
    table over ``1 + batch * n_kv / PS`` pages (page 0 never named)."""
    rng = np.random.default_rng(seed)
    k, v = (rng.uniform(-1, 1, (batch, kv_heads, n_kv, head_dim)).astype(np.float32)
            for _ in "kv")
    pages_per = n_kv // PS
    table = (1 + rng.permutation(batch * pages_per)).reshape(batch, pages_per).astype(np.int32)
    return k, v, table, 1 + batch * pages_per


def _pool(x: np.ndarray, table: np.ndarray, n_pages: int) -> np.ndarray:
    """Lay ``x [B, H, N, ...]`` into pages ``[n_pages, H, PS, ...]`` by the
    table; page 0 holds a large constant that no visible column reads."""
    b, h, n = x.shape[:3]
    pool = np.full((n_pages, h, PS) + x.shape[3:], 7, x.dtype)
    pages = x.reshape(b, h, n // PS, PS, *x.shape[3:]).swapaxes(1, 2)
    pool[table.reshape(-1)] = pages.reshape(-1, h, PS, *x.shape[3:])
    return pool


def _kill_past_diagonal(table, lengths, rows_per_pos):
    """Table entries past each slot's last visible page set to 0, as the
    allocator leaves unallocated entries."""
    live = (rows_per_pos - 1 + lengths) // PS + 1
    return np.where(np.arange(table.shape[1])[None, :] < live[:, None], table, 0).astype(np.int32)


# (t_new, fold, head_dim): decode one token (folded over the group as the
# decode step does, and not), a 128-row prefill chunk, and folded decode at
# head dim 128.
PAGED_CASES = {"decode_fold": (1, True, 64), "decode": (1, False, 64),
               "prefill128": (128, False, 64), "decode_fold_d128": (1, True, 128)}


def _paged_inputs(case, seed):
    t_new, fold, d = PAGED_CASES[case]
    batch, heads, kv_heads, n_kv = 2, 4, 2, 512
    k, v, table, n_pages = _scrambled(batch, kv_heads, n_kv, seed, d)
    rng = np.random.default_rng(seed + 1)
    q = rng.uniform(-1, 1, (batch, heads, t_new, d)).astype(np.float32)
    lengths = np.asarray([n_kv - t_new, 3 * PS - t_new - 5], np.int32)
    pos_div = 1
    if fold:
        pos_div = heads // kv_heads
        q = q.reshape(batch, kv_heads, pos_div * t_new, d)  # the group's rows
    return q, k, v, table, _kill_past_diagonal(table, lengths, t_new), n_pages, lengths, pos_div


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_plain_matches_jax(case):
    q, k, v, full, table, n_pages, lengths, pos_div = _paged_inputs(case, seed=0)
    pool_k, pool_v = _pool(k, full, n_pages), _pool(v, full, n_pages)
    got = paged.flash_attention_paged(
        *(torch.from_numpy(x) for x in (q, pool_k, pool_v, table, lengths)), pos_div=pos_div)
    want = jax_paged.flash_attention_paged(
        *(jnp.asarray(x) for x in (q, pool_k, pool_v, table, lengths)), pos_div=pos_div,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL, rtol=0)
    assert paged.flash_attention_paged.launches == 0


@pytest.mark.parametrize("fmt", ["int8", "e4m3"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_quant_plain_matches_jax(case, fmt):
    tdt, jdt = FORMATS[fmt]
    q, k, v, full, table, n_pages, lengths, pos_div = _paged_inputs(case, seed=2)
    qkv = quant.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), tdt)
    pools = []
    for x in (qkv.k_q, qkv.v_q):
        pools.append(torch.from_numpy(_pool(_host(x), full, n_pages)).view(tdt))
    for s in (qkv.k_scale, qkv.v_scale):
        pools.append(torch.from_numpy(_pool(s.numpy(), full, n_pages)))
    t_table, t_len = torch.from_numpy(table), torch.from_numpy(lengths)
    got = paged.flash_attention_paged_quant(
        torch.from_numpy(q), *pools, t_table, t_len, pos_div=pos_div)
    j_pools = [jnp.asarray(_host(p)).view(jdt) for p in pools[:2]]
    j_pools += [jnp.asarray(p.numpy()) for p in pools[2:]]
    want = jax_paged.flash_attention_paged_quant(
        jnp.asarray(q), *j_pools, jnp.asarray(table), jnp.asarray(lengths), pos_div=pos_div,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL, rtol=0)
    # The dense 8-bit plain version over the same tokens agrees too.
    dense = quant.flash_attention_quant(torch.from_numpy(q), qkv, t_len, causal=True,
                                        pos_div=pos_div)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=KERNEL_TOL, rtol=0)
    assert paged.flash_attention_paged_quant.launches == 0


@pytest.mark.parametrize("window,sinks", [(100, 0), (37, 4), (200, 130)])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_window_matches_jax(case, window, sinks):
    """Both paged kernels' plain versions under a window with sinks, against
    the JAX kernels in interpret mode through the shuffled tables."""
    q, k, v, full, table, n_pages, lengths, pos_div = _paged_inputs(case, seed=5)
    kw = dict(pos_div=pos_div, window=window, sinks=sinks)
    pool_k, pool_v = _pool(k, full, n_pages), _pool(v, full, n_pages)
    got = paged.flash_attention_paged(
        *(torch.from_numpy(x) for x in (q, pool_k, pool_v, table, lengths)), **kw)
    want = jax_paged.flash_attention_paged(
        *(jnp.asarray(x) for x in (q, pool_k, pool_v, table, lengths)), interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL, rtol=0)
    qkv = quant.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    pools = [torch.from_numpy(_pool(_host(x), full, n_pages)).view(torch.int8)
             for x in (qkv.k_q, qkv.v_q)]
    pools += [torch.from_numpy(_pool(s.numpy(), full, n_pages)) for s in (qkv.k_scale, qkv.v_scale)]
    got = paged.flash_attention_paged_quant(
        torch.from_numpy(q), *pools, torch.from_numpy(table), torch.from_numpy(lengths), **kw)
    j_pools = [jnp.asarray(_host(p)).view(jnp.int8) for p in pools[:2]]
    j_pools += [jnp.asarray(p.numpy()) for p in pools[2:]]
    want = jax_paged.flash_attention_paged_quant(
        jnp.asarray(q), *j_pools, jnp.asarray(table), jnp.asarray(lengths), interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL, rtol=0)


def test_paged_kernels_reject_what_they_do_not_take():
    q = torch.zeros((1, 2, 1, 64))
    pool = torch.zeros((3, 2, PS, 64))
    table = torch.zeros((1, 2), dtype=torch.int32)
    lengths = torch.zeros((1,), dtype=torch.int32)
    # The softcap and ALiBi are ported (tests/test_torch_xf.py holds them
    # against JAX); ALiBi takes no row fold, as in JAX, and a cap is > 0.
    assert paged.flash_attention_paged(q, pool, pool, table, lengths, softcap=30.0).shape == q.shape
    with pytest.raises(NotImplementedError, match="pos_div"):
        paged.flash_attention_paged(torch.zeros((1, 2, 2, 64)), pool[:, :1], pool[:, :1], table,
                                    lengths, pos_div=2, alibi_slopes=torch.ones(2))
    with pytest.raises(ValueError, match="softcap"):
        paged.flash_attention_paged(q, pool, pool, table, lengths, softcap=0.0)
    with pytest.raises(ValueError, match="multiple of 64"):
        paged.flash_attention_paged(q, pool[:, :, :96], pool[:, :, :96], table, lengths)
    with pytest.raises(TypeError, match="int32"):
        paged.flash_attention_paged(q, pool, pool, table.long(), lengths)
    with pytest.raises(TypeError, match="dtype"):
        paged.flash_attention_paged(q, pool.bfloat16(), pool.bfloat16(), table, lengths)


# ---------------------------------------------------------------------------
# The allocator and the paged caches' appends
# ---------------------------------------------------------------------------


def _alloc_state(alloc):
    return (list(alloc._free), [list(o) for o in alloc._owned], list(alloc._refs),
            list(alloc._reserved), alloc._committed, alloc._pinned, alloc.free_pages)


def test_page_allocator_matches_jax():
    """One sequence of reserve / grow / adopt / pin / unpin / release on
    both allocators gives the same table, free list and refcounts."""
    jc = jax_pkv.init_paged_cache(1, 3, 2, 4 * PS, 64, n_pages=10, page_size=PS)
    tc = pkv.init_paged_cache(1, 3, 2, 4 * PS, 64, n_pages=10, page_size=PS)
    ja, ta = jax_pkv.PageAllocator(10, 3), pkv.PageAllocator(10, 3)
    script = [
        ("reserve", 0, 3), ("grow", 0, 2 * PS + 1), ("pin", 1), ("pin", 2),
        ("reserve", 1, 3), ("adopt", 1, 1), ("adopt", 1, 2), ("grow", 1, 3 * PS),
        ("reserve", 2, 1), ("grow", 2, 10), ("release", 0), ("unpin", 1),
        ("grow", 2, 2 * PS), ("release", 1), ("unpin", 2), ("reserve", 0, 4),
        ("grow", 0, 4 * PS),
    ]
    for op, *args in script:
        if op in ("grow", "adopt", "release"):
            jc = getattr(ja, op)(jc, *args)
            tc = getattr(ta, op)(tc, *args)
        else:
            getattr(ja, op)(*args)
            getattr(ta, op)(*args)
        assert _alloc_state(ta) == _alloc_state(ja), (op, args)
        np.testing.assert_array_equal(tc.page_table.numpy(), np.asarray(jc.page_table))
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        assert ta.can_reserve(3) == ja.can_reserve(3)
    assert 0 not in [p for o in ta._owned for p in o]  # page 0 never granted
    with pytest.raises(MemoryError):
        ta.reserve(1, 8)
    with pytest.raises(ValueError):
        ta.grow(tc, 1, 5 * PS)


def test_prefix_chain_keys_match_jax():
    rng = np.random.default_rng(4)
    for n in (5, 128, 300, 512):
        prompt = rng.integers(1, 50000, n).tolist()
        assert eng_mod._prefix_chain_keys(prompt, PS) == jax_eng._prefix_chain_keys(prompt, PS)


@pytest.mark.parametrize("fmt", [None, "int8", "e4m3", "e5m2"])
def test_paged_append_matches_jax(fmt):
    """Appends scatter through the table at each slot's write head, from
    mid-page (100), page-aligned (128) and empty slots; every pool byte and
    scale equals JAX's."""
    lengths = np.asarray([100, 0, 128], np.int32)
    rng = np.random.default_rng(5)
    k_new, v_new = (rng.standard_normal((3, 2, 7, 64)).astype(np.float32) for _ in "kv")
    args = (2, 3, 2, 4 * PS, 64)
    if fmt is None:
        jc = jax_pkv.init_paged_cache(*args, n_pages=13, page_size=PS, dtype=jnp.float32)
        tc = pkv.init_paged_cache(*args, n_pages=13, page_size=PS, dtype=torch.float32)
        j_append, t_append = jax_pkv.append_tokens_paged, pkv.append_tokens_paged
        names = ("pool_k", "pool_v")
    else:
        tdt, jdt = FORMATS[fmt]
        jc = jax_pkv.init_paged_quant_cache(*args, n_pages=13, page_size=PS, dtype=jdt)
        tc = pkv.init_paged_quant_cache(*args, n_pages=13, page_size=PS, dtype=tdt)
        assert bool(torch.all(tc.pool_k_scale == 0.0))
        j_append, t_append = jax_pkv.append_tokens_paged_quant, pkv.append_tokens_paged_quant
        names = ("pool_k_q", "pool_v_q", "pool_k_scale", "pool_v_scale")
    ja, ta = jax_pkv.PageAllocator(13, 3), pkv.PageAllocator(13, 3)
    for slot, n in ((0, 2 * PS), (1, PS), (2, 2 * PS)):
        jc, tc = ja.grow(jc, slot, n), ta.grow(tc, slot, n)
    jc = dataclasses.replace(jc, lengths=jnp.asarray(lengths))
    tc.lengths.copy_(torch.from_numpy(lengths))
    j_append = jax.jit(j_append, static_argnums=1)  # as JAX's serving steps run it
    for layer in range(2):
        jc = j_append(jc, layer, jnp.asarray(k_new), jnp.asarray(v_new))
        tc = t_append(tc, layer, torch.from_numpy(k_new), torch.from_numpy(v_new))
    for name in names:
        np.testing.assert_array_equal(_host(getattr(tc, name)), _host(getattr(jc, name)))
    if fmt is None:
        dk, dv = pkv.gather_slot_kv(tc, 1, 0)
        np.testing.assert_array_equal(dk[:, 100:107].numpy(), k_new[0])
        np.testing.assert_array_equal(dv[:, 100:107].numpy(), v_new[0])


def test_released_slot_writes_land_on_page_0():
    """A retired slot keeps decoding until its retirement lands: with its
    table row zeroed by ``release``, its writes go to the reserved page 0
    and never to a page granted to another slot."""
    cache = pkv.init_paged_cache(1, 2, 2, 2 * PS, 64, n_pages=5, page_size=PS,
                                 dtype=torch.float32)
    alloc = pkv.PageAllocator(5, 2)
    cache = alloc.grow(cache, 0, 2 * PS)
    cache.lengths[0] = 130
    cache = alloc.release(cache, 0)
    cache = alloc.grow(cache, 1, 2 * PS)  # slot 1 gets slot 0's freed pages
    before = cache.pool_k.clone()
    k_new = torch.ones((2, 2, 1, 64))
    cache.lengths[1] = 5
    cache = pkv.append_tokens_paged(cache, 0, k_new, k_new)
    changed = (cache.pool_k != before).any(dim=(0, 2, 3, 4)).nonzero().flatten().tolist()
    assert changed == sorted({0, int(cache.page_table[1, 0])})


@pytest.mark.parametrize("case,feats", [
    ("decode", dict(softcap=30.0, alibi=True)), ("prefill128", dict(softcap=0.5, alibi=True)),
    ("decode_fold", dict(softcap=20.0)), ("decode_fold_d128", dict(softcap=30.0, window=100)),
    ("prefill128", dict(softcap=30.0, alibi=True, window=37, sinks=4))])
def test_paged_xf_matches_jax(case, feats):
    """Both paged kernels' plain versions under the softcap and ALiBi (the
    distance in logical positions), against the JAX kernels in interpret
    mode through the shuffled tables; folded decode takes the softcap alone."""
    q, k, v, full, table, n_pages, lengths, pos_div = _paged_inputs(case, seed=7)
    t_kw, j_kw = dict(feats, pos_div=pos_div), dict(feats, pos_div=pos_div)
    if t_kw.pop("alibi", False):
        j_kw.pop("alibi")
        slopes = np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32)
        t_kw["alibi_slopes"], j_kw["alibi_slopes"] = torch.from_numpy(slopes), jnp.asarray(slopes)
    pool_k, pool_v = _pool(k, full, n_pages), _pool(v, full, n_pages)
    got = paged.flash_attention_paged(
        *(torch.from_numpy(x) for x in (q, pool_k, pool_v, table, lengths)), **t_kw)
    want = jax_paged.flash_attention_paged(
        *(jnp.asarray(x) for x in (q, pool_k, pool_v, table, lengths)), interpret=True, **j_kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL, rtol=0)
    qkv = quant.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), torch.int8)
    pools = [torch.from_numpy(_pool(_host(x), full, n_pages)).view(torch.int8)
             for x in (qkv.k_q, qkv.v_q)]
    pools += [torch.from_numpy(_pool(s.numpy(), full, n_pages)) for s in (qkv.k_scale, qkv.v_scale)]
    got = paged.flash_attention_paged_quant(
        torch.from_numpy(q), *pools, torch.from_numpy(table), torch.from_numpy(lengths), **t_kw)
    j_pools = [jnp.asarray(_host(p)).view(jnp.int8) for p in pools[:2]]
    j_pools += [jnp.asarray(p.numpy()) for p in pools[2:]]
    want = jax_paged.flash_attention_paged_quant(
        jnp.asarray(q), *j_pools, jnp.asarray(table), jnp.asarray(lengths), interpret=True, **j_kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL, rtol=0)


# ---------------------------------------------------------------------------
# DecodeEngine against the JAX engine (tests/test_paged.py's configuration)
# ---------------------------------------------------------------------------

JAX_CFG = jax_tf.ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=jnp.float32,
)
CFG = ModelConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=256, max_seq_len=256, dtype=torch.float32,
)
# A prompt prefix of more than one full page (tests/test_paged.py).
PREFIX = [7 + (i * 5) % 200 for i in range(150)]
# The serving modes of the 8-bit and paged caches, as the harness runs them.
ENGINE_MODES = {m: serving.SERVING_MODES[m][0] for m in serving.KV_MODES if m != "dense"}
# Log-probabilities of the same greedy tokens, fp32.  The 8-bit caches
# round fp32 keys that differ between the packages in their last bits to
# the same 8-bit values almost always; where one lands on the other side
# of a rounding step the logits move by ~1e-5 (read up to 6.5e-5).
LOGP_TOL = {"paged": 1e-4, "paged_prefix_shared": 1e-4, "int8": 5e-4, "fp8": 5e-4,
            "paged_int8": 5e-4}


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu")


def _serve(mod, params, cfg, prompts, max_len=512, **kw):
    eng = mod.DecodeEngine(params, cfg, max_batch=2, max_len=max_len, **kw)
    reqs = [mod.Request(uid=uid, prompt=p, max_new_tokens=5) for uid, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_engine_matches_jax(params, jax_params, mode):
    """Greedy fp32 serving of 4 requests on 2 slots (slots are reused), the
    last three sharing a 150-token prefix: token streams are equal and
    log-probabilities agree."""
    prompts = [[3, 2, 1]] + [PREFIX + [uid] for uid in range(1, 4)]
    _, want = _serve(jax_eng, jax_params, JAX_CFG, prompts, **ENGINE_MODES[mode])
    eng, got = _serve(eng_mod, params, CFG, prompts, **ENGINE_MODES[mode])
    for g, w in zip(got, want):
        assert g.generated == w.generated and len(g.generated) == 5
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=LOGP_TOL[mode], rtol=0)
    if eng._paged:
        # Every page went back to the pool but the registry's pins.
        pinned = len(eng._prefix_registry)
        assert eng._allocator.free_pages == eng.cache.n_pages - 1 - pinned
        assert not torch.any(eng.cache.page_table)


# A window the prefix crosses, with sinks (tests/test_model.py's pattern).
WIN_JAX_CFG = dataclasses.replace(JAX_CFG, attn_window=64, attn_sinks=4)
WIN_CFG = dataclasses.replace(CFG, attn_window=64, attn_sinks=4)


@pytest.mark.parametrize("mode", sorted(serving.KV_MODES))
def test_windowed_engine_matches_jax(params, jax_params, mode):
    """A FlashLM with a 64-token window and 4 sinks served in every cache
    mode: the greedy token streams equal the JAX engine's, and the
    log-probabilities agree (the same bounds as unwindowed)."""
    opts = serving.SERVING_MODES[mode][0]
    prompts = [[3, 2, 1]] + [PREFIX + [uid] for uid in range(1, 4)]
    _, want = _serve(jax_eng, jax_params, WIN_JAX_CFG, prompts, **opts)
    _, got = _serve(eng_mod, params, WIN_CFG, prompts, **opts)
    for g, w in zip(got, want):
        assert g.generated == w.generated and len(g.generated) == 5
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=LOGP_TOL.get(mode, 1e-4), rtol=0)
    # The window changes what is served: the unwindowed engine differs.
    _, plain = _serve(eng_mod, params, CFG, prompts[1:2], **opts)
    assert not np.allclose(plain[0].logprobs, got[1].logprobs, atol=1e-3, rtol=0)


# A capped ALiBi FlashLM (tests/test_model.py's pattern: ALiBi in place of
# RoPE, cap 30).
XF_JAX_CFG = dataclasses.replace(JAX_CFG, attn_softcap=30.0, attn_alibi=True)
XF_CFG = dataclasses.replace(CFG, attn_softcap=30.0, attn_alibi=True)


@pytest.mark.parametrize("mode", sorted(serving.KV_MODES))
def test_xf_engine_matches_jax(params, jax_params, mode):
    """The capped ALiBi FlashLM served in every cache mode (ALiBi unfolds
    the decode rows): the greedy token streams equal the JAX engine's and
    the log-probabilities agree (the same bounds as untransformed)."""
    opts = serving.SERVING_MODES[mode][0]
    prompts = [[3, 2, 1]] + [PREFIX + [uid] for uid in range(1, 4)]
    _, want = _serve(jax_eng, jax_params, XF_JAX_CFG, prompts, **opts)
    _, got = _serve(eng_mod, params, XF_CFG, prompts, **opts)
    for g, w in zip(got, want):
        assert g.generated == w.generated and len(g.generated) == 5
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=LOGP_TOL.get(mode, 1e-4), rtol=0)
    # The transforms change what is served: the plain engine differs.
    _, plain = _serve(eng_mod, params, CFG, prompts[1:2], **opts)
    assert not np.allclose(plain[0].logprobs, got[1].logprobs, atol=1e-3, rtol=0)


def test_paged_oversubscribed_pool(params):
    """A pool of one usable page serves the same tokens as the full pool:
    admission waits for pages instead of failing."""
    prompts = [[1 + uid, 2, 3] for uid in range(4)]
    _, small = _serve(eng_mod, params, CFG, prompts, max_len=256, paged=True, n_pages=2,
                      harvest_lag=0)
    _, big = _serve(eng_mod, params, CFG, prompts, max_len=256, paged=True, harvest_lag=0)
    assert [r.generated for r in small] == [r.generated for r in big]


def test_prefix_share_reuses_physical_pages(params):
    """Co-resident same-prefix slots name the same physical page, the
    registry keeps it after both retire, a later request adopts it, and
    the tokens equal the unshared engine's."""
    eng = eng_mod.DecodeEngine(params, CFG, max_batch=2, max_len=512, paged=True,
                               prefix_share=True)
    eng.submit(eng_mod.Request(uid=0, prompt=PREFIX + [1], max_new_tokens=4))
    eng.submit(eng_mod.Request(uid=1, prompt=PREFIX + [2], max_new_tokens=4))
    eng.step()  # admits both
    table = eng.cache.page_table.numpy()
    assert table[0, 0] == table[1, 0] != 0
    assert len(eng._prefix_registry) == 1
    assert eng.stats()["pages_adopted"] == 1  # the second admission's
    shared_phys = int(table[0, 0])
    eng.run()
    assert len(eng._prefix_registry) == 1 and eng._allocator._refs[shared_phys] == 1
    eng.submit(eng_mod.Request(uid=2, prompt=PREFIX + [3], max_new_tokens=4))
    eng.step()
    assert shared_phys in eng.cache.page_table[:, 0].tolist()
    eng.run()
    _, unshared = _serve(eng_mod, params, CFG, [PREFIX + [u] for u in (1, 2, 3)], paged=True)
    assert [eng.finished[u].generated for u in range(3)] == [r.generated[:4] for r in unshared]


def test_prefix_share_eviction_under_pressure(params):
    """A pool too small to keep prefixes evicts the registry instead of
    refusing admission, and serves the same tokens."""
    prompts = [PREFIX + [u] for u in range(1, 5)]
    _, small = _serve(eng_mod, params, CFG, prompts, max_len=256, paged=True,
                      prefix_share=True, n_pages=4)
    _, big = _serve(eng_mod, params, CFG, prompts, max_len=256, paged=True, prefix_share=True)
    assert [r.generated for r in small] == [r.generated for r in big]


# ---------------------------------------------------------------------------
# The served-logits bound of each mode against injected faults
# ---------------------------------------------------------------------------


def _shift_offsets(monkeypatch, shift):
    """Every attention call of the decode step reads one cache position
    too few (shift -1) or too many (+1): the causal offset moves."""
    def shifted(fn, pos):
        def call(*args, **kw):
            args = list(args)
            args[pos] = args[pos] + shift
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(dec, "flash_attention_quant", shifted(dec.flash_attention_quant, 2))
    monkeypatch.setattr(dec, "flash_attention_paged", shifted(dec.flash_attention_paged, 4))
    monkeypatch.setattr(dec, "flash_attention_paged_quant",
                        shifted(dec.flash_attention_paged_quant, 6))


@pytest.mark.parametrize("fault", [None, "one_position_too_few", "one_position_too_many"])
@pytest.mark.parametrize("mode", ["int8", "fp8", "paged", "paged_prefix_shared", "paged_int8"])
def test_served_logits_bound_catches_faults(monkeypatch, mode, fault):
    """``teacher_forced_errors`` with bf16 weights and activations through
    each mode's cache, as chip_smoke.py runs it: the clean path stays
    inside the mode's bound (``serving.SERVING_MODES``), and a cache
    position too few or too many lands outside it."""
    eng, cfg = serving.build_engine(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256,
        max_batch=2, max_len=512, dtype=torch.bfloat16, device="cpu",
    )
    if fault:
        _shift_offsets(monkeypatch, -1 if fault == "one_position_too_few" else 1)
    rng = np.random.default_rng(6)
    if mode == "paged_prefix_shared":
        common = rng.integers(1, 256, 2 * PS).tolist()
        prompts = [common + rng.integers(1, 256, n).tolist() for n in (3, 60, 150)]
    else:
        prompts = [[5, 9, 100, 31, 7], list(range(40, 51)),
                   rng.integers(1, 256, 150).tolist(), rng.integers(1, 256, 200).tolist()]
    worst = max(serving.teacher_forced_errors(eng.params, cfg, prompts, 16, 512, mode=mode))
    bound = serving.SERVING_MODES[mode][1]
    if fault is None:
        assert worst < bound
    else:
        assert worst > bound
