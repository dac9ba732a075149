"""PyTorch port: 8-bit KV quantization, the dense 8-bit cache and attention
against it, checked against the JAX package.

Both packages get the same numpy-made inputs.  The JAX side runs its Pallas
kernel in interpret mode; the port runs on CPU tensors, so its wrapper takes
the plain version.  Quantized bytes and scales must be equal, not close:
the two packages round the same fp32 values the same way (int8: half to
even, then clip; fp8: the cast rounds to nearest even).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.kernels import quant as jax_quant
from flash_attention_metal_tpu.runtime import kv_cache as jax_kv
from flash_attention_metal_tpu_torch.kernels import quant
from flash_attention_metal_tpu_torch.runtime import kv_cache as kv

FORMATS = {
    "int8": (torch.int8, jnp.int8),
    "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
    "e5m2": (torch.float8_e5m2, jnp.float8_e5m2),
}
# Port (plain version) against the JAX kernel in interpret mode: fp32 q on
# the uniform(-1, 1) fixture differs by summation order only; bf16 q
# rounds P * s_v to bf16 in JAX (and the products run on bf16 operands),
# the plain version stays in fp32.
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the test workers share
    the host's cores, and each worker's idle intra-op threads spin on them
    (the engine tests ran ~100x slower beside five other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bytes(x) -> np.ndarray:
    """The stored bytes of an 8-bit tensor or array."""
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _kv_inputs(shape, seed=0):
    """Normal K and V with per-token magnitudes spread over 1e-3 .. 1e2, so
    the scales differ token to token."""
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.uniform(-3, 2, shape[:-1] + (1,))
    return [(rng.standard_normal(shape) * mags).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_quantize_kv_matches_jax(fmt, in_dtype):
    tdt, jdt = FORMATS[fmt]
    k, v = _kv_inputs((2, 2, 256, 64))
    tk, tv = (torch.from_numpy(x).to(in_dtype) for x in (k, v))
    # JAX gets the same (possibly bf16-rounded) values.
    jk, jv = (jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if in_dtype == torch.bfloat16 else jnp.float32) for x in (tk, tv))
    got = quant.quantize_kv(tk, tv, tdt)
    want = jax_quant.quantize_kv(jk, jv, dtype=jdt)
    for g, w in ((got.k_q, want.k_q), (got.v_q, want.v_q)):
        assert g.dtype == tdt
        np.testing.assert_array_equal(_bytes(g), _bytes(w))
    for g, w in ((got.k_scale, want.k_scale), (got.v_scale, want.v_scale)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(g.shape))
    # The absmax element lands on +-QMAX exactly (x / scale may round a hair
    # above it before the cast; both packages round it down to QMAX).
    qmax = quant._QMAX[tdt]
    idx = tk.float().abs().argmax(dim=-1, keepdim=True)
    at_max = got.k_q.float().gather(-1, idx).abs()
    assert torch.all(at_max == qmax)
    back_k, back_v = quant.dequantize_kv(got, torch.float32)
    jback_k, _ = jax_quant.dequantize_kv(want, jnp.float32)
    np.testing.assert_array_equal(back_k.numpy(), np.asarray(jback_k))
    assert back_v.shape == tv.shape


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_append_tokens_quant_matches_jax(fmt):
    """Quantized writes at each slot's write head, starts clamped at
    max_len like ``dynamic_update_slice``; the cache's bytes, scales and
    lengths equal JAX's."""
    tdt, jdt = FORMATS[fmt]
    lengths = np.asarray([0, 5, 127, 126], np.int32)  # 127, 126: clamped starts
    k_new, v_new = _kv_inputs((4, 2, 3, 64), seed=1)
    jc = jax_kv.init_quant_cache(2, 4, 2, 128, 64, dtype=jdt)
    jc = jax_kv.QuantKVCache(jc.k_q, jc.v_q, jc.k_scale, jc.v_scale, jnp.asarray(lengths))
    # Jitted, as JAX's serving steps run it (XLA's scale is absmax * (1 / QMAX)).
    append = jax.jit(jax_kv.append_tokens_quant, static_argnums=1)
    jc = append(jc, 1, jnp.asarray(k_new), jnp.asarray(v_new))
    tc = kv.init_quant_cache(2, 4, 2, 128, 64, dtype=tdt)
    assert tc.max_len == 128 and bool(torch.all(tc.k_scale == 1.0))
    tc.lengths.copy_(torch.from_numpy(lengths))
    tc = kv.append_tokens_quant(tc, 1, torch.from_numpy(k_new), torch.from_numpy(v_new))
    for name in ("k_q", "v_q"):
        np.testing.assert_array_equal(_bytes(getattr(tc, name)), _bytes(getattr(jc, name)))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
    tc = kv.bump_lengths(tc, 3, torch.tensor([True, False, True, False]))
    assert tc.lengths.tolist() == [3, 5, 130, 126]
    tc = kv.reset_slot(tc, 2)
    assert int(tc.lengths[2]) == 0


# (q shape, kv shape, causal, offsets (None: the default), pos_div, lse)
ATTN_CASES = {
    "non_causal_gqa": ((2, 4, 128, 64), (2, 2, 256, 64), False, None, 1, True),
    "causal_default_offset": ((2, 4, 128, 64), (2, 2, 256, 64), True, None, 1, True),
    "causal_ragged": ((2, 4, 128, 64), (2, 2, 256, 64), True, [0, 77], 1, True),
    "decode_fold2_ragged": ((3, 2, 8, 64), (3, 2, 256, 64), True, [0, 100, 251], 2, True),
    "decode_one_row": ((2, 4, 1, 64), (2, 2, 256, 64), True, [37, 255], 1, False),
    "causal_ragged_d128": ((2, 4, 128, 128), (2, 2, 256, 128), True, [0, 77], 1, True),
}


@pytest.mark.parametrize("fmt", ["int8", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_quant_matches_jax(case, dtype, fmt):
    shape_q, shape_kv, causal, offsets, pos_div, lse = ATTN_CASES[case]
    tdt, jdt = FORMATS[fmt]
    rng = np.random.default_rng(3)
    q = rng.uniform(-1, 1, shape_q).astype(np.float32)
    k = rng.uniform(-1, 1, shape_kv).astype(np.float32)
    v = rng.uniform(-1, 1, shape_kv).astype(np.float32)
    tq = torch.from_numpy(q).to(dtype)
    jq = jnp.asarray(tq.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    off_t = None if offsets is None else torch.tensor(offsets, dtype=torch.int32)
    off_j = None if offsets is None else jnp.asarray(offsets, jnp.int32)
    kw = dict(causal=causal, save_lse=lse, pos_div=pos_div)
    got = quant.flash_attention_quant(
        tq, quant.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), tdt), off_t, **kw)
    want = jax_quant.flash_attention_quant(
        jq, jax_quant.quantize_kv(jnp.asarray(k), jnp.asarray(v), dtype=jdt), off_j,
        interpret=True, **kw)
    if lse:
        (got, got_lse), (want, want_lse) = got, want
        assert got_lse.shape == tq.shape[:3] and got_lse.dtype == torch.float32
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0],
                                   atol=ATTN_TOL[dtype], rtol=0)
    assert got.dtype == dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=ATTN_TOL[dtype], rtol=0)
    assert quant.flash_attention_quant.launches == 0  # the CPU takes the plain version


# (case, window, sinks): windows that end mid-tile, sinks far left of them.
WINDOW_CASES = [("causal_ragged", 64, 0), ("causal_ragged", 100, 4),
                ("decode_fold2_ragged", 37, 70), ("decode_one_row", 1, 0),
                ("decode_one_row", 130, 3)]


@pytest.mark.parametrize("case,window,sinks", WINDOW_CASES)
def test_flash_attention_quant_window_matches_jax(case, window, sinks):
    """The sliding window with sinks on the 8-bit cache, against the JAX
    kernel in interpret mode (fp32 q, int8 cache), folded decode included."""
    shape_q, shape_kv, causal, offsets, pos_div, lse = ATTN_CASES[case]
    rng = np.random.default_rng(4)
    q = rng.uniform(-1, 1, shape_q).astype(np.float32)
    k = rng.uniform(-1, 1, shape_kv).astype(np.float32)
    v = rng.uniform(-1, 1, shape_kv).astype(np.float32)
    off = None if offsets is None else np.asarray(offsets, np.int32)
    kw = dict(causal=causal, save_lse=lse, pos_div=pos_div, window=window, sinks=sinks)
    got = quant.flash_attention_quant(
        torch.from_numpy(q), quant.quantize_kv(torch.from_numpy(k), torch.from_numpy(v)),
        None if off is None else torch.from_numpy(off), **kw)
    want = jax_quant.flash_attention_quant(
        jnp.asarray(q), jax_quant.quantize_kv(jnp.asarray(k), jnp.asarray(v)),
        None if off is None else jnp.asarray(off), interpret=True, **kw)
    if lse:
        (got, got_lse), (want, want_lse) = got, want
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0],
                                   atol=ATTN_TOL[torch.float32], rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL[torch.float32],
                               rtol=0)


def test_flash_attention_quant_rejects_unported():
    q = torch.zeros((1, 2, 8, 64))
    qkv = quant.quantize_kv(torch.ones((1, 2, 128, 64)), torch.ones((1, 2, 128, 64)))
    # ALiBi needs causal and the unfolded rows, as in JAX.
    with pytest.raises(ValueError, match="causal"):
        quant.flash_attention_quant(q, qkv, alibi_slopes=torch.ones(2))
    with pytest.raises(NotImplementedError, match="pos_div"):
        quant.flash_attention_quant(q[:, :1], quant.quantize_kv(*(torch.ones((1, 1, 128, 64)),) * 2),
                                    causal=True, pos_div=2, alibi_slopes=torch.ones(1))
    # The window and its sinks, the softcap and ALiBi are ported: the plain
    # route equals the oracle on the dequantized cache (sinks alone change
    # nothing, as in JAX).
    from flash_attention_metal_tpu_torch.reference.oracle import attention_reference

    rng = np.random.default_rng(0)
    qr = torch.from_numpy(rng.uniform(-1, 1, (1, 2, 8, 64)).astype(np.float32))
    kr, vr = (torch.from_numpy(rng.uniform(-1, 1, (1, 2, 128, 64)).astype(np.float32))
              for _ in range(2))
    qkv_r = quant.quantize_kv(kr, vr)
    kd, vd = quant.dequantize_kv(qkv_r, torch.float32)
    for kw in (dict(window=16), dict(window=16, sinks=4), dict(softcap=30.0),
               dict(alibi_slopes=torch.tensor([0.5, 0.25])),
               dict(softcap=0.5, alibi_slopes=torch.tensor([0.5, 0.25]), window=16)):
        got = quant.flash_attention_quant(qr, qkv_r, causal=True, **kw)
        want = attention_reference(qr, kd, vd, causal=True, **kw)
        assert float((got - want).abs().max()) < ATTN_TOL[torch.float32]
    assert torch.equal(quant.flash_attention_quant(qr, qkv_r, causal=True, sinks=4),
                       quant.flash_attention_quant(qr, qkv_r, causal=True))
    # A rolling cache's position map is ported: the identity map gives the
    # index-space result (tests/test_torch_rolling.py holds it against JAX).
    ident = torch.arange(128, dtype=torch.int32)[None]
    got = quant.flash_attention_quant(qr, qkv_r, None, ident, causal=True, window=16)
    want = quant.flash_attention_quant(qr, qkv_r, causal=True, window=16)
    assert float((got - want).abs().max()) < 1e-6
    with pytest.raises(NotImplementedError, match="causal"):
        quant.flash_attention_quant(q, qkv, pos_div=2)
    with pytest.raises(TypeError, match="scales must be fp32"):
        bad = quant.QuantizedKV(qkv.k_q, qkv.v_q, qkv.k_scale.double(), qkv.v_scale)
        quant.flash_attention_quant(q, bad, causal=True)


# (case, format, features): the softcap and ALiBi on the 8-bit cache (the
# transforms on the K-scaled score), composed with a window; folded decode
# takes the softcap alone (ALiBi needs the unfolded rows, as in JAX).
XF_CASES = [
    ("causal_ragged", "int8", dict(softcap=30.0, alibi="std")),
    ("causal_ragged", "e4m3", dict(softcap=0.5, alibi="std", window=40, sinks=4)),
    ("decode_one_row", "int8", dict(softcap=20.0, alibi="large")),
    ("decode_fold2_ragged", "int8", dict(softcap=0.5)),
    ("causal_ragged_d128", "int8", dict(softcap=30.0, alibi="std")),
]


def _slopes(kind, heads):
    std = np.asarray([2.0 ** (-8.0 * (i + 1) / heads) for i in range(heads)], np.float32)
    return std if kind == "std" else np.linspace(0.25, 1.0, heads).astype(np.float32)


@pytest.mark.parametrize("case,fmt,feats", XF_CASES)
def test_flash_attention_quant_xf_matches_jax(case, fmt, feats):
    """The score transforms on the 8-bit cache against the JAX kernel in
    interpret mode (fp32 q: summation order only, ``ATTN_TOL``)."""
    shape_q, shape_kv, causal, offsets, pos_div, lse = ATTN_CASES[case]
    tdt, jdt = FORMATS[fmt]
    rng = np.random.default_rng(6)
    q, k, v = (rng.uniform(-2, 2, s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv))
    off = None if offsets is None else np.asarray(offsets, np.int32)
    t_kw, j_kw = dict(feats), dict(feats)
    if "alibi" in feats:
        slopes = _slopes(t_kw.pop("alibi"), shape_q[1])
        j_kw.pop("alibi")
        t_kw["alibi_slopes"], j_kw["alibi_slopes"] = torch.from_numpy(slopes), jnp.asarray(slopes)
    kw = dict(causal=causal, save_lse=lse, pos_div=pos_div)
    got = quant.flash_attention_quant(
        torch.from_numpy(q), quant.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), tdt),
        None if off is None else torch.from_numpy(off), **kw, **t_kw)
    want = jax_quant.flash_attention_quant(
        jnp.asarray(q), jax_quant.quantize_kv(jnp.asarray(k), jnp.asarray(v), dtype=jdt),
        None if off is None else jnp.asarray(off), interpret=True, **kw, **j_kw)
    if lse:
        (got, got_lse), (want, want_lse) = got, want
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0],
                                   atol=ATTN_TOL[torch.float32], rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL[torch.float32],
                               rtol=0)
