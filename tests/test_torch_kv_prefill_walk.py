"""PyTorch port: the wgmma prefill of the 8-bit and paged KV caches on the CPU.

Every bf16 call of the quant, paged and paged-quant entries with more than
``DECODE_ROWS`` query rows and no row fold runs the wgmma forward from its
cache's KV source (``csrc/flash_kv_sm90.cu`` on ``flash_fwd_sm90.cuh``).
The CUDA kernel cannot run here; its arithmetic can: ``kv_prefill_walk_plain``
walks each 64-row Q tile over the kernel's 64-column KV tiles (the page
lookup of each with its clamps, the K scale on the fp32 scores, P times the
V scale rounded to bf16 before the PV product), and is held against the
JAX package's ``flash_attention_quant``, ``flash_attention_paged`` and
``flash_attention_paged_quant`` in interpret mode on the same numpy inputs
and 8-bit bytes, through shuffled page tables whose page 0 is NaN.  The
route rule is pinned as a pure function, and the wrappers' C arguments are
checked through a recorder (no card here).
"""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.kernels import paged as jax_paged
from flash_attention_metal_tpu.kernels import quant as jax_quant
from flash_attention_metal_tpu_torch.kernels import _build
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels import paged, quant

# The walk (fp32 products, P in bf16) against the JAX kernels in interpret
# mode: bf16 q rounds P * s_v and the products' operands in both; the
# remaining gap is summation order and the place of each rounding.
BF16_TOL = 1e-2
# fp32 q: the walk against the port's plain versions, order only.
FP32_TOL = 2e-5
FORMATS = {"int8": (torch.int8, jnp.int8), "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
           "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}
PS = 128  # page size (the JAX kernels' lane width)
BATCH, HEADS, KV_HEADS, N_KV = 2, 4, 2, 512
# Prefill chunks of 128 and 256 rows: each slot's offset (its length
# before the chunk), one at the cache's end, one partly filled.
OFFSETS = {128: (384, 150), 256: (256, 40)}
# The walks: the causal walk, a window whose sinks cover a tile and a
# part, the softcap with ALiBi (the capped ALiBi FlashLM's).
FEATURES = {
    "causal": {},
    "window": dict(window=100, sinks=70),
    "xf": dict(softcap=30.0, alibi=True),
}
# A rolling int8 cache (768 positions' worth of slots would be the serving
# engine's; 512 here): a slot that has wrapped and one that has not, each
# with a chunk of 128 rows ending at its newest token.
ROLL_TOTALS, ROLL_WINDOW, ROLL_SINKS = (900, 300), 256, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (the test workers share
    the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _slopes(heads: int) -> np.ndarray:
    """ALiBi's standard slopes 2^(-8 (h + 1) / H)."""
    return (2.0 ** (-8.0 * np.arange(1, heads + 1) / heads)).astype(np.float32)


def _kw(feats: dict) -> dict:
    """A case's features as keywords: the port's (torch slopes) and JAX's."""
    kw = {k: v for k, v in feats.items() if k != "alibi"}
    if feats.get("alibi"):
        return dict(kw, alibi_slopes=torch.from_numpy(_slopes(HEADS))), dict(
            kw, alibi_slopes=jnp.asarray(_slopes(HEADS)))
    return kw, kw


def _bytes(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.uint8).numpy()


def _jax8(x: torch.Tensor, jdt) -> jnp.ndarray:
    """An 8-bit tensor's bytes as the JAX array of the same format."""
    return jnp.asarray(_bytes(x)).view(jdt)


def _inputs(n_q: int, head_dim: int, seed: int):
    """bf16 q ``[B, H, n_q, D]`` and fp32 K/V ``[B, H_kv, N_KV, D]`` from a
    seed, uniform in (-1, 1); q x 4 (peaked scores)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (BATCH, HEADS, n_q, head_dim)).astype(np.float32) * 4.0
    k, v = (rng.uniform(-1, 1, (BATCH, KV_HEADS, N_KV, head_dim)).astype(np.float32)
            for _ in "kv")
    return torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(k), torch.from_numpy(v)


def _pages(n_q: int, offsets, seed: int):
    """A shuffled table ``[B, N_KV / PS]`` over ``1 + B N_KV / PS`` pages,
    never naming page 0, and that table with the entries past each slot's
    last visible page set to 0 (unallocated)."""
    rng = np.random.default_rng(seed)
    per = N_KV // PS
    full = (1 + rng.permutation(BATCH * per)).reshape(BATCH, per).astype(np.int32)
    live = (n_q - 1 + np.asarray(offsets)) // PS + 1
    table = np.where(np.arange(per)[None, :] < live[:, None], full, 0).astype(np.int32)
    return full, table, 1 + BATCH * per


def _pool(x: torch.Tensor, full: np.ndarray, n_pages: int) -> torch.Tensor:
    """``x [B, H, N, ...]`` laid into pages ``[n_pages, H, PS, ...]`` by the
    table; page 0 holds NaN (0x7F bytes for an 8-bit pool: NaN in e4m3 and
    e5m2, and the scale pool's page 0 is NaN for int8)."""
    raw = x.contiguous().view(torch.uint8) if x.element_size() == 1 else x
    b, h, n = raw.shape[:3]
    pool = torch.empty((n_pages, h, PS, *raw.shape[3:]), dtype=raw.dtype)
    pool[0] = 0x7F if x.element_size() == 1 else float("nan")
    pages = raw.reshape(b, h, n // PS, PS, *raw.shape[3:]).transpose(1, 2)
    pool[torch.from_numpy(full.reshape(-1)).long()] = pages.reshape(-1, h, PS, *raw.shape[3:])
    return pool.view(x.dtype) if x.element_size() == 1 else pool


def _rolling_positions(totals, n_slots: int, sinks: int) -> torch.Tensor:
    """int32 ``[B, n_slots]``: the position each slot of a rolling cache
    holds after ``totals[b]`` tokens (the sinks in their slots, the rest in
    a ring), -1 for a slot never written."""
    pos = torch.full((len(totals), n_slots), -1, dtype=torch.int32)
    ring = n_slots - sinks
    for b, total in enumerate(totals):
        for t in range(total):
            pos[b, t if t < sinks else sinks + (t - sinks) % ring] = t
    return pos


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=tol, rtol=0)


def _walk_quant(q, qkv, off, **kw):
    return quant.kv_prefill_walk_plain(
        q, qkv.k_q, qkv.v_q, off, sm_scale=q.shape[-1] ** -0.5, k_scale=qkv.k_scale,
        v_scale=qkv.v_scale, **kw)


# ---------------------------------------------------------------------------
# The walk against the JAX kernels in interpret mode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_quant_walk_matches_jax(fmt, head_dim, feat):
    n_q = 128 if head_dim == 64 else 256
    q, k, v = _inputs(n_q, head_dim, seed=head_dim + len(feat))
    qkv = quant.quantize_kv(k, v, FORMATS[fmt][0])
    off = torch.tensor(OFFSETS[n_q], dtype=torch.int32)
    kw, jkw = _kw(FEATURES[feat])
    o, lse = _walk_quant(q, qkv, off, **kw)
    jdt = FORMATS[fmt][1]
    jqkv = jax_quant.QuantizedKV(
        _jax8(qkv.k_q, jdt), _jax8(qkv.v_q, jdt),
        *(jnp.asarray(s.numpy().reshape(BATCH, KV_HEADS, N_KV // 128, 128))
          for s in (qkv.k_scale, qkv.v_scale)))
    want_o, want_lse = jax_quant.flash_attention_quant(
        jnp.asarray(q.float().numpy()).astype(jnp.bfloat16), jqkv, jnp.asarray(off.numpy()),
        causal=True, save_lse=True, interpret=True, **jkw)
    _close(o.float().numpy(), np.asarray(want_o.astype(jnp.float32)), BF16_TOL)
    _close(lse.numpy(), np.asarray(want_lse)[..., 0], BF16_TOL)


@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("head_dim", [64, 128])
def test_paged_walk_matches_jax(head_dim, feat):
    n_q = 128 if head_dim == 64 else 256
    q, k, v = _inputs(n_q, head_dim, seed=10 + head_dim + len(feat))
    offsets = OFFSETS[n_q]
    full, table, n_pages = _pages(n_q, offsets, seed=head_dim)
    pool_k, pool_v = (_pool(x.to(torch.bfloat16), full, n_pages) for x in (k, v))
    t_table, lengths = torch.from_numpy(table), torch.tensor(offsets, dtype=torch.int32)
    kw, jkw = _kw(FEATURES[feat])
    o, _ = quant.kv_prefill_walk_plain(q, pool_k, pool_v, lengths, sm_scale=head_dim ** -0.5,
                                       page_table=t_table, **kw)
    want = jax_paged.flash_attention_paged(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, pool_k, pool_v)),
        jnp.asarray(table), jnp.asarray(lengths.numpy()), interpret=True, **jkw)
    _close(o.float().numpy(), np.asarray(want.astype(jnp.float32)), BF16_TOL)


@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_paged_quant_walk_matches_jax(fmt, head_dim, feat):
    n_q = 128 if head_dim == 64 else 256
    q, k, v = _inputs(n_q, head_dim, seed=20 + head_dim + len(feat))
    offsets = OFFSETS[n_q]
    full, table, n_pages = _pages(n_q, offsets, seed=head_dim + 1)
    qkv = quant.quantize_kv(k, v, FORMATS[fmt][0])
    pools = [_pool(x, full, n_pages) for x in (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)]
    t_table, lengths = torch.from_numpy(table), torch.tensor(offsets, dtype=torch.int32)
    kw, jkw = _kw(FEATURES[feat])
    o, _ = quant.kv_prefill_walk_plain(q, pools[0], pools[1], lengths,
                                       sm_scale=head_dim ** -0.5, k_scale=pools[2],
                                       v_scale=pools[3], page_table=t_table, **kw)
    jdt = FORMATS[fmt][1]
    want = jax_paged.flash_attention_paged_quant(
        jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
        *(_jax8(p, jdt) for p in pools[:2]), *(jnp.asarray(p.numpy()) for p in pools[2:]),
        jnp.asarray(table), jnp.asarray(lengths.numpy()), interpret=True, **jkw)
    _close(o.float().numpy(), np.asarray(want.astype(jnp.float32)), BF16_TOL)


@pytest.mark.parametrize("feat", ["window", "xf"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_rolling_int8_walk_matches_jax(head_dim, feat):
    """A wrapped rolling int8 cache (slot order is not position order): the
    position walk visits every tile and tests each slot's position."""
    n_q = 128
    q, k, v = _inputs(n_q, head_dim, seed=30 + head_dim)
    qkv = quant.quantize_kv(k, v, torch.int8)
    pos = _rolling_positions(ROLL_TOTALS, N_KV, ROLL_SINKS)
    off = torch.tensor([t - n_q for t in ROLL_TOTALS], dtype=torch.int32)
    feats = dict(window=ROLL_WINDOW, sinks=ROLL_SINKS)
    if feat == "xf":
        feats.update(softcap=30.0, alibi=True)
    kw, jkw = _kw(feats)
    o, lse = _walk_quant(q, qkv, off, kv_positions=pos, **kw)
    jqkv = jax_quant.QuantizedKV(
        _jax8(qkv.k_q, jnp.int8), _jax8(qkv.v_q, jnp.int8),
        *(jnp.asarray(s.numpy().reshape(BATCH, KV_HEADS, N_KV // 128, 128))
          for s in (qkv.k_scale, qkv.v_scale)))
    want_o, want_lse = jax_quant.flash_attention_quant(
        jnp.asarray(q.float().numpy()).astype(jnp.bfloat16), jqkv, jnp.asarray(off.numpy()),
        jnp.asarray(pos.numpy()), causal=True, save_lse=True, interpret=True, **jkw)
    _close(o.float().numpy(), np.asarray(want_o.astype(jnp.float32)), BF16_TOL)
    _close(lse.numpy(), np.asarray(want_lse)[..., 0], BF16_TOL)


# ---------------------------------------------------------------------------
# The walk against the port's plain versions (fp32 q: order only).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("fmt", ["int8", "e5m2"])
def test_walk_equals_the_plain_versions_in_fp32(fmt, feat):
    """In fp32 the walk is the wrappers' plain versions (two-pass, over the
    gathered pages) to rounding: it visits every visible tile, reads each
    page where the table points, and scales as the contract says."""
    n_q = 128
    q, k, v = _inputs(n_q, 64, seed=40 + len(feat))
    q = q.float()
    offsets = OFFSETS[n_q]
    off = torch.tensor(offsets, dtype=torch.int32)
    kw, _ = _kw(FEATURES[feat])
    qkv = quant.quantize_kv(k, v, FORMATS[fmt][0])
    o, lse = _walk_quant(q, qkv, off, **kw)
    want_o, want_lse = quant.flash_attention_quant(q, qkv, off, causal=True, save_lse=True, **kw)
    _close(o.numpy(), want_o.numpy(), FP32_TOL)
    _close(lse.numpy(), want_lse.numpy(), FP32_TOL)
    full, table, n_pages = _pages(n_q, offsets, seed=3)
    pools = [_pool(x, full, n_pages) for x in (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)]
    o, _ = quant.kv_prefill_walk_plain(q, pools[0], pools[1], off, sm_scale=0.125,
                                       k_scale=pools[2], v_scale=pools[3],
                                       page_table=torch.from_numpy(table), **kw)
    want = paged.flash_attention_paged_quant(q, *pools, torch.from_numpy(table), off, **kw)
    _close(o.numpy(), want.numpy(), FP32_TOL)


def test_walk_rows_that_see_nothing_give_zero_and_minus_inf():
    """A row whose window holds no column and whose sinks are 0 (offsets
    far below 0 see nothing): o = 0, lse = -inf, as the kernel writes."""
    q, k, v = _inputs(128, 64, seed=50)
    qkv = quant.quantize_kv(k, v, torch.int8)
    off = torch.tensor([-100, 0], dtype=torch.int32)
    o, lse = _walk_quant(q, qkv, off)
    assert torch.all(o[0, :, :100] == 0) and torch.all(torch.isneginf(lse[0, :, :100]))
    assert torch.all(torch.isfinite(lse[0, :, 100:])) and torch.all(torch.isfinite(lse[1]))


@pytest.mark.parametrize("n_kv,p_lo,p_hi,window,sinks", [
    (2048, 512, 575, None, 0), (2048, 512, 575, 100, 4), (2048, 0, 63, 512, 70),
    (2048, 1000, 1063, 512, 70), (512, 384, 511, 100, 70), (300, 0, 400, None, 0),
    (100, -100, -37, None, 0), (2048, 1900, 1963, 64, 130),
])
def test_walk_tiles_cover_every_visible_column(n_kv, p_lo, p_hi, window, sinks):
    """The walk's tiles (window.cuh::kv_runs) hold every column a row of the
    tile may see, once each, in order, and no tile wholly outside both."""
    tiles = ff.walk_tiles(p_lo, p_hi, n_kv, window, sinks)
    assert tiles == sorted(set(tiles))
    pos = torch.arange(p_lo, p_hi + 1)[:, None]
    col = torch.arange(n_kv)[None, :]
    seen = col <= pos
    if window is not None:
        seen = seen & ((col > pos - window) | (col < sinks))
    needed = sorted(set((col.expand_as(seen)[seen] // ff.KV_TILE).tolist()))
    assert tiles == needed


# ---------------------------------------------------------------------------
# The route rule and the wrappers' arguments.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,n_q,pos_div,route", [
    (torch.bfloat16, 512, 1, "wgmma"), (torch.bfloat16, 128, 1, "wgmma"),
    (torch.bfloat16, 17, 1, "wgmma"), (torch.bfloat16, 16, 1, "decode"),
    (torch.bfloat16, 1, 1, "decode"), (torch.bfloat16, 2, 2, "decode"),
    (torch.bfloat16, 16, 8, "decode"), (torch.bfloat16, 18, 2, "fold"),
    (torch.bfloat16, 256, 2, "fold"), (torch.float32, 512, 1, "template"),
    (torch.float32, 17, 1, "template"), (torch.float32, 16, 1, "decode"),
])
def test_route_rule(dtype, n_q, pos_div, route):
    assert quant.kv_route(dtype, n_q, pos_div) == route


def test_route_rule_is_the_c_launchers():
    """The rule's constants and condition are csrc/flash_fwd.cu::launch's:
    decode first (n_q <= kDecodeRows), then bf16 over an 8-bit or paged
    cache with pos_div 1 to flash_kv_sm90.cu, then bf16 folded (pos_div >
    1) over every cache to flash_fold_sm90.cu, before the template's
    branches; and each route's kernel is a __global__ of its source (the
    folded route's on its own walk, a struct of that source)."""
    fwd = (_build.CSRC / "flash_fwd.cu").read_text()
    tiles = (_build.CSRC / "kv_tiles.cuh").read_text()
    assert f"constexpr int kDecodeRows = {ff.DECODE_ROWS};" in tiles
    body = fwd[fwd.index("cudaError_t launch(const void* q, const KvArgs& kv"):]
    body = body[:body.index("\n}\n")]
    decode = body.index("if (n_q <= kDecodeRows && f.q_seg == nullptr)")
    wgmma = body.index("if (pos_div == 1 && n_q > kDecodeRows && f.q_seg == nullptr && "
                       "!f.drop.on())")
    guard = body.index("std::is_same<T, bf16>::value && (kPaged || !std::is_same<KV, T>::value)")
    fold_guard = body.index("if constexpr (std::is_same<T, bf16>::value) {")
    fold = body.index("if (pos_div > 1 && n_q > kDecodeRows) {")
    template = body.index("if (f.kv_pos != nullptr)")
    assert decode < guard < wgmma < fold_guard < fold < template
    assert "fam::flash_kv_sm90(call, kv_code<KV>(), D, kPaged)" in body
    assert "fam::flash_fold_sm90(call, kv_code<KV>(), D, kPaged)" in body
    for route, stem in quant.KV_ROUTE_KERNELS.items():
        source = {"decode": "flash_decode.cuh", "wgmma": "flash_fwd_sm90.cuh",
                  "fold": "flash_fwd_sm90.cuh", "template": "flash_fwd.cu"}[route]
        text = (_build.CSRC / source).read_text()
        assert re.search(r"__global__ void __launch_bounds__\([^)]*\)\s+" + stem + r"\(", text)
    for route, walk in quant.KV_ROUTE_WALKS.items():
        assert f"struct {walk} {{" in (_build.CSRC / "flash_fwd_sm90.cuh").read_text()
        assert f"{walk}<" in (_build.CSRC / "flash_fold_sm90.cu").read_text()


def _recorder(monkeypatch, module, names):
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    monkeypatch.setattr(module, "_lib", lambda: SimpleNamespace(**{n: entry(n) for n in names}))
    monkeypatch.setattr(ff, "_cuda_args", lambda q: (0, 132))
    monkeypatch.setattr(ff, "_TICKETS", {})
    return calls


def _named(name: str, args: tuple) -> dict:
    """A recorded call's arguments by the C entry's parameter names."""
    text = (_build.CSRC / "flash_fwd.cu").read_text()
    sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)", text, re.S).group(1)
    names = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    assert len(names) == len(args)
    return dict(zip(names, args))


def _keep_counts(monkeypatch, *wrappers):
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", fn.launches)
        monkeypatch.setattr(fn, "grid", fn.grid)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_quant_prefill_passes_what_routes_it_to_wgmma(monkeypatch, fmt):
    """The serving prefill chunk (q [1,16,512,64] over [1,8,2048,64]) passes
    bf16 (dtype 0), the format's code, pos_div 1, its 512 rows and one
    split over the whole row (no workspace): the C entry's wgmma route."""
    calls = _recorder(monkeypatch, quant, ["fam_flash_quant"])
    _keep_counts(monkeypatch, quant.flash_attention_quant)
    q = torch.zeros((1, 16, 512, 64), dtype=torch.bfloat16)
    qkv = quant.quantize_kv(torch.zeros(1, 8, 2048, 64), torch.zeros(1, 8, 2048, 64),
                            FORMATS[fmt][0])
    off = torch.tensor([512], dtype=torch.int32)
    quant._launch_quant(q, qkv, off, sm_scale=0.125, causal=True, pos_div=1, save_lse=True,
                        window=512, sinks=4)
    (name, args), = calls
    a = _named(name, args)
    assert (a["dtype"], a["kv_dtype"], a["pos_div"], a["n_q"]) == (0, quant.KV_CODES[
        FORMATS[fmt][0]], 1, 512)
    assert (a["window"], a["sinks"], a["causal"]) == (512, 4, 1)
    assert a["kv_chunk"] >= 2048 and a["part"] is None and a["tickets"] is None
    assert a["lse"] is not None and a["kv_pos"] is None
    assert quant.kv_route(q.dtype, a["n_q"], a["pos_div"]) == "wgmma"


def test_paged_prefill_passes_what_routes_it_to_wgmma(monkeypatch):
    calls = _recorder(monkeypatch, paged, ["fam_flash_paged", "fam_flash_paged_quant"])
    _keep_counts(monkeypatch, paged.flash_attention_paged, paged.flash_attention_paged_quant)
    q = torch.zeros((2, 16, 128, 128), dtype=torch.bfloat16)
    pool = torch.zeros((9, 8, 128, 128), dtype=torch.bfloat16)
    qpool = quant.quantize_kv(pool.float(), pool.float(), torch.float8_e5m2)
    table = torch.zeros((2, 4), dtype=torch.int32)
    lengths = torch.tensor([0, 300], dtype=torch.int32)
    paged._launch_paged(q, pool, pool, table, lengths, sm_scale=0.125, pos_div=1)
    paged._launch_paged_quant(q, qpool.k_q, qpool.v_q, qpool.k_scale, qpool.v_scale, table,
                              lengths, sm_scale=0.125, pos_div=1, softcap=30.0)
    (n1, a1), (n2, a2) = calls
    a1, a2 = _named(n1, a1), _named(n2, a2)
    for a in (a1, a2):
        assert (a["dtype"], a["pos_div"], a["n_q"], a["head_dim"]) == (0, 1, 128, 128)
        assert a["kv_chunk"] >= 4 * 128 and a["part"] is None and a["tickets"] is None
        assert (a["n_pages"], a["page_size"], a["max_pages"]) == (9, 128, 4)
    assert a2["kv_dtype"] == 3 and a2["softcap"] == 30.0
    assert quant.kv_route(q.dtype, 128, 1) == "wgmma"
