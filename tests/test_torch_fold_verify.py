"""PyTorch port: GQA-folded verify windows (17-128 rows) on the CPU, and the
last public entry points (``mha``, the serving CLI, ``train_bench --softcap``).

On the card, every bf16 call of the dense, quant, paged and paged-quant
entries folded by GQA (``pos_div > 1``) with more than ``DECODE_ROWS`` rows
runs the wgmma forward's split-KV folded grid (``csrc/flash_fold_sm90.cu``).
The CUDA kernel cannot run here; what surrounds it can:

* the wrappers' folded calls (their plain versions on the CPU) against the
  JAX package's ``flash_attention_fwd``, ``flash_attention_quant``,
  ``flash_attention_paged`` and ``flash_attention_paged_quant`` in
  interpret mode, on the same numpy inputs and 8-bit bytes, with ragged
  lengths, a window with sinks and the softcap, through shuffled page
  tables whose page 0 is NaN;
* the grid's plan in plain Python (``flash_fwd.fold_walk``), held by
  ``hypothesis`` to visit every visible (row, column) pair in exactly one
  split, to call a tile full only when every pair of it is visible, and to
  give partials that merge to the plain version;
* speculative serving at group 8 (8 q-heads over 1 KV head, gamma 4: 40
  folded rows a verify call) against JAX's engine and the port's plain
  engine, and the route rule and the C arguments of a folded call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import flash_attention_metal_tpu as jax_fam
from flash_attention_metal_tpu.kernels import flash_fwd as jax_ff
from flash_attention_metal_tpu.kernels import paged as jax_paged
from flash_attention_metal_tpu.kernels import quant as jax_quant
from flash_attention_metal_tpu.models import transformer as jax_tf
from flash_attention_metal_tpu.runtime import engine as jax_eng
from flash_attention_metal_tpu_torch import mha
from flash_attention_metal_tpu_torch.harness import serving, train_bench
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels import paged, quant
from flash_attention_metal_tpu_torch.models import ModelConfig, params_from_jax
from flash_attention_metal_tpu_torch.runtime import engine as eng_mod

BF16_TOL, FP32_TOL = 1e-2, 2e-5
PS = 128  # page size (the JAX kernels' lane width)
BATCH, KV_HEADS, N_KV = 2, 2, 512
# Verify windows: (rows, pos_div) = group 2 at gamma 8, group 3 at gamma 6
# (a position's rows straddle a 64-row tile edge), group 8 at gamma 4 and 15.
SHAPES = ((18, 2), (21, 3), (40, 8), (128, 8))
FORMATS = {"int8": (torch.int8, jnp.int8), "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
FEATURES = {"causal": {}, "window": dict(window=100, sinks=70), "softcap": dict(softcap=30.0)}
# Each entry's cases (shape, head dim, features[, format]): every shape and
# head dim, the window and the softcap, within the module's ~20 JAX calls.
FWD_CASES = [((18, 2), 64, "causal"), ((21, 3), 64, "window"), ((40, 8), 64, "softcap"),
             ((128, 8), 64, "causal"), ((40, 8), 128, "causal"), ((21, 3), 128, "softcap")]
QUANT_CASES = [((18, 2), 64, "window", "int8"), ((40, 8), 64, "causal", "e4m3"),
               ((128, 8), 128, "softcap", "int8"), ((21, 3), 128, "causal", "e4m3")]
PAGED_CASES = [((21, 3), 64, "causal"), ((40, 8), 128, "window"), ((128, 8), 64, "softcap")]
PAGED_QUANT_CASES = [((40, 8), 64, "window", "int8"), ((18, 2), 128, "softcap", "e4m3"),
                     ((128, 8), 64, "causal", "int8")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (the test workers share
    the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lengths(n_q: int, pos_div: int) -> np.ndarray:
    """Ragged slot lengths: 0 and the full cache (the window's last position
    at N_KV - 1)."""
    return np.array([0, N_KV - -(-n_q // pos_div)], dtype=np.int32)


def _inputs(n_q: int, head_dim: int, seed: int):
    """bf16 q ``[B, H_kv, n_q, D]`` (folded rows) and fp32 K/V ``[B, H_kv,
    N_KV, D]``, uniform in (-1, 1); q x 4 (peaked scores)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (BATCH, KV_HEADS, n_q, head_dim)).astype(np.float32) * 4.0
    k, v = (rng.uniform(-1, 1, (BATCH, KV_HEADS, N_KV, head_dim)).astype(np.float32)
            for _ in "kv")
    return torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(k), torch.from_numpy(v)


def _pages(lengths: np.ndarray, n_q: int, pos_div: int, seed: int):
    """A shuffled table ``[B, N_KV / PS]`` over ``1 + B N_KV / PS`` pages
    (never page 0), with the entries past each slot's last visible page 0."""
    rng = np.random.default_rng(seed)
    per = N_KV // PS
    full = (1 + rng.permutation(BATCH * per)).reshape(BATCH, per).astype(np.int32)
    live = ((n_q - 1) // pos_div + lengths) // PS + 1
    table = np.where(np.arange(per)[None, :] < live[:, None], full, 0).astype(np.int32)
    return full, table, 1 + BATCH * per


def _pool(x: torch.Tensor, full: np.ndarray, n_pages: int) -> torch.Tensor:
    """``x [B, H, N, ...]`` laid into pages ``[n_pages, H, PS, ...]`` by the
    table; page 0 holds NaN (0x7F bytes for an 8-bit pool)."""
    raw = x.contiguous().view(torch.uint8) if x.element_size() == 1 else x
    b, h, n = raw.shape[:3]
    pool = torch.empty((n_pages, h, PS, *raw.shape[3:]), dtype=raw.dtype)
    pool[0] = 0x7F if x.element_size() == 1 else float("nan")
    pages = raw.reshape(b, h, n // PS, PS, *raw.shape[3:]).transpose(1, 2)
    pool[torch.from_numpy(full.reshape(-1)).long()] = pages.reshape(-1, h, PS, *raw.shape[3:])
    return pool.view(x.dtype) if x.element_size() == 1 else pool


def _j(x: torch.Tensor):
    """A torch tensor as the JAX array of the same values (8-bit: the same
    bytes; bf16 through fp32)."""
    if x.element_size() == 1:
        jdt = {torch.int8: jnp.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn}[x.dtype]
        return jnp.asarray(x.contiguous().view(torch.uint8).numpy()).view(jdt)
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=tol, rtol=0)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# The wrappers' folded calls against the JAX kernels in interpret mode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,head_dim,feat", FWD_CASES)
def test_fwd_fold_matches_jax(shape, head_dim, feat):
    n_q, pos_div = shape
    q, k, v = _inputs(n_q, head_dim, seed=n_q + head_dim)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    off = torch.from_numpy(_lengths(n_q, pos_div))
    kw = FEATURES[feat]
    o, lse = ff.flash_attention_fwd(q, k, v, off, causal=True, pos_div=pos_div, save_lse=True,
                                    **kw)
    want_o, want_lse = jax_ff.flash_attention_fwd(
        _j(q), _j(k), _j(v), jnp.asarray(off.numpy()), causal=True, pos_div=pos_div,
        save_lse=True, interpret=True, **kw)
    _close(o.float().numpy(), _f32(want_o), BF16_TOL)
    _close(lse.numpy(), np.asarray(want_lse)[..., 0], BF16_TOL)


@pytest.mark.parametrize("shape", [(18, 2), (40, 8)])
def test_fwd_fold_fp32_matches_jax(shape):
    """fp32 q (the template's calls on the card) at the fp32 tolerance."""
    n_q, pos_div = shape
    q, k, v = _inputs(n_q, 64, seed=7 + n_q)
    q = q.float() / 4.0
    off = torch.from_numpy(_lengths(n_q, pos_div))
    o = ff.flash_attention_fwd(q, k, v, off, causal=True, pos_div=pos_div, window=100, sinks=4)
    want = jax_ff.flash_attention_fwd(_j(q), _j(k), _j(v), jnp.asarray(off.numpy()), causal=True,
                                      pos_div=pos_div, window=100, sinks=4, interpret=True)
    _close(o.numpy(), np.asarray(want), FP32_TOL)


@pytest.mark.parametrize("shape,head_dim,feat,fmt", QUANT_CASES)
def test_quant_fold_matches_jax(shape, head_dim, feat, fmt):
    n_q, pos_div = shape
    q, k, v = _inputs(n_q, head_dim, seed=100 + n_q + head_dim)
    qkv = quant.quantize_kv(k, v, FORMATS[fmt][0])
    off = torch.from_numpy(_lengths(n_q, pos_div))
    kw = FEATURES[feat]
    o, lse = quant.flash_attention_quant(q, qkv, off, causal=True, pos_div=pos_div, save_lse=True,
                                         **kw)
    jqkv = jax_quant.QuantizedKV(
        _j(qkv.k_q), _j(qkv.v_q),
        *(jnp.asarray(s.numpy().reshape(BATCH, KV_HEADS, N_KV // 128, 128))
          for s in (qkv.k_scale, qkv.v_scale)))
    want_o, want_lse = jax_quant.flash_attention_quant(
        _j(q), jqkv, jnp.asarray(off.numpy()), causal=True, pos_div=pos_div, save_lse=True,
        interpret=True, **kw)
    _close(o.float().numpy(), _f32(want_o), BF16_TOL)
    _close(lse.numpy(), np.asarray(want_lse)[..., 0], BF16_TOL)


@pytest.mark.parametrize("shape,head_dim,feat", PAGED_CASES)
def test_paged_fold_matches_jax(shape, head_dim, feat):
    n_q, pos_div = shape
    q, k, v = _inputs(n_q, head_dim, seed=200 + n_q + head_dim)
    lengths = _lengths(n_q, pos_div)
    full, table, n_pages = _pages(lengths, n_q, pos_div, seed=head_dim)
    pool_k, pool_v = (_pool(x.to(torch.bfloat16), full, n_pages) for x in (k, v))
    kw = FEATURES[feat]
    o = paged.flash_attention_paged(q, pool_k, pool_v, torch.from_numpy(table),
                                    torch.from_numpy(lengths), pos_div=pos_div, **kw)
    want = jax_paged.flash_attention_paged(
        _j(q), _j(pool_k), _j(pool_v), jnp.asarray(table), jnp.asarray(lengths),
        pos_div=pos_div, interpret=True, **kw)
    _close(o.float().numpy(), _f32(want), BF16_TOL)


@pytest.mark.parametrize("shape,head_dim,feat,fmt", PAGED_QUANT_CASES)
def test_paged_quant_fold_matches_jax(shape, head_dim, feat, fmt):
    n_q, pos_div = shape
    q, k, v = _inputs(n_q, head_dim, seed=300 + n_q + head_dim)
    lengths = _lengths(n_q, pos_div)
    full, table, n_pages = _pages(lengths, n_q, pos_div, seed=head_dim + 1)
    qkv = quant.quantize_kv(k, v, FORMATS[fmt][0])
    pools = [_pool(x, full, n_pages) for x in (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)]
    kw = FEATURES[feat]
    o = paged.flash_attention_paged_quant(q, *pools, torch.from_numpy(table),
                                          torch.from_numpy(lengths), pos_div=pos_div, **kw)
    want = jax_paged.flash_attention_paged_quant(
        _j(q), *(_j(p) for p in pools), jnp.asarray(table), jnp.asarray(lengths),
        pos_div=pos_div, interpret=True, **kw)
    _close(o.float().numpy(), _f32(want), BF16_TOL)


# ---------------------------------------------------------------------------
# The folded grid's plan and merge in plain Python.
# ---------------------------------------------------------------------------

def _visible(n_q, pos_div, off, n_kv, window, sinks) -> np.ndarray:
    """``[n_q, n_kv]``: row r at position r // pos_div + off sees column c."""
    pos = np.arange(n_q)[:, None] // pos_div + off
    col = np.arange(n_kv)[None, :]
    seen = col <= pos
    if window is not None:
        seen &= (col > pos - window) | (col < sinks)
    return seen


@st.composite
def _grids(draw):
    n_q = draw(st.integers(17, 128))
    pos_div = draw(st.integers(2, 8))
    n_kv = draw(st.integers(1, 12)) * 64 - draw(st.integers(0, 63))
    off = draw(st.integers(-n_q // pos_div - 5, n_kv))
    chunk = draw(st.integers(1, 6)) * 64
    window = draw(st.one_of(st.none(), st.integers(1, 600)))
    sinks = draw(st.integers(0, 150)) if window is not None else 0
    return n_q, pos_div, off, n_kv, chunk, window, sinks


@settings(max_examples=60, deadline=None, database=None)
@given(_grids())
def test_fold_plan_visits_every_visible_pair_once(grid):
    """Each visible (row, column) pair lies in exactly one step of the
    blocks of its row's q tile (one split), and a tile the plan calls full
    holds only pairs every valid row of the q tile sees."""
    n_q, pos_div, off, n_kv, chunk, window, sinks = grid
    plan = ff.fold_walk(n_q, pos_div, off, n_kv, chunk, window, sinks)
    seen = _visible(n_q, pos_div, off, n_kv, window, sinks)
    visits = np.zeros((n_q, n_kv), dtype=np.int64)
    for (tile, _), steps in plan.items():
        rows = slice(tile * 64, min(n_q, tile * 64 + 64))
        for t, full in steps:
            cols = slice(t * 64, min(n_kv, t * 64 + 64))
            visits[rows, cols] += 1
            if full:
                assert seen[rows, cols].all(), (tile, t)
    assert np.all(visits[seen] == 1)
    assert np.all(visits <= 1)


def _plan_partials(q, k, v, off, plan, n_splits, pos_div, window, sinks, sm_scale):
    """One (q-head, batch)'s partials by the plan: split s's rows see the
    visible columns of the tiles its blocks walk (fp64)."""
    n_q, n_kv = q.shape[0], k.shape[0]
    seen = _visible(n_q, pos_div, off, n_kv, window, sinks)
    s = (q @ k.T) * sm_scale
    o_s = np.zeros((n_splits, n_q, q.shape[1]))
    m_s = np.full((n_splits, n_q), -np.inf)
    l_s = np.zeros((n_splits, n_q))
    for (tile, split), steps in plan.items():
        rows = np.arange(tile * 64, min(n_q, tile * 64 + 64))
        walked = np.zeros(n_kv, dtype=bool)
        for t, _ in steps:
            walked[t * 64:(t + 1) * 64] = True
        mask = seen[rows] & walked[None, :]
        if not mask.any():
            continue
        x = np.where(mask, s[rows], -np.inf)
        m = x.max(axis=1)
        p = np.where(mask, np.exp(x - np.where(np.isinf(m), 0, m)[:, None]), 0.0)
        m_s[split, rows], l_s[split, rows] = m, p.sum(axis=1)
        o_s[split, rows] = p @ v
    return o_s, m_s, l_s


@settings(max_examples=30, deadline=None, database=None)
@given(_grids(), st.integers(0, 2 ** 16))
def test_fold_plan_partials_merge_to_the_plain_version(grid, seed):
    """The plan's partials: a split that walks no tile of a row is an empty
    partial (m = -inf, l = 0, o = 0), and so is every split whose columns
    the row does not see (``split_partials_plain``); merged in split order
    (``merge_splits_plain``) they give the plain version's o and lse."""
    n_q, pos_div, off, n_kv, chunk, window, sinks = grid
    rng = np.random.default_rng(seed)
    q, k, v = (rng.uniform(-1, 1, (n, 16)) for n in (n_q, n_kv, n_kv))
    plan = ff.fold_walk(n_q, pos_div, off, n_kv, chunk, window, sinks)
    n_splits = ff.kv_splits(n_kv, chunk)
    o_s, m_s, l_s = _plan_partials(q, k, v, off, plan, n_splits, pos_div, window, sinks, 0.25)
    t = [torch.from_numpy(x)[None, None] for x in (q, k, v)]
    offs = torch.tensor([off], dtype=torch.int32)
    kw = dict(sm_scale=0.25, causal=True, pos_div=pos_div, window=window, sinks=sinks)
    want_o, want_m, want_l = ff.split_partials_plain(*t, offs, chunk, **kw)
    assert np.array_equal(np.isinf(m_s), np.isinf(want_m[:, 0, 0].numpy()))
    assert np.all(l_s[np.isinf(m_s)] == 0) and np.all(o_s[np.isinf(m_s)] == 0)
    o, lse = ff.merge_splits_plain(*(torch.from_numpy(x)[:, None, None] for x in (o_s, m_s, l_s)),
                                   dtype=torch.float64)
    plain_o, plain_lse = ff.flash_attention_fwd_plain(*(x.double() for x in t), offs,
                                                      save_lse=True, **kw)
    _close(o[0, 0].numpy(), plain_o[0, 0].numpy(), FP32_TOL)  # the plain scores are fp32
    _close(lse[0, 0].numpy(), plain_lse[0, 0].numpy(), FP32_TOL)


# ---------------------------------------------------------------------------
# The route and the wrappers' C arguments.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,n_q,pos_div,route", [
    (torch.bfloat16, 17, 2, "fold"), (torch.bfloat16, 40, 8, "fold"),
    (torch.bfloat16, 128, 8, "fold"), (torch.bfloat16, 16, 8, "decode"),
    (torch.float32, 40, 8, "template"), (torch.bfloat16, 40, 1, "wgmma"),
])
def test_fold_route_rule(dtype, n_q, pos_div, route):
    assert quant.kv_route(dtype, n_q, pos_div) == route
    assert ff.folds(dtype, n_q, pos_div) == (route == "fold")


@pytest.mark.parametrize("slots,chunk,splits", [(1, 256, 8), (8, 256, 8), (32, 704, 3),
                                                (64, 1024, 2), (128, 2048, 1)])
def test_fold_split_rule_at_tinyllamas_verify(slots, chunk, splits):
    """TinyLlama's verify window (40 rows over 4 KV heads, 2048 slots) on
    132 SMs: at least MIN_CHUNK_TILES tiles a chunk, cut finer until the
    grid has FOLD_BLOCKS_PER_SM blocks an SM; a grid that already has them
    takes one chunk (no merge)."""
    assert ff.decode_kv_chunk(slots, 4, 40, 2048, 132, True) == chunk
    assert ff.kv_splits(2048, chunk) == splits
    assert ff.decode_kv_chunk(slots, 4, 40, 2048, 132) == 2048  # unfolded: no split


def test_folded_launch_passes_the_split_and_tickets(monkeypatch):
    """A batch-1 verify call (q [1, 4, 40, 64] bf16, pos_div 8) takes the
    rule's chunk, a workspace for its 40 rows and tickets for every (q
    tile, KV head); the grid is (q tile x split, head, batch).  fp32 and
    unfolded calls keep one chunk and no workspace."""
    monkeypatch.setattr(ff, "_cuda_args", lambda q: (0, 132))
    monkeypatch.setattr(ff, "_TICKETS", {})
    q = torch.zeros((1, 4, 40, 64), dtype=torch.bfloat16)
    grid, part, tickets, _ = ff.split_args(q, 2048, True, 8)
    assert grid == ff.SplitGrid(256, 8, 8 * 4)
    assert part.numel() == ff.split_workspace_numel(1, 4, 40, 64, 8)
    assert tickets.numel() >= 4 and torch.all(tickets == 0)
    q2 = torch.zeros((2, 4, 130, 64), dtype=torch.bfloat16)  # three q tiles
    grid, _, tickets, _ = ff.split_args(q2, 2048, True, 8)
    assert grid.blocks == 3 * grid.kv_splits * 4 * 2 and tickets.numel() >= 3 * 4 * 2
    assert ff.split_args(q.float(), 2048, True, 8)[1:3] == (None, None)
    assert ff.split_args(q, 2048)[1:3] == (None, None)
    assert ff.split_args(q, 2048, False, 8)[1:3] == (None, None)


# ---------------------------------------------------------------------------
# Speculative serving at group 8: 40 folded rows a verify call.
# ---------------------------------------------------------------------------

JAX_T = jax_tf.ModelConfig(vocab_size=256, d_model=128, n_layers=1, n_heads=8, n_kv_heads=1,
                           head_dim=64, d_ff=256, max_seq_len=512, dtype=jnp.float32)
JAX_D = jax_tf.ModelConfig(vocab_size=256, d_model=128, n_layers=1, n_heads=2, n_kv_heads=1,
                           head_dim=64, d_ff=128, max_seq_len=512, dtype=jnp.float32)
CFG_T = ModelConfig(vocab_size=256, d_model=128, n_layers=1, n_heads=8, n_kv_heads=1,
                    head_dim=64, d_ff=256, max_seq_len=512, dtype=torch.float32)
CFG_D = ModelConfig(vocab_size=256, d_model=128, n_layers=1, n_heads=2, n_kv_heads=1,
                    head_dim=64, d_ff=128, max_seq_len=512, dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_models():
    return (jax_tf.init_params(jax.random.PRNGKey(2), JAX_T),
            jax_tf.init_params(jax.random.PRNGKey(3), JAX_D))


@pytest.fixture(scope="module")
def models(jax_models):
    jt, jd = (jax.tree_util.tree_map(np.asarray, p) for p in jax_models)
    return (params_from_jax(jt, CFG_T, device="cpu"), params_from_jax(jd, CFG_D, device="cpu"))


def _serve(mod, params, cfg, draft, **kw):
    eng = mod.DecodeEngine(params, cfg, max_batch=2, max_len=512, draft=draft, spec_gamma=4,
                           **kw)
    for uid in range(3):
        eng.submit(mod.Request(uid=uid, prompt=[1 + uid, 2, 3, 60 + uid], max_new_tokens=8))
    return eng.run()


@pytest.fixture(scope="module")
def jax_streams(jax_models):
    """JAX's speculative engine at group 8 over a dense cache, once for the
    module (the paged bf16 cache holds the same values)."""
    return _serve(jax_eng, jax_models[0], JAX_T, (jax_models[1], JAX_D))


@pytest.mark.parametrize("kw", [dict(), dict(kv_quant="int8"), dict(paged=True),
                                dict(paged=True, kv_quant="int8")],
                         ids=["dense", "int8", "paged", "paged_int8"])
def test_group8_spec_engine_matches_plain_and_jax(models, jax_streams, kw, monkeypatch):
    """The speculative engine at group 8 over each target cache emits the
    plain engine's greedy tokens, and over the dense and paged caches JAX's
    (an 8-bit cache's streams are held to the port's plain engine: the
    folded int8 calls meet JAX's kernels above); its verify calls are
    folded (5 tokens x 8 q-heads = 40 rows at pos_div 8)."""
    calls = []

    def spy(q, *args, **kwargs):
        calls.append((q.shape[2], kwargs.get("pos_div", 1)))
        return plain(q, *args, **kwargs)

    plain = ff.flash_attention_fwd_plain
    for mod in (ff, quant, paged):
        monkeypatch.setattr(mod, "flash_attention_fwd_plain", spy)
    got = _serve(eng_mod, models[0], CFG_T, (models[1], CFG_D), **kw)
    assert (40, 8) in calls
    plain_streams = _serve(eng_mod, models[0], CFG_T, None, **kw)
    assert got == plain_streams
    if "kv_quant" not in kw:
        assert got == jax_streams


# ---------------------------------------------------------------------------
# The last public entry points.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("save_lse", [False, True])
def test_mha_matches_jax(save_lse):
    """``mha`` on ``[B, N, H, D]`` (GQA 2, causal): o (and lse, ``[B, H,
    N]``) against JAX's ``mha``."""
    rng = np.random.default_rng(5)
    q = rng.uniform(-1, 1, (2, 96, 4, 64)).astype(np.float32)
    k, v = (rng.uniform(-1, 1, (2, 96, 2, 64)).astype(np.float32) for _ in "kv")
    got = mha(*(torch.from_numpy(x) for x in (q, k, v)), causal=True, save_lse=save_lse)
    want = jax_fam.mha(*(jnp.asarray(x) for x in (q, k, v)), causal=True, save_lse=save_lse,
                       interpret=True)
    if save_lse:
        (got, lse), (want, want_lse) = got, want
        assert lse.shape == want_lse.shape == (2, 4, 96)
        _close(lse.numpy(), np.asarray(want_lse), FP32_TOL)
    assert got.shape == (2, 96, 4, 64)
    _close(got.numpy(), np.asarray(want), FP32_TOL)


def test_serving_main_needs_a_card(capsys):
    assert not torch.cuda.is_available()
    assert serving.main(["--dense-only"]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_serving_suite_returns_the_jax_keys():
    """The suite behind ``serving.main`` on the CPU at a tiny model: the
    dense run's keys, and JAX's four other runs under their keys (the
    prefix-shared one with half the prompt shared, multi-step 8)."""
    r = serving.serving_suite(max_batch=2, n_requests=3, prompt_len=16, max_new=8, max_len=256,
                              device="cpu", log=lambda s: None, n_layers=1, d_model=128,
                              n_heads=2, n_kv_heads=1, d_ff=128, vocab=256)
    keys = ("paged", "paged_prefix_shared", "multi_step_8", "weight_int8")
    assert all(k in r for k in keys) and r["mode"] == "dense"
    assert r["paged_prefix_shared"]["shared_prefix"] == 8 and r["multi_step_8"]["multi_step"] == 8
    for run in (r, *(r[k] for k in keys)):
        assert run["total_generated_tokens"] == 3 * 8 and run["tokens_per_s"] > 0


def test_train_bench_softcap_flag(monkeypatch):
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(train_bench, "run_train_bench", lambda **kw: seen.update(kw) or {})
    assert train_bench.main(["--softcap", "30", "--layers", "2"]) == 0
    assert seen["softcap"] == 30.0 and seen["n_layers"] == 2
    assert train_bench.main([]) == 0 and seen["softcap"] is None
