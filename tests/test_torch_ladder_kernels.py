"""PyTorch port: the kernel ladder's kernels and routers against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
functions run their Pallas kernels in interpret mode, as the JAX tests do on
the CPU; the port runs each kernel's plain version, which is what its
wrapper takes for CPU tensors.  The CUDA kernels themselves run only on a
card: their tests are in ``test_torch_gpu.py``.

Tolerances: fp32 2e-5 on the outputs and 1e-4 of the largest gradient on
the uniform(-1, 1) fixture (the JAX kernels' fp32 products are bf16 x 3,
ROADMAP.md Queue C); bf16 1e-2 (the ladder's half-precision rung) and 2e-2
of the largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_metal_tpu.kernels.flash_bwd import (
    flash_attention_bwd_auto as jax_bwd_auto,
)
from flash_attention_metal_tpu.kernels.flash_fwd import flash_attention_fwd as jax_fwd
from flash_attention_metal_tpu.kernels.flash_tri import (
    flash_attention_bwd_tri as jax_bwd_tri,
)
from flash_attention_metal_tpu.kernels.flash_tri import flash_attention_tri as jax_tri
from flash_attention_metal_tpu.kernels.naive import naive_attention as jax_naive
from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels import flash_tri as ft
from flash_attention_metal_tpu_torch.kernels.naive import naive_attention

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, dtype, *shapes):
    """uniform(-1, 1) arrays of ``shapes``, as (jax, torch) pairs in ``dtype``."""
    rng = np.random.default_rng(seed)
    _, jdt, tdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
        out.append((jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)))
    return out


def _diff(got: torch.Tensor, want) -> float:
    return float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32))))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return _diff(got, want) / float(np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n_q,n_kv,causal,d",
    [(256, 256, False, 64), (256, 256, True, 64), (128, 256, True, 64), (128, 256, True, 128),
     # lengths that are not multiples of the CUDA kernel's 64-row tiles
     (130, 257, False, 64), (130, 257, True, 64), (130, 257, True, 128),
     # causal with n_q > n_kv: rows 0-126 see no column
     (257, 130, True, 64)],
    ids=["square", "square_causal", "kv_longer_causal", "kv_longer_causal_d128",
         "ragged", "ragged_causal", "ragged_causal_d128", "q_longer_causal"],
)
def test_naive_matches_jax(dtype, n_q, n_kv, causal, d):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(0, dtype, (2, 2, n_q, d), (2, 2, n_kv, d),
                                           (2, 2, n_kv, d))
    # One Pallas grid step for the whole row range: n_q need not divide
    # into the JAX default's 128-row blocks.
    want = jax_naive(qj, kj, vj, causal=causal, block_q=n_q, interpret=True)
    got = naive_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert _diff(got, want.astype(jnp.float32)) < TOL[dtype]


def test_naive_rows_that_see_nothing_give_mean_v():
    """Causal with n_q > n_kv (end-aligned diagonal): rows r < n_q - n_kv
    see no column, every score takes the mask value, and o is mean(V), as
    in the JAX kernel; the next row sees column 0 alone and gives v[0]."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(1, "float32", (1, 2, 200, 64), (1, 2, 70, 64),
                                           (1, 2, 70, 64))
    got = naive_attention(qt, kt, vt, causal=True)
    want = jax_naive(qj, kj, vj, causal=True, block_q=200, interpret=True)
    blind = 200 - 70
    assert _diff(got[:, :, :blind], np.broadcast_to(np.asarray(vj).mean(axis=2, keepdims=True),
                                                    (1, 2, blind, 64))) < TOL["float32"]
    assert _diff(got[:, :, blind], np.asarray(vj)[:, :, 0]) < TOL["float32"]
    assert _diff(got, want) < TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "hq,hkv,n_q,n_kv,causal",
    [
        (4, 2, 256, 256, False),  # GQA 2, non-causal
        (2, 2, 256, 256, True),  # offset 0
        (4, 2, 128, 256, True),  # offset 128, GQA 2
    ],
    ids=["gqa_noncausal", "causal_off0", "gqa_causal_off128"],
)
def test_lean_matches_jax(dtype, hq, hkv, n_q, n_kv, causal):
    """The JAX lean path (``_fwd_lean``) through its router: it takes it for
    rows of one KV block with the default (end-aligned) offset; for causal
    calls explicit one-block sizes keep it off its triangular kernel.  The
    port's lean wrapper gets the same offset as an int."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(1, dtype, (2, hq, n_q, 64), (2, hkv, n_kv, 64),
                                           (2, hkv, n_kv, 64))
    blocks = JaxBlockSizes(block_q=n_q, block_k_major=n_kv, block_k=n_kv) if causal else None
    fn = lambda q, k, v: jax_fwd(  # noqa: E731
        q, k, v, causal=causal, save_lse=True, block_sizes=blocks, interpret=True)
    assert _jax_grid_ranks(fn, qj, kj, vj) == [3]  # the lean kernel's 3-D grid
    o_j, lse_j = fn(qj, kj, vj)
    o_t, lse_t = ff.flash_fwd_lean(qt, kt, vt, n_kv - n_q, causal=causal, save_lse=True)
    assert o_t.dtype == qt.dtype and lse_t.dtype == torch.float32
    assert _diff(o_t, o_j.astype(jnp.float32)) < TOL[dtype]
    assert _diff(lse_t, np.asarray(lse_j)[..., 0]) < TOL[dtype]


@pytest.mark.parametrize("off", [0, 100, -70], ids=["off0", "off100", "off_minus70"])
@pytest.mark.parametrize("d", [64, 128], ids=["d64", "d128"])
@pytest.mark.parametrize("group", [1, 2], ids=["gqa1", "gqa2"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
def test_lean_contract_is_the_general_one_with_a_broadcast_offset(causal, group, d, off):
    """Lean's contract is the general forward's with one int offset for
    every batch, which is what lets the card run both on one kernel: its
    plain version (and its wrapper on the CPU) equals the general one given
    ``torch.full([B], off)``, within fp32 rounding.  Offset -70 leaves the
    first 70 rows seeing nothing: o = 0 and lse = -inf there."""
    rng = np.random.default_rng(5)
    b, hkv, n_q, n_kv = 2, 2, 96, 160
    q, k, v = (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
               for shape in ((b, hkv * group, n_q, d), (b, hkv, n_kv, d), (b, hkv, n_kv, d)))
    scale = d ** -0.5
    offsets = torch.full([b], off, dtype=torch.int32)
    want = ff.flash_attention_fwd_plain(q, k, v, offsets, sm_scale=scale, causal=causal,
                                        save_lse=True)
    for got in (
        ff.flash_fwd_lean_plain(q, k, v, off, sm_scale=scale, causal=causal, save_lse=True),
        ff.flash_fwd_lean(q, k, v, off, causal=causal, save_lse=True),
        ff.flash_fwd_general(q, k, v, offsets, causal=causal, save_lse=True),
    ):
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)
    if causal and off < 0:
        assert torch.all(want[0][:, :, :-off] == 0)
        assert torch.all(want[1][:, :, :-off] == float("-inf"))
        assert torch.all(torch.isfinite(want[1][:, :, -off:]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "hq,hkv,n_q,n_kv,off,d",
    [(4, 2, 256, 256, 0, 64), (2, 2, 128, 256, None, 64), (4, 2, 128, 192, 16, 64),
     (4, 2, 256, 128, -70, 64), (4, 2, 128, 192, 16, 128)],
    ids=["gqa_off0", "end_aligned", "gqa_off16", "gqa_q_longer_neg_off", "gqa_off16_d128"],
)
def test_tri_matches_jax(dtype, hq, hkv, n_q, n_kv, off, d):
    """Rows that see no column (a negative offset, n_q > n_kv): the port
    gives o = 0 and lse = -inf, the JAX triangular kernel mean(V) and its
    finite mask value (ROADMAP.md, standing findings); every other row
    matches."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(2, dtype, (2, hq, n_q, d), (2, hkv, n_kv, d),
                                           (2, hkv, n_kv, d))
    o_j, lse_j = jax_tri(qj, kj, vj, q_offset=off, block_q=128, block_k=128, save_lse=True,
                         interpret=True)
    o_t, lse_t = ft.flash_attention_tri(qt, kt, vt, q_offset=off, save_lse=True)
    assert o_t.dtype == qt.dtype
    seen = np.arange(n_q) + (n_kv - n_q if off is None else off) >= 0
    o_j = np.asarray(o_j.astype(jnp.float32))
    lse_j = np.asarray(lse_j)[..., 0]
    assert _diff(o_t[:, :, seen], o_j[:, :, seen]) < TOL[dtype]
    assert _diff(lse_t[:, :, seen], lse_j[:, :, seen]) < TOL[dtype]
    assert torch.all(o_t[:, :, ~seen] == 0)
    assert torch.all(lse_t[:, :, ~seen] == float("-inf"))
    assert (off is not None and off < 0) == (not seen.all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n_q,n_kv,off,with_dlse,d",
    [(256, 256, 0, False, 64), (128, 192, 64, True, 64), (128, 192, 64, True, 128),
     (256, 128, -70, False, 64), (130, 300, 170, True, 64)],
    ids=["off0", "off64_dlse", "off64_dlse_d128", "q_longer_neg_off", "ragged_off170_dlse"],
)
def test_tri_bwd_matches_jax(dtype, n_q, n_kv, off, with_dlse, d):
    """Both packages take the same o and lse (from the JAX triangular
    forward); dK and dV come back fp32 from both, dQ in q's dtype.  Rows
    that see no column (a negative offset) get zero dQ in both, and every
    gradient stays finite.  The JAX kernel takes Q blocks that divide n_q:
    a ragged n_q is one block."""
    shapes = ((2, 2, n_q, d), (2, 2, n_kv, d), (2, 2, n_kv, d), (2, 2, n_q, d))
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(3, dtype, *shapes)
    block_q = 128 if n_q % 128 == 0 else n_q
    o_j, lse_j = jax_tri(qj, kj, vj, q_offset=off, block_q=block_q, block_k=128, save_lse=True,
                         interpret=True)
    dlse = np.random.default_rng(4).uniform(-1, 1, (2, 2, n_q)).astype(np.float32)
    dlse_j, dlse_t = (jnp.asarray(dlse), torch.from_numpy(dlse)) if with_dlse else (None, None)
    want = jax_bwd_tri(qj, kj, vj, o_j, doj, lse_j, dlse_j, q_offset=off, block_q=block_q,
                       block_k=128, interpret=True)
    o_t = torch.from_numpy(np.array(o_j.astype(jnp.float32))).to(qt.dtype)
    lse_t = torch.from_numpy(np.asarray(lse_j)[..., 0].copy())
    got = ft.flash_attention_bwd_tri(qt, kt, vt, o_t, dot, lse_t, dlse_t, q_offset=off)
    assert got[0].dtype == qt.dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    assert want[1].dtype == want[2].dtype == jnp.float32
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w.astype(jnp.float32)) < BWD_TOL[dtype]
    if off < 0:
        assert torch.all(got[0][:, :, :-off] == 0)
        assert float(np.max(np.abs(np.asarray(want[0][:, :, :-off], np.float32)))) == 0.0


def test_split_pair_keeps_k_dtype_where_tri_returns_fp32(monkeypatch):
    """The two backward routes differ in dK/dV dtype, as in JAX.  The
    untuned rule takes the split pair, so a saved decision names tri."""
    from flash_attention_metal_tpu_torch.harness import autotune

    (_, q), (_, k), (_, v), (_, do) = _inputs(5, "bfloat16", *[(1, 2, 128, 64)] * 4)
    o, lse = ff.flash_attention_fwd(q, k, v, causal=True, save_lse=True)
    monkeypatch.setattr(autotune, "lookup_bwd", lambda *a, **kw: ("tri", {}))
    tri = fb.flash_attention_bwd_auto(q, k, v, o, do, lse, causal=True)
    split = fb.flash_attention_bwd_auto(q, k, v, o, do, lse, torch.zeros(1, dtype=torch.int32),
                                        causal=True)
    assert [g.dtype for g in tri] == [torch.bfloat16, torch.float32, torch.float32]
    assert [g.dtype for g in split] == [torch.bfloat16] * 3
    for a, b in zip(tri, split):
        assert float((a.float() - b.float()).abs().max()) < 2e-2 * float(a.float().abs().max())


def _jax_grid_ranks(fn, *args):
    """Grid rank of every ``pallas_call`` the JAX function traces to: the
    triangular kernels have a 2-D grid, lean and naive 3-D, the general
    forward and the split backward pair 4-D."""
    ranks = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                ranks.append(len(eqn.params["grid_mapping"].grid))
            for val in eqn.params.values():
                sub = getattr(val, "jaxpr", None)
                if sub is not None:
                    walk(getattr(sub, "jaxpr", sub))

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return ranks


_FWD_NAMES = {2: "tri", 3: "lean", 4: "general"}

# The forward route table: (dtype, causal, offset kind, n, pos_div, features)
# -> (the port's kernel, the kernel the JAX router takes).  The port follows
# the router's written conditions.  The rows where the two differ:
# * the JAX router's Mosaic limits, which the port drops: _TRI_MAX_N
#   (N > 4096) and tri_heuristic's tile conditions (n_q < 128);
# * an int offset: the router's condition admits None or an int, but its
#   jitted entry point traces a Python int into an array, so only None
#   reaches the triangular and lean kernels in JAX (ROADMAP Queue C).
FWD_ROUTES = [
    ("float32", True, "none", 256, 1, {}, "tri", "tri"),
    ("float32", True, "tensor", 256, 1, {}, "general", "general"),
    ("float32", False, "none", 256, 1, {}, "lean", "lean"),
    ("float32", False, "tensor", 256, 1, {}, "general", "general"),
    ("float32", False, "none", 1024, 1, {}, "lean", "lean"),
    ("float32", False, "none", 2048, 1, {}, "general", "general"),
    ("bfloat16", True, "none", 2048, 1, {}, "tri", "tri"),
    ("float32", True, "none", 256, 2, {}, "general", "general"),
    ("float16", False, "none", 256, 1, {}, "lean", "lean"),
    ("float16", True, "none", 256, 1, {}, "tri", "tri"),
    # intended differences: Mosaic limits
    ("bfloat16", True, "none", 8192, 1, {}, "tri", "general"),
    ("float32", True, "none", 64, 1, {}, "tri", "lean"),
    # the int offset, traced by JAX's jit
    ("float32", True, "int", 256, 1, {}, "tri", "general"),
    ("float32", False, "int", 256, 1, {}, "lean", "general"),
    # the sliding window (with its sinks): the general kernel in both
    ("float32", True, "none", 256, 1, {"window": 64}, "general", "general"),
    ("bfloat16", True, "none", 256, 1, {"window": 64, "sinks": 4}, "general", "general"),
    # the score transforms: the general kernel in both (a causal static
    # offset would take tri, a short non-causal row lean, without them)
    ("float32", True, "none", 256, 1, {"softcap": 30.0}, "general", "general"),
    ("bfloat16", False, "none", 256, 1, {"softcap": 20.0}, "general", "general"),
]


def _offset(kind, batch):
    return {"none": None, "int": 0,
            "tensor": np.zeros((batch,), np.int32)}[kind]


@pytest.mark.parametrize("row", FWD_ROUTES, ids=lambda r: "-".join(map(str, r[:6])))
def test_forward_route_table(row, monkeypatch):
    dtype, causal, kind, n, pos_div, features, port_route, jax_route = row
    q = jnp.zeros((1, 2, n, 64), jnp.dtype(dtype))
    off = _offset(kind, 1)
    ranks = _jax_grid_ranks(
        lambda x: jax_fwd(x, x, x, None if off is None else off if kind == "int" else jnp.asarray(off),
                          causal=causal, pos_div=pos_div, interpret=True, **features), q)
    assert [_FWD_NAMES[r] for r in ranks] == [jax_route]

    # The port: the route function, and the wrapper the router calls.
    t_off = torch.from_numpy(off) if kind == "tensor" else off
    qt = torch.zeros((1, 2, min(n, 256), 64), dtype=getattr(torch, dtype))
    if port_route == "raises":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ff.flash_attention_fwd(qt, qt, qt, t_off, causal=causal, **features)
        return
    featured = bool(features)
    assert ff.fwd_route(n, t_off, causal=causal, pos_div=pos_div, featured=featured) == port_route
    called = []
    for name, module, attr in (("tri", ft, "flash_attention_tri"),
                               ("lean", ff, "flash_fwd_lean"),
                               ("general", ff, "flash_fwd_general")):
        real = getattr(module, attr)
        monkeypatch.setattr(module, attr, lambda *a, _n=name, _r=real, **k: (
            called.append(_n), _r(*a, **k))[1])
    qk = torch.zeros((1, 2, n, 64), dtype=getattr(torch, dtype)) if n <= 1024 else None
    if qk is not None:
        out = ff.flash_attention_fwd(qk, qk, qk, t_off, causal=causal, pos_div=pos_div,
                                     **features)
        assert called == [port_route] and out.dtype == qk.dtype


# The backward route table: (dtype, causal, offset kind, n, equal heads)
# -> (the port's untuned route, the JAX dispatcher's).  The differing rows
# are the H100's race: the port's untuned rule takes the split pair, which
# beat the triangular backward at every shape raced (PERF.md §6); JAX
# takes its triangular backward for plain causal calls with a static offset
# within tri_bwd_heuristic's limits.
BWD_ROUTES = [
    ("bfloat16", True, "tensor", 1024, "split", "split"),
    ("bfloat16", False, "none", 1024, "split", "split"),
    ("float16", True, "none", 1024, "split", "split"),
    ("bfloat16", True, "none", 128, "split", "split"),
    ("bfloat16", True, "none", 8192, "split", "split"),
    # intended differences: the H100's race
    ("bfloat16", True, "none", 1024, "split", "tri"),
    ("bfloat16", True, "int", 1024, "split", "tri"),
    ("float32", True, "none", 512, "split", "tri"),
]


@pytest.mark.parametrize("row", BWD_ROUTES, ids=lambda r: "-".join(map(str, r[:4])))
def test_backward_route_table(row):
    dtype, causal, kind, n, port_route, jax_route = row
    q = jnp.zeros((1, 2, n, 64), jnp.dtype(dtype))
    lse = jnp.zeros((1, 2, n, 128), jnp.float32)
    off = _offset(kind, 1)
    j_off = jnp.asarray(off) if kind == "tensor" else off
    ranks = _jax_grid_ranks(
        lambda x, l: jax_bwd_auto(x, x, x, x, x, l, j_off, causal=causal, interpret=True), q, lse)
    assert ("tri" if ranks == [2] else "split" if ranks == [4, 4] else ranks) == jax_route
    qt = torch.zeros((1, 2, 8, 64), dtype=getattr(torch, dtype))
    t_off = torch.from_numpy(off) if kind == "tensor" else off
    assert fb.bwd_route(qt, qt, t_off, causal=causal) == port_route


@pytest.mark.parametrize("kind", ["none", "int"])
def test_backward_route_with_a_window_takes_the_split_pair(kind, monkeypatch):
    """A window (with sinks) rules the triangular backward out in both
    routers: the shapes of the table's tri rows take the split pair."""
    q = jnp.zeros((1, 2, 1024, 64), jnp.bfloat16)
    lse = jnp.zeros((1, 2, 1024, 128), jnp.float32)
    off = _offset(kind, 1)
    ranks = _jax_grid_ranks(
        lambda x, l: jax_bwd_auto(x, x, x, x, x, l, off, causal=True, window=128, sinks=4,
                                  interpret=True), q, lse)
    assert ranks == [4, 4]
    qt = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    # Even a saved tri decision: the window rules it out.
    from flash_attention_metal_tpu_torch.harness import autotune

    monkeypatch.setattr(autotune, "lookup_bwd", lambda *a, **kw: ("tri", {}))
    assert fb.bwd_route(qt, qt, off, causal=True, featured=True) == "split"
    assert fb.bwd_route(qt, qt, off, causal=True) == "tri"


def test_backward_route_gqa_takes_the_split_pair():
    """Unequal head counts: the port's split pair takes GQA natively (the
    JAX split kernels refuse it; the JAX op repeats K/V first)."""
    q, k = torch.zeros((1, 4, 8, 64)), torch.zeros((1, 2, 8, 64))
    assert fb.bwd_route(q, k, None, causal=True) == "split"
