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
    "n_q,n_kv,causal",
    [(256, 256, False), (256, 256, True), (128, 256, True)],
    ids=["square", "square_causal", "kv_longer_causal"],
)
def test_naive_matches_jax(dtype, n_q, n_kv, causal):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(0, dtype, (2, 2, n_q, 64), (2, 2, n_kv, 64),
                                           (2, 2, n_kv, 64))
    want = jax_naive(qj, kj, vj, causal=causal, interpret=True)
    got = naive_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert _diff(got, want.astype(jnp.float32)) < TOL[dtype]


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "hq,hkv,n_q,n_kv,off",
    [(4, 2, 256, 256, 0), (2, 2, 128, 256, None), (4, 2, 128, 192, 16)],
    ids=["gqa_off0", "end_aligned", "gqa_off16"],
)
def test_tri_matches_jax(dtype, hq, hkv, n_q, n_kv, off):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(2, dtype, (2, hq, n_q, 64), (2, hkv, n_kv, 64),
                                           (2, hkv, n_kv, 64))
    o_j, lse_j = jax_tri(qj, kj, vj, q_offset=off, block_q=128, block_k=128, save_lse=True,
                         interpret=True)
    o_t, lse_t = ft.flash_attention_tri(qt, kt, vt, q_offset=off, save_lse=True)
    assert o_t.dtype == qt.dtype
    assert _diff(o_t, o_j.astype(jnp.float32)) < TOL[dtype]
    assert _diff(lse_t, np.asarray(lse_j)[..., 0]) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n_q,n_kv,off,with_dlse",
    [(256, 256, 0, False), (128, 192, 64, True)],
    ids=["off0", "off64_dlse"],
)
def test_tri_bwd_matches_jax(dtype, n_q, n_kv, off, with_dlse):
    """Both packages take the same o and lse (from the JAX triangular
    forward); dK and dV come back fp32 from both, dQ in q's dtype."""
    shapes = ((2, 2, n_q, 64), (2, 2, n_kv, 64), (2, 2, n_kv, 64), (2, 2, n_q, 64))
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(3, dtype, *shapes)
    o_j, lse_j = jax_tri(qj, kj, vj, q_offset=off, block_q=128, block_k=128, save_lse=True,
                         interpret=True)
    dlse = np.random.default_rng(4).uniform(-1, 1, (2, 2, n_q)).astype(np.float32)
    dlse_j, dlse_t = (jnp.asarray(dlse), torch.from_numpy(dlse)) if with_dlse else (None, None)
    want = jax_bwd_tri(qj, kj, vj, o_j, doj, lse_j, dlse_j, q_offset=off, block_q=128,
                       block_k=128, interpret=True)
    o_t = torch.from_numpy(np.array(o_j.astype(jnp.float32))).to(qt.dtype)
    lse_t = torch.from_numpy(np.asarray(lse_j)[..., 0].copy())
    got = ft.flash_attention_bwd_tri(qt, kt, vt, o_t, dot, lse_t, dlse_t, q_offset=off)
    assert got[0].dtype == qt.dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    assert want[1].dtype == want[2].dtype == jnp.float32
    for g, w in zip(got, want):
        assert _rel(g, w.astype(jnp.float32)) < BWD_TOL[dtype]


def test_split_pair_keeps_k_dtype_where_tri_returns_fp32():
    """The two backward routes differ in dK/dV dtype, as in JAX."""
    (_, q), (_, k), (_, v), (_, do) = _inputs(5, "bfloat16", *[(1, 2, 128, 64)] * 4)
    o, lse = ff.flash_attention_fwd(q, k, v, causal=True, save_lse=True)
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
    # a feature: the port raises (ROADMAP Queue A item 5); JAX runs it on
    # the general kernel
    ("float32", True, "none", 256, 1, {"window": 64}, "raises", "general"),
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
    assert ff.fwd_route(n, t_off, causal=causal, pos_div=pos_div) == port_route
    called = []
    for name, module, attr in (("tri", ft, "flash_attention_tri"),
                               ("lean", ff, "flash_fwd_lean"),
                               ("general", ff, "flash_fwd_general")):
        real = getattr(module, attr)
        monkeypatch.setattr(module, attr, lambda *a, _n=name, _r=real, **k: (
            called.append(_n), _r(*a, **k))[1])
    qk = torch.zeros((1, 2, n, 64), dtype=getattr(torch, dtype)) if n <= 1024 else None
    if qk is not None:
        out = ff.flash_attention_fwd(qk, qk, qk, t_off, causal=causal, pos_div=pos_div)
        assert called == [port_route] and out.dtype == qk.dtype


# The backward route table: (dtype, causal, offset kind, n, equal heads)
# -> (the port's route, the JAX dispatcher's).  The differing rows are
# tri_bwd_heuristic's limits (N a multiple of 512, N <= 4096), dropped.
BWD_ROUTES = [
    ("bfloat16", True, "none", 1024, "tri", "tri"),
    ("bfloat16", True, "int", 1024, "tri", "tri"),
    ("bfloat16", True, "tensor", 1024, "split", "split"),
    ("bfloat16", False, "none", 1024, "split", "split"),
    ("float16", True, "none", 1024, "split", "split"),
    ("float32", True, "none", 512, "tri", "tri"),
    # intended differences: v5e tile choices and Mosaic limits
    ("bfloat16", True, "none", 128, "tri", "split"),
    ("bfloat16", True, "none", 8192, "tri", "split"),
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


def test_backward_route_gqa_takes_the_split_pair():
    """Unequal head counts: the port's split pair takes GQA natively (the
    JAX split kernels refuse it; the JAX op repeats K/V first)."""
    q, k = torch.zeros((1, 4, 8, 64)), torch.zeros((1, 2, 8, 64))
    assert fb.bwd_route(q, k, None, causal=True) == "split"
