"""The score transforms, the tanh softcap and ALiBi (with the slopes'
gradient), in the PyTorch port against the JAX package.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as the JAX package's own tests run them on the CPU) and the
port's (the kernels' plain versions on CPU tensors).  Tolerances, fp32:
* op outputs and lse 2e-5 (the kernel parity tests' ``TOL``);
* dQ, dK, dV 1e-4 of each gradient's largest value (``test_torch_flash_bwd.py``:
  the JAX kernels' fp32 products are bf16x3);
* d_slopes relatively, as ladder rung 17 compares it, the error over
  ``|d_slopes| + 1``: within 1e-4 of a float64 computation of the same
  function (numpy), and within 1e-2 of the JAX op's.  Each entry sums
  dS * distance over every pair of a head, a sum that cancels (dS sums to
  0 over a row) with distances up to 128; the JAX kernels' bf16x3 products
  leave up to 3.2e-3 of error in it on these cases (``both_full``: JAX
  2.2665, the port 2.2769, float64 2.2771), the port's fp32 plain version
  6e-5.
The cache kernels' cases live beside their other parity tests
(``test_torch_quant.py``, ``test_torch_paged.py``: ``-k xf``), the model's
in ``test_torch_train.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu import config as jax_config
from flash_attention_metal_tpu.kernels.flash_bwd import flash_attention_bwd_auto as jax_bwd_auto
from flash_attention_metal_tpu.ops import attention as jax_ops
from flash_attention_metal_tpu_torch import SegmentIds, flash_attention
from flash_attention_metal_tpu_torch.harness import autotune
from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.ops import attention as ops

TOL = 2e-5
GRAD_TOL = 1e-4
SLOPE_JAX_TOL = 1e-2


def _u(rng, *shape, scale=1.0):
    return (rng.uniform(-1.0, 1.0, shape) * scale).astype(np.float32)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.detach().float().numpy() - want)) / max(1.0, np.max(np.abs(want))))


def _slope_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.detach().numpy() - want) / (np.abs(want) + 1.0)))


def _d_slopes_f64(q, k, v, do, off, causal, slopes, t_kw, absolute=False) -> np.ndarray:
    """d_slopes of the forward's contract in float64 (numpy), the mask from
    ``flash_fwd.plain_visible``: sum over batches and pairs of dS * (c - p),
    dS = P (dP - rowsum(P dP)) the cotangent of the transformed score
    (``absolute``: of |dS * (c - p)|)."""
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    group = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, group, 1), np.repeat(v, group, 1)
    b, _, n_q, d = q.shape
    n_kv = k.shape[2]
    offs = np.broadcast_to(n_kv - n_q if off is None else off, (b,)).astype(np.int64)
    s = q @ k.transpose(0, 1, 3, 2) / np.sqrt(d)
    if t_kw.get("softcap"):
        s = t_kw["softcap"] * np.tanh(s / t_kw["softcap"])
    dist = (np.arange(n_kv)[None, None, :] - (np.arange(n_q)[None, :, None]
                                                + offs[:, None, None]))[:, None].astype(np.float64)
    s = s + slopes.astype(np.float64)[None, :, None, None] * dist
    vis = ff.plain_visible(n_q, n_kv, torch.from_numpy(offs.astype(np.int32)), causal=causal,
                           window=t_kw.get("window"), sinks=t_kw.get("sinks", 0),
                           segment_ids=t_kw.get("segment_ids")).numpy()
    s = np.where(vis, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.where(vis, np.exp(s - np.where(np.isfinite(m), m, 0.0)), 0.0)
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-300)
    dp = do @ v.transpose(0, 1, 3, 2)
    ds = p * (dp - (p * dp).sum(-1, keepdims=True))
    terms = ds * dist
    return (np.abs(terms) if absolute else terms).sum(axis=(0, 2, 3))


def _abs(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    return float(np.max(np.abs(got[fin] - want[fin]))) if fin.any() else 0.0


def _ids(batch, n, cuts):
    ids = np.zeros((batch, n), np.int32)
    for b in range(batch):
        for c in cuts[b % len(cuts)]:
            ids[b, c:] += 1
    return ids


# The op, forward and gradients: 4 q-heads over 2 KV heads (GQA: the JAX op
# repeats K/V under ALiBi, the port's kernels take the group natively and
# keep d_slopes per q-head), N 128, D 64; q scaled by 3 so the scores
# spread over a few units and the cap bites.  Caps 0.5 and 30, slopes the
# standard schedule (2^-2 .. 2^-8) or large ones; composed with the window
# and its sinks and with segment ids; causal and not; int and per-batch
# tensor offsets.
SLOPES = {"std": (0.25, 0.0625, 0.015625, 0.00390625), "large": (1.0, 0.75, 0.5, 0.25)}
OP_CASES = {
    "cap30": dict(softcap=30.0),
    "cap05": dict(softcap=0.5),
    "alibi": dict(alibi="std"),
    "alibi_large_int_offset": dict(alibi="large", n_q=96, off="int"),
    "both": dict(softcap=30.0, alibi="std"),
    "both_cap05_tensor_offsets": dict(softcap=0.5, alibi="std", n_q=96, off="tensor"),
    "both_full": dict(softcap=30.0, alibi="large", causal=False, off="tensor"),
    "both_window": dict(softcap=30.0, alibi="std", window=40, sinks=4),
    "both_window_offsets": dict(softcap=2.0, alibi="large", window=33, sinks=70, n_q=96,
                                off="tensor"),
    "both_segments": dict(softcap=30.0, alibi="std", segments=((37, 90), (60,))),
    "both_segments_full": dict(softcap=1.0, alibi="std", causal=False,
                               segments=((37, 90), (60,))),
}


def _op_inputs(case, seed=0):
    kw = dict(OP_CASES[case])
    n_q, n_kv = kw.pop("n_q", 128), 128
    off = {None: None, "int": n_kv - n_q - 20,
           "tensor": np.asarray([n_kv - n_q, 17], np.int32)}[kw.pop("off", None)]
    causal = kw.pop("causal", True)
    rng = np.random.default_rng(seed)
    q, do = _u(rng, 2, 4, n_q, 64, scale=3.0), _u(rng, 2, 4, n_q, 64)
    k, v = _u(rng, 2, 2, n_kv, 64), _u(rng, 2, 2, n_kv, 64)
    t_kw, j_kw = dict(kw), dict(kw)
    slopes = None
    if "alibi" in kw:
        slopes = np.asarray(SLOPES[t_kw.pop("alibi")], np.float32)
        j_kw.pop("alibi")
    if "segments" in kw:
        # Cuts in position space: the row at position p shares column p's id.
        cuts = t_kw.pop("segments")
        j_kw.pop("segments")
        kv_ids = _ids(2, n_kv, cuts)
        shift = np.broadcast_to(n_kv - n_q if off is None else off, (2,))
        q_ids = np.stack([kv_ids[b, shift[b]:shift[b] + n_q] for b in range(2)])
        t_kw["segment_ids"] = SegmentIds(torch.from_numpy(q_ids), torch.from_numpy(kv_ids))
        j_kw["segment_ids"] = jax_config.SegmentIds(jnp.asarray(q_ids), jnp.asarray(kv_ids))
    return q, k, v, do, off, causal, slopes, t_kw, j_kw


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_flash_attention_matches_jax(case):
    """Outputs, lse, dQ, dK, dV and d_slopes of the op against the JAX op."""
    q, k, v, do, off, causal, slopes, t_kw, j_kw = _op_inputs(case)
    j_off = None if off is None else off if isinstance(off, int) else jnp.asarray(off)
    t_off = None if off is None else off if isinstance(off, int) else torch.from_numpy(off)
    args = [q, k, v] + ([] if slopes is None else [slopes])

    def jax_f(q_, k_, v_, *s_):
        return jax_ops.flash_attention(q_, k_, v_, j_off, causal=causal, save_lse=True,
                                       interpret=True, alibi_slopes=s_[0] if s_ else None, **j_kw)

    (want_o, want_l), vjp = jax.vjp(jax_f, *map(jnp.asarray, args))
    want_g = vjp((jnp.asarray(do), jnp.zeros_like(want_l)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args]
    o, lse = flash_attention(*leaves[:3], t_off, causal=causal, save_lse=True,
                             alibi_slopes=leaves[3] if slopes is not None else None, **t_kw)
    assert _abs(o, want_o) < TOL and _abs(lse, want_l) < TOL
    got_g = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for g, w in zip(got_g[:3], want_g[:3]):
        assert _rel(g, w) < GRAD_TOL
    if slopes is not None:
        assert got_g[3].shape == (4,) and _slope_err(got_g[3], want_g[3]) < SLOPE_JAX_TOL
        exact = _d_slopes_f64(q, k, v, do, off, causal, slopes, t_kw)
        assert _slope_err(got_g[3], exact) < GRAD_TOL
    # impl="reference" (the fp32 oracle) agrees too.
    ref = flash_attention(*map(torch.from_numpy, (q, k, v)), t_off, causal=causal,
                          impl="reference", alibi_slopes=None if slopes is None
                          else torch.from_numpy(slopes), **t_kw)
    assert _abs(ref, want_o) < TOL


@pytest.mark.parametrize("case", ["both", "both_window_offsets"])
def test_split_backward_matches_jax_kernels(case):
    """The split pair's plain versions (``flash_attention_bwd``: dQ, dK, dV
    and d_slopes from the forward's o and lse) against the JAX backward
    router in interpret mode (equal heads: the JAX split kernels take no
    GQA under ALiBi)."""
    q, k, v, do, off, causal, slopes, t_kw, j_kw = _op_inputs(case, seed=4)
    kb, vb = (np.repeat(x, 2, axis=1) for x in (k, v))
    j_off = None if off is None else jnp.asarray(off)
    t_off = None if off is None else torch.from_numpy(off)
    t_kw["alibi_slopes"], j_kw["alibi_slopes"] = torch.from_numpy(slopes), jnp.asarray(slopes)
    o, lse = ff.flash_attention_fwd(*map(torch.from_numpy, (q, kb, vb)), t_off, causal=causal,
                                    save_lse=True, **t_kw)
    lse_lanes = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None], lse.shape + (128,))
    want = jax_bwd_auto(*map(jnp.asarray, (q, kb, vb, o.numpy(), do)), lse_lanes, j_off,
                        causal=causal, interpret=True, **j_kw)
    got = fb.flash_attention_bwd(*map(torch.from_numpy, (q, kb, vb)), o, torch.from_numpy(do),
                                 lse, t_off, causal=causal, **t_kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) < GRAD_TOL
    assert _slope_err(got[3], want[3]) < SLOPE_JAX_TOL
    assert _slope_err(got[3], _d_slopes_f64(q, kb, vb, do, off, causal, slopes, t_kw)) < GRAD_TOL


@pytest.mark.parametrize("case", ["both_full", "both_window_offsets", "both_segments"])
def test_dslope_term_sizes_match_float64(case):
    """``dslope_term_sizes``, the per-head scale the card's d_slopes check
    reads each head's error against: each head's sum of |dS * (c - p)|,
    within 1e-5 relative of float64 (numpy), and no smaller than the
    head's |d_slopes|."""
    q, k, v, do, off, causal, slopes, t_kw, _ = _op_inputs(case, seed=6)
    t_off = None if off is None else off if isinstance(off, int) else torch.from_numpy(off)
    t_kw["alibi_slopes"] = torch.from_numpy(slopes)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = ff.flash_attention_fwd(t[0], t[1], t[2], t_off, causal=causal, save_lse=True, **t_kw)
    off_t = torch.from_numpy(np.broadcast_to(k.shape[2] - q.shape[2] if off is None else off,
                                             (q.shape[0],)).astype(np.int32))
    sizes = fb.dslope_term_sizes(t[0], t[1], t[2], o, t[3], lse, off_t, causal=causal,
                                 sm_scale=q.shape[-1] ** -0.5, **t_kw).numpy()
    want = _d_slopes_f64(q, k, v, do, off, causal, slopes, t_kw, absolute=True)
    assert np.max(np.abs(sizes - want) / want) < 1e-5
    d_slopes = _d_slopes_f64(q, k, v, do, off, causal, slopes, t_kw)
    assert np.all(np.abs(d_slopes) <= want) and np.all(want > 0)


def test_d_slopes_stay_per_q_head_under_gqa():
    """Under GQA the dK/dV kernel walks a KV head's group of q-heads: its
    d_slopes partials are per q-head (the plain version's sum over one
    head's pairs), so two heads of a group with different slopes keep
    different gradients, equal to those of the broadcast (repeated) K/V."""
    q, k, v, do, off, causal, slopes, t_kw, _ = _op_inputs("both", seed=5)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    kw = dict(causal=True, softcap=30.0, alibi_slopes=torch.from_numpy(slopes))
    o, lse = ff.flash_attention_fwd(t[0], t[1], t[2], save_lse=True, **kw)
    gqa = fb.flash_attention_bwd(t[0], t[1], t[2], o, t[3], lse, **kw)
    rep = fb.flash_attention_bwd(t[0], t[1].repeat_interleave(2, 1), t[2].repeat_interleave(2, 1),
                                 o, t[3], lse, **kw)
    assert float((gqa[3] - rep[3]).abs().max()) < 1e-4 * float(rep[3].abs().max())
    assert not torch.allclose(gqa[3][0], gqa[3][1])


def test_transformed_calls_take_the_general_kernel_as_in_jax():
    """A softcap or ALiBi slopes send a static-offset call to the general
    forward (lean and triangular take neither, JAX ``flash_fwd.py:829-838,
    932-941``); the decode fold takes the cap, not ALiBi."""
    q = torch.zeros((1, 2, 64, 64))
    calls = []
    real = ff.flash_fwd_general
    try:
        ff.flash_fwd_general = lambda *a, **kw: (calls.append(kw), real(*a, **kw))[1]
        ff.flash_attention_fwd(q, q, q, causal=False, softcap=30.0)
        ff.flash_attention_fwd(q, q, q, causal=True, alibi_slopes=torch.ones(2))
        ff.flash_attention_fwd(q, q, q, causal=True)
    finally:
        ff.flash_fwd_general = real
    assert [c["softcap"] for c in calls] == [30.0, None]
    assert torch.equal(calls[1]["alibi_slopes"], torch.ones(2))
    qd, kd = torch.zeros((1, 4, 1, 64)), torch.zeros((1, 2, 64, 64))
    off = torch.zeros(1, dtype=torch.int32)
    assert ops.gqa_decode_attention(qd, kd, kd, off, softcap=30.0).shape == qd.shape
    with pytest.raises(NotImplementedError, match="pos_div"):
        ops.gqa_decode_attention(qd, kd, kd, off, alibi_slopes=torch.ones(4))


@pytest.mark.parametrize("kind", ["none", "int"])
def test_backward_route_with_transforms_takes_the_split_pair(kind, tmp_path, monkeypatch):
    """A softcap or ALiBi rules the triangular and the fused backward out in
    both routers (JAX ``flash_bwd.py:421-431, 496-508``), a saved "fused"
    decision included: the port's router gives the split pair."""
    n = 1024
    q = jnp.zeros((1, 2, n, 64), jnp.bfloat16)
    lse = jnp.zeros((1, 2, n, 128), jnp.float32)
    off = None if kind == "none" else 0
    ranks = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                ranks.append(len(eqn.params["grid_mapping"].grid))
            for val in eqn.params.values():
                sub = getattr(val, "jaxpr", None)
                if sub is not None:
                    walk(getattr(sub, "jaxpr", sub))

    walk(jax.make_jaxpr(lambda x, l: jax_bwd_auto(x, x, x, x, x, l, off, causal=True,
                                                  softcap=30.0, interpret=True))(q, lse).jaxpr)
    assert ranks == [4, 4]  # the split pair's dK/dV and dQ grids (tri: one 2-D grid)
    qt = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    assert fb.bwd_route(qt, qt, off, causal=True, transformed=True) == "split"
    # The untuned rule is the split pair (the H100's race), so the triangular
    # backward comes from a saved decision, which a transform declines too.
    cache = tmp_path / "fused.json"
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", str(cache))
    autotune.record_bwd((1, 2, 2, 8, 64), "tri", {}, cache_path=str(cache), device="cpu")
    assert fb.bwd_route(qt, qt, off, causal=True) == "tri"
    assert fb.bwd_route(qt, qt, off, causal=True, transformed=True) == "split"
    autotune.record_bwd((1, 2, 2, 8, 64), "fused", {}, cache_path=str(cache), device="cpu")
    autotune.reset_memo()
    try:
        assert fb.bwd_route(qt, qt, off, causal=True) == "fused"
        assert fb.bwd_route(qt, qt, off, causal=True, transformed=True) == "split"
        fused = fb.flash_attention_bwd_fused
        monkeypatch.setattr(fb, "flash_attention_bwd_fused",
                            lambda *a, **kw: pytest.fail("the fused backward took a transform"))
        lse_t = torch.zeros((1, 2, 8))
        grads = fb.flash_attention_bwd_auto(qt, qt, qt, qt, qt, lse_t, off, causal=True,
                                            alibi_slopes=torch.ones(2))
        assert len(grads) == 4
        monkeypatch.setattr(fb, "flash_attention_bwd_fused", fused)
    finally:
        autotune.reset_memo()
