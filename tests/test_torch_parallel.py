"""PyTorch port: ring, all-gather, lse-combine and Ulysses attention on a
gloo group of CPU ranks, against the JAX package's functions on its
virtual 8-device mesh, on the same numpy inputs.

One group of 8 ranks (``parallel.spawn``; the store under ``tmp_path``)
runs every case of ``tests/torch_dist_cases.py::attention_cases`` and the
ranks' shards are gathered here.  The JAX side runs its Pallas kernels in
interpret mode, as its own tests do (Ulysses through its XLA reference).
Tolerances: fp32 forward 2e-5, fp32 gradients 1e-4 of the largest
gradient (the standing fp32 parity floor), bf16 1e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from flash_attention_metal_tpu.parallel import (
    allgather_attention as jax_allgather,
    lse_combine_attention as jax_lse_combine,
    make_mesh as jax_make_mesh,
    make_ring_attention as jax_make_ring,
    merge_partials as jax_merge,
    ulysses_attention as jax_ulysses,
)
from flash_attention_metal_tpu_torch.harness import scaling
from flash_attention_metal_tpu_torch.parallel import merge_partials, spawn

import torch_dist_cases

SP = PartitionSpec(None, None, "sp", None)
FWD_TOL, GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 1e-2
N_RANKS = 8


def _uniform(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(20)
    q, k, v, co = (_uniform(rng, 1, 2, 512, 64) for _ in range(4))
    return dict(
        q=q, k=k, v=v, co=co, seed=7,
        gqa_q=_uniform(rng, 1, 4, 512, 64), gqa_k=_uniform(rng, 1, 2, 512, 64),
        gqa_v=_uniform(rng, 1, 2, 512, 64), gqa_co=_uniform(rng, 1, 4, 512, 64),
        dec_q=_uniform(rng, 1, 2, 128, 64), dec_k=_uniform(rng, 1, 2, 1024, 64),
        dec_v=_uniform(rng, 1, 2, 1024, 64),
        uly_q=_uniform(rng, 1, 8, 512, 64), uly_k=_uniform(rng, 1, 2, 512, 64),
        uly_v=_uniform(rng, 1, 2, 512, 64), uly_co=_uniform(rng, 1, 8, 512, 64),
        bad_k=_uniform(rng, 1, 3, 512, 64),
    )


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every rank's results, one spawned group for the module."""
    return spawn(torch_dist_cases.attention_cases, N_RANKS, (inputs,), backend="gloo",
                 device="cpu", workdir=str(tmp_path_factory.mktemp("parallel")), timeout_s=120)


def _cat(ranks, key, i=None, dim=2):
    parts = [r[key] if i is None else r[key][i] for r in ranks]
    return torch.cat(parts, dim).float().numpy()


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _grad_err(got, want):
    return _max_diff(got, want) / float(np.max(np.abs(np.asarray(want, np.float32))))


def _jax_vjp(fn, q, k, v, co):
    """JAX's ``(o, dq, dk, dv)`` of ``sum(fn(q, k, v) * co)``."""
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return (o, *vjp(jnp.asarray(co, o.dtype)))


def _mesh():
    return jax_make_mesh((1, 1, N_RANKS))


def _shard_mapped(fn, in_specs=(SP, SP, SP), out_specs=SP):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(), in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


@pytest.mark.parametrize("empty", ["none", "b", "both"])
def test_merge_partials_matches_jax_with_empty_sides(empty):
    rng = np.random.default_rng(3)
    o_a, o_b = _uniform(rng, 1, 2, 64, 64), _uniform(rng, 1, 2, 64, 64)
    lse_a, lse_b = _uniform(rng, 1, 2, 64, 1) * 4, _uniform(rng, 1, 2, 64, 1) * 4
    if empty in ("b", "both"):
        o_b[:], lse_b[:] = 0.0, -np.inf
    if empty == "both":
        o_a[:], lse_a[:] = 0.0, -np.inf
    got = merge_partials(*(torch.from_numpy(x) for x in (o_a, lse_a, o_b, lse_b)))
    want = jax_merge(*(jnp.asarray(x) for x in (o_a, lse_a, o_b, lse_b)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.array_equal(np.isneginf(g.numpy()), np.isneginf(w))
        fin = np.isfinite(w)
        if fin.any():
            assert _max_diff(g.numpy()[fin], w[fin]) < 1e-6
    if empty == "b":
        assert np.array_equal(got[0].numpy(), o_a)
    if empty == "both":
        assert float(got[0].abs().max()) == 0.0 and bool(torch.isneginf(got[1]).all())


@pytest.mark.parametrize("causal", [False, True])
def test_ring_forward_and_gradients_match_jax(ranks, inputs, causal):
    x = [inputs[n] for n in ("q", "k", "v", "co")]
    ring = jax_make_ring(_mesh(), "sp", causal=causal, differentiable=True)
    want = _jax_vjp(ring, *x)
    fwd = f"ring_fwd_causal{int(causal)}"
    o, lse = _cat(ranks, fwd, 0), _cat(ranks, fwd, 1)
    assert _max_diff(o, want[0]) < FWD_TOL
    want_lse = jax.jit(jax.shard_map(
        functools.partial(_jax_ring_lse, causal=causal), mesh=_mesh(), in_specs=(SP, SP, SP),
        out_specs=PartitionSpec(None, None, "sp"), check_vma=False))(*map(jnp.asarray, x[:3]))
    assert _max_diff(lse, want_lse) < FWD_TOL
    key = f"ring_grad_causal{int(causal)}"
    assert _max_diff(_cat(ranks, key, 0), want[0]) < FWD_TOL
    for i, name in enumerate("qkv"):
        assert _grad_err(_cat(ranks, key, i + 1), want[i + 1]) < GRAD_TOL, name


def _jax_ring_lse(q, k, v, causal):
    from flash_attention_metal_tpu.parallel import ring_flash_attention

    return ring_flash_attention(q, k, v, axis_name="sp", axis_size=N_RANKS, causal=causal,
                                save_lse=True)[1]


def test_ring_gqa_gradients_match_jax(ranks, inputs):
    """GQA stays native in the port's reverse ring; JAX repeats K/V."""
    x = [inputs[n] for n in ("gqa_q", "gqa_k", "gqa_v", "gqa_co")]
    want = _jax_vjp(jax_make_ring(_mesh(), "sp", causal=True, differentiable=True), *x)
    assert _max_diff(_cat(ranks, "ring_gqa", 0), want[0]) < FWD_TOL
    for i, name in enumerate("qkv"):
        assert _grad_err(_cat(ranks, "ring_gqa", i + 1), want[i + 1]) < GRAD_TOL, name


def test_ring_dropout_matches_jax_at_global_mask_coordinates(ranks, inputs):
    x = [inputs[n] for n in ("q", "k", "v", "co")]
    ring = jax_make_ring(_mesh(), "sp", causal=True, differentiable=True, dropout_rate=0.1)
    seed = jnp.asarray(inputs["seed"], jnp.int32)
    want = _jax_vjp(lambda q, k, v: ring(q, k, v, seed), *x)
    assert _max_diff(_cat(ranks, "ring_dropout", 0), want[0]) < FWD_TOL
    for i, name in enumerate("qkv"):
        assert _grad_err(_cat(ranks, "ring_dropout", i + 1), want[i + 1]) < GRAD_TOL, name


def test_ring_bf16_and_reference_match_jax(ranks, inputs):
    x = [inputs[n] for n in ("q", "k", "v")]
    want = jax_make_ring(_mesh(), "sp", causal=True)(*(jnp.asarray(a, jnp.bfloat16) for a in x))
    got = torch.cat([r["ring_bf16"] for r in ranks], 2)
    assert got.dtype == torch.bfloat16
    assert _max_diff(got.float().numpy(), np.asarray(want, np.float32)) < BF16_TOL
    want_ref = jax_make_ring(_mesh(), "sp", causal=True, impl="xla")(*(jnp.asarray(a) for a in x))
    assert _max_diff(_cat(ranks, "ring_reference"), want_ref) < FWD_TOL


@pytest.mark.parametrize("case", ["causal0", "causal1", "dropout"])
def test_allgather_forward_and_gradients_match_jax(ranks, inputs, case):
    x = [inputs[n] for n in ("q", "k", "v", "co")]
    kw = dict(causal=case != "causal0")
    if case == "dropout":
        kw.update(dropout_rate=0.1, dropout_seed=jnp.asarray(inputs["seed"], jnp.int32))
    fn = _shard_mapped(functools.partial(jax_allgather, axis_name="sp", **kw))
    want = _jax_vjp(fn, *x)
    key = "allgather_dropout" if case == "dropout" else f"allgather_{case}"
    assert _max_diff(_cat(ranks, key, 0), want[0]) < FWD_TOL
    for i, name in enumerate("qkv"):
        assert _grad_err(_cat(ranks, key, i + 1), want[i + 1]) < GRAD_TOL, name


@pytest.mark.parametrize("causal", [False, True])
def test_lse_combine_matches_jax_in_the_decode_topology(ranks, inputs, causal):
    """Replicated queries, the K/V sequence sharded: every rank holds the
    combined output."""
    fn = _shard_mapped(functools.partial(jax_lse_combine, axis_name="sp", causal=causal),
                       in_specs=(PartitionSpec(), SP, SP), out_specs=PartitionSpec())
    want = fn(*(jnp.asarray(inputs[n]) for n in ("dec_q", "dec_k", "dec_v")))
    for r in ranks:
        assert _max_diff(r[f"lse_causal{int(causal)}"].numpy(), want) < FWD_TOL


def test_ulysses_with_replicated_gqa_kv_matches_jax(ranks, inputs):
    """8 q-heads and 2 K/V heads over 8 ranks: each K/V head is repeated 4
    times before the all-to-all."""
    x = [inputs[n] for n in ("uly_q", "uly_k", "uly_v", "uly_co")]
    fn = _shard_mapped(functools.partial(jax_ulysses, axis_name="sp", causal=True, impl="xla"))
    want = _jax_vjp(fn, *x)
    assert _max_diff(_cat(ranks, "ulysses", 0), want[0]) < FWD_TOL
    for i, name in enumerate("qkv"):
        assert _grad_err(_cat(ranks, "ulysses", i + 1), want[i + 1]) < GRAD_TOL, name


def test_ulysses_rejects_a_bad_head_ratio(ranks):
    """3 K/V heads over 8 ranks: neither divides the other, as in JAX."""
    for r in ranks:
        assert r["ulysses_bad_ratio"] is not None and "Ulysses" in r["ulysses_bad_ratio"]


def test_scaling_rows_on_shared_cpu_ranks_are_functional_checks(ranks, monkeypatch):
    """``harness/scaling.py``: its rank function runs the ring on the
    module's 8-rank group; ``run_scaling``, its groups stubbed with that
    group's time, gives a row per shard count, each labelled not meaningful
    (gloo or CPU ranks share a device; NCCL rows with more ranks than
    cards)."""
    median_s = ranks[0]["scaling"]["median_s"]
    assert median_s > 0
    calls = []

    def fake_spawn(fn, world_size, args, *, backend, device):
        calls.append((fn, world_size, args[0]["shards"], backend, device))
        return [{"median_s": median_s}] * world_size

    monkeypatch.setattr(scaling, "spawn", fake_spawn)
    for backend, device in (("gloo", "cpu"), ("nccl", "cpu"), ("nccl", "cuda")):
        logs, calls[:] = [], []
        rows = scaling.run_scaling(256, heads=2, shard_counts=(1, 2, 8), backend=backend,
                                   device=device, iters=1, log=logs.append)
        assert calls == [(scaling._ring_rank, c, c, backend, device) for c in (1, 2, 8)]
        assert [r["shards"] for r in rows] == [1, 2, 8]
        assert not any(r["meaningful"] for r in rows) and rows[0]["scaling_efficiency"] == 1.0
        assert all(r["ms"] > 0 and "not a scaling figure" in line for r, line in zip(rows, logs))
