"""PyTorch port: FlashAttention V1 (the ladder's rung 2) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
``flash_attention_v1`` runs its Pallas kernels in interpret mode, as the
JAX tests do on the CPU; the port runs the kernels' plain version, which is
what its wrapper takes for CPU tensors.  The CUDA kernels run only on a
card: their tests are in ``test_torch_gpu.py``.

Tolerance: 1e-5 max-abs on the ladder's uniform(-1, 1) fixture (fp32
throughout; the JAX products are bf16 x 3, ~2^-16 relative, on outputs of
~0.05).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.kernels.flash_v1 import flash_attention_v1 as jax_v1
from flash_attention_metal_tpu_torch.kernels import flash_v1 as fv

TOL = 1e-5


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, shape).astype(np.float32) for _ in range(3)]


def _jax_grids(fn, *args):
    """The grid of every ``pallas_call`` the JAX function traces to."""
    grids = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                grids.append(tuple(eqn.params["grid_mapping"].grid))
            for val in eqn.params.values():
                sub = getattr(val, "jaxpr", None)
                if sub is not None:
                    walk(getattr(sub, "jaxpr", sub))

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return grids


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize(
    "shape,route",
    [((2, 2, 256, 64), "folded"), ((1, 2, 1024, 64), "stream")],
    ids=["folded_n256", "stream_n1024"],
)
def test_flash_v1_matches_jax(shape, route, causal):
    """(2, 2, 256): one KV block, two batch elements per step (the folded
    kernel); (1, 2, 1024): two 512-column KV blocks (the streaming one)."""
    q, k, v = _inputs(0, shape)
    assert fv.v1_route(shape[0], shape[2], shape[2])[0] == route
    want = jax_v1(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    got = fv.flash_attention_v1(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == shape
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL


@pytest.mark.parametrize("batch", [1, 2, 8, 512])
@pytest.mark.parametrize("n", [128, 256, 512, 1024])
def test_v1_route_matches_the_jax_branch(batch, n):
    """The JAX folded kernel has a 3-D grid ``(B / fold, H, 1)``, the
    streaming one a 4-D grid: the port's route and fold equal them."""
    spec = jax.ShapeDtypeStruct((batch, 1, n, 64), jnp.float32)
    (grid,) = _jax_grids(lambda q: jax_v1(q, q, q, interpret=True), spec)
    route, fold = fv.v1_route(batch, n, n)
    if len(grid) == 3:
        assert (route, fold) == ("folded", batch // grid[0])
    else:
        assert len(grid) == 4 and (route, fold) == ("stream", 1)


def test_v1_folds_the_sweep_batches_below_1024():
    """At the sweep's batches (B * N^2 = 2^23) N = 128, 256 and 512 fold 8,
    4 and 2 elements per step; N = 1024 streams."""
    assert [fv.v1_route(b, n, n) for b, n in ((512, 128), (128, 256), (32, 512), (8, 1024))] == [
        ("folded", 8), ("folded", 4), ("folded", 2), ("stream", 1)]


def test_causal_needs_equal_lengths_as_in_jax():
    q = np.zeros((1, 1, 128, 64), np.float32)
    k = np.zeros((1, 1, 256, 64), np.float32)
    with pytest.raises(ValueError, match="n_q == n_kv") as jax_err:
        jax_v1(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), causal=True, interpret=True)
    with pytest.raises(ValueError, match="n_q == n_kv") as port_err:
        fv.flash_attention_v1(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                              causal=True)
    assert str(port_err.value) == str(jax_err.value)


def test_indivisible_blocks_raise_as_in_jax():
    q = np.zeros((1, 1, 256, 64), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        jax_v1(*[jnp.asarray(q)] * 3, block_q=96, interpret=True)
    with pytest.raises(ValueError, match="divisible"):
        fv.flash_attention_v1(*[torch.from_numpy(q)] * 3, block_q=96)


def test_bf16_inputs_compute_in_fp32_and_return_bf16():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(1, (1, 2, 128, 64)))
    got = fv.flash_attention_v1(q, k, v, causal=True)
    want = fv.flash_attention_v1(q.float(), k.float(), v.float(), causal=True)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) < 1e-2
