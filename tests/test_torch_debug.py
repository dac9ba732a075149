"""PyTorch port: the numerics sanitizer (``utils/debug.py``) against the JAX
package's, and the profiling helpers (``utils/profiling.py``) on the CPU.

The same numpy trees go to both sanitizers: each must raise
``FloatingPointError`` on the same leaves, naming the same path, and pass
the same finite trees.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.utils import debug as jax_debug
from flash_attention_metal_tpu_torch.ops.attention import flash_attention
from flash_attention_metal_tpu_torch.utils import debug, profiling


def _trees(bad):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = np.ones(5, np.float32)
    if bad is not None:
        b[2] = bad
    tree = {"layers": [{"w": a}, {"w": b}], "step": np.array(3, np.int32)}
    jax_tree = {"layers": [{"w": jnp.asarray(a)}, {"w": jnp.asarray(b)}],
                "step": jnp.asarray(tree["step"])}
    torch_tree = {"layers": [{"w": torch.from_numpy(a)}, {"w": torch.from_numpy(b)}],
                  "step": torch.from_numpy(tree["step"])}
    return jax_tree, torch_tree


@pytest.mark.parametrize("bad", [None, np.nan, np.inf, -np.inf], ids=["finite", "nan", "inf", "-inf"])
def test_assert_all_finite_matches_jax(bad):
    jax_tree, torch_tree = _trees(bad)
    if bad is None:
        jax_debug.assert_all_finite(jax_tree, "params")
        debug.assert_all_finite(torch_tree, "params")
        return
    with pytest.raises(FloatingPointError) as want:
        jax_debug.assert_all_finite(jax_tree, "params")
    with pytest.raises(FloatingPointError) as got:
        debug.assert_all_finite(torch_tree, "params")
    for err in (want, got):
        assert "params" in str(err.value) and "layers" in str(err.value) and "(5,)" in str(err.value)
    assert "['layers'][1]['w']" in str(got.value)


def test_checked_raises_on_non_finite_outputs():
    """``checked`` passes a finite result through and raises on a NaN that a
    plain function would have propagated (the role of JAX's ``checkify``)."""
    q = torch.randn(1, 2, 64, 64, generator=torch.Generator().manual_seed(0))
    safe = debug.checked(lambda q: flash_attention(q, q, q, causal=True), name="attention")
    assert torch.equal(safe(q), flash_attention(q, q, q, causal=True))
    with pytest.raises(FloatingPointError, match="attention"):
        safe(q.index_fill(2, torch.tensor([3]), float("nan")))
    with pytest.raises(FloatingPointError, match="log"):
        debug.checked(torch.log)(torch.tensor([1.0, -1.0]))
    assert debug.checked(torch.exp)(torch.zeros(2)).tolist() == [1.0, 1.0]


def test_trace_annotate_and_memory_stats_on_the_cpu(tmp_path):
    """A CPU trace with a named region lands in a Chrome trace file; the
    memory statistics of a CPU device are empty."""
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("fam_region"):
            (x @ x).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "fam_region" for e in events)
    assert any(e.key == "fam_region" for e in prof.key_averages())
    assert profiling.device_memory_stats(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
