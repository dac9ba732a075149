"""PyTorch port: the benchmark's and the ladder's entry points on the CPU.

What a CPU run can show of them: the port's verification ladder passes
every ported rung on the kernels' plain versions, the sweep's sizing and
the roofline's counts equal the JAX package's, the paired timer's
arithmetic, the bench's output contract and its refusal without a card,
the entry points' device defaults, and the op's tensor offsets.
"""

import importlib.util
import inspect
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.harness.benchmark import amortizing_batch as jax_amortizing_batch
from flash_attention_metal_tpu.utils.roofline import attention_bytes as jax_attention_bytes
from flash_attention_metal_tpu.utils.roofline import attention_flops as jax_attention_flops
from flash_attention_metal_tpu_torch import bench, flash_attention
from flash_attention_metal_tpu_torch.harness import verify
from flash_attention_metal_tpu_torch.harness.benchmark import amortizing_batch
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels import flash_tri as ft
from flash_attention_metal_tpu_torch.models import from_jax, trainer
from flash_attention_metal_tpu_torch.models import transformer as tf
from flash_attention_metal_tpu_torch.utils import roofline
from flash_attention_metal_tpu_torch.utils.timing import measure_kernel_pair


def test_run_ladder_on_cpu_passes_every_ported_rung():
    lines = []
    results = verify.run_ladder(n=256, device="cpu", log=lines.append)
    assert len(results) == 35 and all(r.passed for r in results), [r.line() for r in results]
    assert [r.name for r in results][:3] == [
        "naive vs oracle (fp32)", "flash_v1 vs naive (fp32)", "flash_v2 vs naive (fp32)"]
    # Every rung runs now: no SKIP line (the dropout rungs 24-25 were the
    # last to wait), and they come last under JAX's names.
    assert not [line for line in lines if line.startswith("[SKIP]")]
    assert [r.name for r in results][-2:] == list(verify.DROPOUT_RUNGS)
    # The transform rungs (13-17) run under JAX's names.
    assert [r.name for r in results if r.name in verify.TRANSFORM_RUNGS] == list(
        verify.TRANSFORM_RUNGS)
    assert all(line.startswith("[PASS]") for line in lines)


def _jax_rung_names() -> list:
    """A regular expression per ``rung(...)`` call of the JAX ladder: its
    name, with each f-string field matching any text."""
    import ast
    import re

    from flash_attention_metal_tpu.harness import verify as jax_verify

    patterns = []
    for node in ast.walk(ast.parse(inspect.getsource(jax_verify))):
        if not (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "rung"):
            continue
        name = node.args[0]
        parts = name.values if isinstance(name, ast.JoinedStr) else [name]
        patterns.append("".join(re.escape(p.value) if isinstance(p, ast.Constant) else ".+"
                                for p in parts))
    return patterns


def test_ladder_rungs_2_8_9_12_18_run_under_their_jax_names():
    """On the CPU at n = 256 the V1, 8-bit KV (int8, fp8), MQA, paged-KV
    (prefill, decode chunk) and GQA-backward rungs run and pass, each named
    as a rung of the JAX ladder; so is every other rung the port runs."""
    import re

    lines = []
    results = verify.run_ladder(n=256, device="cpu", log=lines.append)
    by_name = {r.name: r for r in results}
    assert all(by_name[name].passed for name in verify.RUNGS_2_8_9_12_18)
    assert not any(name in line for line in lines if line.startswith("[SKIP]")
                   for name in verify.RUNGS_2_8_9_12_18)
    patterns = _jax_rung_names()
    assert len(patterns) > 30
    for name in by_name:
        assert any(re.fullmatch(p, name) for p in patterns), name


def test_rung_11_passes_under_its_jax_name_at_n1024():
    """The block-sparse rung at the ladder's default length: JAX's mask and
    name, its block density 0.44, within the half-precision tolerance."""
    lines = []
    results = verify.run_ladder(n=1024, device="cpu", log=lines.append)
    (rung,) = [r for r in results if r.name.startswith("flash block-sparse mask")]
    assert rung.name == "flash block-sparse mask (density 0.44) vs oracle"
    assert rung.passed and rung.tolerance == verify.TOL_HALF
    assert rung.line() in lines and rung.line().startswith("[PASS]")


def test_rung_line_format_matches_jax():
    from flash_attention_metal_tpu.harness.verify import RungResult as JaxRungResult

    for diff, nan in ((1.5e-4, False), (0.2, False), (1e-5, True)):
        ours = verify.RungResult("x vs y", diff, 1e-3, nan)
        theirs = JaxRungResult("x vs y", diff, 1e-3, nan)
        assert ours.line() == theirs.line() and ours.passed == theirs.passed


def test_verify_main_runs_the_cpu_ladder_and_refuses_a_missing_card(capsys):
    assert verify.main(["--n", "128", "--device", "cpu"]) == 0
    assert "ALL PASS (35/35)" in capsys.readouterr().out
    assert verify.main([]) == 1  # the default device is the card


def test_amortizing_batch_matches_jax():
    assert [amortizing_batch(n) for n in bench.SWEEP] == [512, 128, 32, 8, 2, 1, 1]
    for n in (*bench.SWEEP, 16384, 100):
        assert amortizing_batch(n) == jax_amortizing_batch(n)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_flop_and_byte_counts_match_jax(causal, backward):
    for n in bench.SWEEP:
        b = amortizing_batch(n)
        for args in ((b, 1, n, n, 64), (16, 8, n, 2 * n, 64)):
            assert roofline.attention_flops(*args, causal=causal, backward=backward) == \
                jax_attention_flops(*args, causal=causal, backward=backward)
            assert roofline.attention_bytes(*args, 2) == jax_attention_bytes(*args, 2)


def test_roofline_against_the_h100_peaks():
    spec = roofline.CHIP_SPECS["h100-sxm"]
    # The high-occupancy forward: 68.7 GFLOP on the tensor cores, ~0.069 ms.
    flops = roofline.attention_flops(16, 8, 2048, 2048, 64, causal=True)
    nbytes = roofline.attention_bytes(16, 8, 2048, 2048, 64, 2)
    assert roofline.roofline_time(flops, nbytes, spec) == pytest.approx(flops / 989e12)
    assert roofline.bound_by(flops, nbytes, spec) == "operations"
    # The N = 128, B = 512 point is bound by its bytes; fp32 by the FMA peak.
    flops = roofline.attention_flops(512, 1, 128, 128, 64)
    nbytes = roofline.attention_bytes(512, 1, 128, 128, 64, 2)
    assert roofline.bound_by(flops, nbytes, spec) == "bytes"
    assert roofline.roofline_time(flops, nbytes, spec, 32) == pytest.approx(flops / 67e12)
    assert roofline.roofline_fraction(2e-3, flops, nbytes, spec, 32) == pytest.approx(
        flops / 67e12 / 2e-3)
    # Visible pairs of a causal call: the square's lower triangle, and a
    # prefill chunk at offset 512.
    assert roofline.visible_pairs(4, 4, 0) == 10
    assert roofline.visible_pairs(512, 2048, 512) == sum(r + 513 for r in range(512))
    assert roofline.visible_pairs(4, 4, -2) == 3


def test_measure_kernel_pair_on_an_injected_clock():
    """A and B alternate within each repeat; the ratio is the median of the
    per-repeat ratios, not the ratio of the medians."""
    a_times, b_times, calls = [2.0, 9.0, 3.0], [1.0, 3.0, 2.0], []

    def timer(fn, args, iters):
        calls.append(fn)
        return (a_times if fn is fa else b_times).pop(0)

    def fa():
        pass

    def fb():
        pass

    out = measure_kernel_pair(fa, (), fb, (), repeats=3, timer=timer)
    assert calls == [fa, fb] * 3
    assert out["ratio_samples"] == [1.5, 2.0, 3.0]
    assert out["ratio"] == 2.0
    assert out["a_s"] == 3.0 and out["b_s"] == 2.0
    assert out["a_samples"] == [2.0, 3.0, 9.0] and out["b_samples"] == [1.0, 2.0, 3.0]
    with pytest.raises(ValueError):
        measure_kernel_pair(fa, (), fb, (), repeats=0, timer=timer)


def test_bench_line_has_exactly_the_contract_keys():
    line = bench.result_line(8.0, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "card"}
    assert line["value"] == 8.0 and line["unit"] == "x"
    assert line["vs_baseline"] == round(8.0 / 3.56, 3)
    assert json.loads(json.dumps(line)) == line
    assert bench.geomean([2.0, 8.0]) == pytest.approx(4.0)


def test_bench_watchdog_prints_a_null_line_with_the_points_done(capsys):
    progress = {"sweep": [{"n": 128, "speedup": 7.5}], "sweep_causal": []}
    exited = threading.Event()
    codes = []
    dog = bench.Watchdog(0.01, "card", progress, exit_fn=lambda c: (codes.append(c), exited.set()))
    assert exited.wait(5.0)
    assert codes == [3]
    assert not dog.finish(bench.result_line(1.0, "card"))  # one line only
    line = json.loads(capsys.readouterr().out.strip())
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["points_done"] == [{"n": 128, "causal": False, "speedup": 7.5}]


def test_bench_finish_prints_the_line_once(capsys):
    dog = bench.Watchdog(60.0, "card", {}, exit_fn=lambda c: None)
    assert dog.finish(bench.result_line(5.0, "card"))
    assert not dog.finish(bench.result_line(6.0, "card"))
    assert json.loads(capsys.readouterr().out)["value"] == 5.0


def test_bench_and_chip_smoke_exit_nonzero_without_a_card(capsys):
    assert bench.main([]) == 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.main() == 1
    assert capsys.readouterr().out == ""  # no result line


def test_entry_points_default_to_the_card():
    def default(fn, name):
        return inspect.signature(fn).parameters[name].default

    assert default(trainer.Trainer.__init__, "device") == "cuda"
    assert default(trainer.synthetic_batches, "device") == "cuda"
    assert default(from_jax.params_from_jax, "device") == "cuda"
    assert default(verify.run_ladder, "device") == "cuda"


@pytest.fixture
def routes(monkeypatch):
    """Record which forward kernel wrapper each call reaches."""
    seen = []
    for name, module, attr in (("tri", ft, "flash_attention_tri"), ("lean", ff, "flash_fwd_lean"),
                               ("general", ff, "flash_fwd_general")):
        real = getattr(module, attr)

        def spy(*args, _name=name, _real=real, **kwargs):
            seen.append((_name, type(args[3]).__name__ if len(args) > 3 else None))
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, attr, spy)
    return seen


def test_op_passes_tensor_offsets_to_the_general_kernel(routes):
    """The op makes every offset an int32 [B] tensor, as the JAX op makes it
    an array: its forward never takes the triangular or lean kernel."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.uniform(-1, 1, (2, 4, 64, 64)).astype(np.float32))
               for _ in range(3))
    flash_attention(q, k, v, causal=True)
    flash_attention(q, k, v, 3, causal=True)
    flash_attention(q, k, v)
    q.requires_grad_(True)
    flash_attention(q, k, v, causal=True).sum().backward()
    assert routes == [("general", "Tensor")] * 4
    # The router itself still sends a static offset to the triangular kernel.
    del routes[:]
    ff.flash_attention_fwd(q.detach(), k, v, causal=True)
    assert routes == [("tri", None)]


def test_model_forward_without_grad_reaches_the_general_kernel(routes):
    cfg = tf.ModelConfig(vocab_size=64, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                         d_ff=128, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen)
    tokens = torch.randint(0, 64, (2, 32), generator=gen)
    with torch.no_grad():
        logits = tf.forward(params, tokens, cfg)
    assert logits.shape == (2, 32, 64)
    assert routes == [("general", "Tensor")] * cfg.n_layers
