"""PyTorch port: the reference benchmark's sweep and its plotter against the
JAX package's.

What a CPU run can show: the CSV schema and row format equal the JAX
package's byte for byte, the sweep runs every column's function (their
plain versions) and leaves the times blank (a CPU run measures no device
time), an injected clock flows into the speedup, TF/s and CSV columns, the
high-occupancy phase's spot check, the refusal without a card, and the
port's own copy of the plotter gives the JAX plotter's SVG.
"""

import inspect

import pytest

from flash_attention_metal_tpu.harness import benchmark as jax_benchmark
from flash_attention_metal_tpu.harness import plotting as jax_plotting
from flash_attention_metal_tpu_torch.harness import benchmark, plotting
from flash_attention_metal_tpu_torch.kernels import flash_v1 as fv


def test_csv_schema_and_sweep_match_jax():
    assert benchmark.CSV_HEADER == jax_benchmark.CSV_HEADER
    assert benchmark.DEFAULT_SWEEP == jax_benchmark.DEFAULT_SWEEP
    assert benchmark.NAIVE_MAX_N == jax_benchmark.NAIVE_MAX_N
    assert [f.name for f in benchmark.SweepRow.__dataclass_fields__.values()] == \
        [f.name for f in jax_benchmark.SweepRow.__dataclass_fields__.values()]


@pytest.mark.parametrize(
    "values",
    [
        (128, 512, 0.73481, 0.2511, 0.33312, 0.1253, 0.0981, 2.926, 2.205, 5.864, 17.14, 10.9,
         0.1234, 0.0711),
        (16384, 1, None, 9.0, 8.5, 1.25, 0.8, None, None, None, 56.3, 43.98, 0.0569, 0.0444),
    ],
    ids=["paired", "past_naive"],
)
def test_sweep_row_csv_matches_jax(values):
    assert benchmark.SweepRow(*values).csv() == jax_benchmark.SweepRow(*values).csv()


def test_run_sweep_on_the_cpu_gives_well_formed_rows():
    lines = []
    rows = benchmark.run_sweep((128, 256), device="cpu", log=lines.append)
    assert [(r.n, r.b) for r in rows] == [(128, 1), (256, 1)]
    for row, line in zip(rows, lines):
        cells = line.split(",")
        assert line == row.csv() and len(cells) == len(benchmark.CSV_HEADER.split(","))
        assert cells[:2] == [str(row.n), "1"] and all(c == "" for c in cells[2:])


def test_run_sweep_columns_from_an_injected_clock():
    """Naive takes 4 ms, every flash column 1 ms (causal too): speedups 4,
    TF/s from the model flop count, no roofline without a card's spec.
    Past NAIVE_MAX_N the naive and speedup cells stay empty."""

    def timer(fn, args, iters):
        return 4e-3 if fn is benchmark.naive_attention else 1e-3

    (row,) = benchmark.run_sweep((256,), device="cpu", timer=timer, log=lambda s: None)
    assert (row.naive_ms, row.v1_ms, row.v2_ms, row.mxu_ms, row.mxu_causal_ms) == (4, 1, 1, 1, 1)
    assert row.speedup_v1 == row.speedup_v2 == row.speedup_mxu == 4.0
    assert row.tflops_mxu == pytest.approx(4 * 256 * 256 * 64 / 1e-3 / 1e12)
    assert row.tflops_mxu_causal == pytest.approx(row.tflops_mxu / 2)
    assert row.roofline_mxu is None
    (far,) = benchmark.run_sweep((8320,), device="cpu", timer=timer, log=lambda s: None)
    assert far.naive_ms is None and far.speedup_mxu is None and far.v1_ms == 1.0
    assert far.csv().split(",")[2] == ""


def test_sweep_runs_v1_through_its_jax_route():
    """At the sweep's card batches N = 128 folds 8 elements per step and
    N = 1024 streams; the CPU sweep's batch 1 streams at every N."""
    assert fv.v1_route(benchmark.amortizing_batch(128), 128, 128) == ("folded", 8)
    assert fv.v1_route(benchmark.amortizing_batch(1024), 1024, 1024) == ("stream", 1)
    assert fv.v1_route(1, 128, 128) == ("stream", 1)


def test_high_occupancy_on_the_cpu_passes_its_spot_check():
    logs = []
    out = benchmark.run_high_occupancy(batch=2, heads=2, n=256, device="cpu", log=logs.append)
    assert out["bwd_verify_pass"] and out["bwd_verify_max_diff"] < benchmark.BWD_SPOT_TOL
    assert out["fwd_ms"] is None and out["bwd_tflops"] is None
    assert logs[0].startswith("[PASS] high-occupancy backward vs oracle (B=2 slice)")
    assert set(out) == {"batch", "heads", "n", "fwd_ms", "bwd_ms", "bwd_verify_max_diff",
                        "bwd_verify_pass", "fwd_tflops", "bwd_tflops", "fwd_roofline",
                        "bwd_roofline"}


def test_main_refuses_a_missing_card(tmp_path, capsys):
    csv = tmp_path / "out.csv"
    assert benchmark.main(["--quick", "--csv", str(csv)]) == 1
    assert not csv.exists() and capsys.readouterr().out == ""


def test_outputs_are_the_ports_own_files():
    assert benchmark.DEFAULT_CSV == "benchmark_results_torch.csv"
    defaults = inspect.signature(plotting.plot_benchmark_csv).parameters
    assert [p.default for p in defaults.values()] == [
        "benchmark_results_torch.csv", "speedup_plot_torch.svg", "roofline_plot_torch.svg"]


CSV = benchmark.CSV_HEADER + """
128,512,0.7348,0.2511,0.3331,0.1253,0.0981,2.9260,2.2050,5.8640,17.14,10.90,0.123,0.071
1024,8,0.7348,0.2000,0.3000,0.1253,0.0981,3.6740,2.4490,5.8640,17.14,10.90,0.123,0.071
16384,1,,9.0000,8.5000,1.2500,0.8000,,,,56.30,43.98,0.057,0.044
"""


def test_plotting_copy_gives_the_jax_svg(tmp_path):
    path = tmp_path / "sweep.csv"
    path.write_text(CSV)
    header, rows = plotting.parse_csv(str(path))
    jax_header, jax_rows = jax_plotting.parse_csv(str(path))
    assert header == jax_header and str(rows) == str(jax_rows)  # nan == nan as text
    ns = [int(r[0]) for r in rows]
    for series, kw in (
        ({"FlashV1": [r[7] for r in rows], "FlashMXU": [r[9] for r in rows]},
         dict(title="speedup", y_label="x")),
        ({"MXU": [r[12] for r in rows]}, dict(title="roofline", y_label="f", y_max=1.0)),
    ):
        assert plotting.generate_svg(ns, series, **kw) == jax_plotting.generate_svg(ns, series, **kw)
    outs = [tmp_path / "a.svg", tmp_path / "b.svg", tmp_path / "c.svg", tmp_path / "d.svg"]
    plotting.plot_benchmark_csv(str(path), str(outs[0]), str(outs[1]))
    jax_plotting.plot_benchmark_csv(str(path), str(outs[2]), str(outs[3]))
    # The same SVGs but for the speedup panel's title, which names the card.
    assert outs[1].read_text() == outs[3].read_text()
    assert outs[0].read_text().replace("(H100)", "(TPU)") == outs[2].read_text()
