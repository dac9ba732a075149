"""Dependency-free CSV -> SVG speedup/roofline plotter.

The port's own copy of ``flash_attention_metal_tpu/harness/plotting.py``
(the port imports nothing of the JAX package): the same SVG for the same
CSV (log2 N axis, one labelled polyline per kernel's speedup over naive,
and a roofline panel), with defaults that read the port's CSV
(``benchmark_results_torch.csv``) and write ``speedup_plot_torch.svg`` and
``roofline_plot_torch.svg``, never the JAX package's v5e files.

    python -m flash_attention_metal_tpu_torch.harness.plotting [CSV [SPEEDUP_SVG [ROOFLINE_SVG]]]
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

WIDTH, HEIGHT = 900, 520
MARGIN_L, MARGIN_R, MARGIN_T, MARGIN_B = 70, 30, 50, 60
SERIES_COLORS = ["#1f77b4", "#2ca02c", "#d62728", "#9467bd", "#ff7f0e"]


def parse_csv(path: str) -> Tuple[List[str], List[List[float]]]:
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    header = lines[0].split(",")
    rows = []
    for ln in lines[1:]:
        vals = []
        for cell in ln.split(","):
            vals.append(float(cell) if cell else math.nan)
        rows.append(vals)
    return header, rows


def _polyline(points: Sequence[Tuple[float, float]], color: str) -> str:
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in points)
    return (
        f'<polyline fill="none" stroke="{color}" stroke-width="2" '
        f'points="{pts}"/>'
    )


def generate_svg(
    ns: Sequence[int],
    series: Dict[str, List[float]],
    *,
    title: str,
    y_label: str,
    y_max: float = 0.0,
) -> str:
    """Render labeled polylines over a log2-N x-axis."""
    plot_w = WIDTH - MARGIN_L - MARGIN_R
    plot_h = HEIGHT - MARGIN_T - MARGIN_B
    x_lo, x_hi = math.log2(ns[0]), math.log2(ns[-1])
    if not y_max:
        y_max = max(
            (v for vs in series.values() for v in vs if not math.isnan(v)),
            default=1.0,
        ) * 1.15

    def sx(n):
        return MARGIN_L + (math.log2(n) - x_lo) / max(x_hi - x_lo, 1) * plot_w

    def sy(v):
        return MARGIN_T + (1 - v / y_max) * plot_h

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{WIDTH}" '
        f'height="{HEIGHT}" viewBox="0 0 {WIDTH} {HEIGHT}">',
        f'<rect width="{WIDTH}" height="{HEIGHT}" fill="white"/>',
        f'<text x="{WIDTH/2}" y="28" text-anchor="middle" '
        f'font-size="18" font-family="sans-serif">{title}</text>',
    ]
    # Axes + gridlines.
    for n in ns:
        x = sx(n)
        parts.append(
            f'<line x1="{x:.1f}" y1="{MARGIN_T}" x2="{x:.1f}" '
            f'y2="{MARGIN_T+plot_h}" stroke="#eee"/>'
        )
        parts.append(
            f'<text x="{x:.1f}" y="{MARGIN_T+plot_h+18}" text-anchor="middle" '
            f'font-size="11" font-family="sans-serif">{n}</text>'
        )
    n_ticks = 6
    for i in range(n_ticks + 1):
        v = y_max * i / n_ticks
        y = sy(v)
        parts.append(
            f'<line x1="{MARGIN_L}" y1="{y:.1f}" x2="{MARGIN_L+plot_w}" '
            f'y2="{y:.1f}" stroke="#eee"/>'
        )
        parts.append(
            f'<text x="{MARGIN_L-8}" y="{y+4:.1f}" text-anchor="end" '
            f'font-size="11" font-family="sans-serif">{v:.1f}</text>'
        )
    parts.append(
        f'<text x="18" y="{MARGIN_T+plot_h/2}" text-anchor="middle" '
        f'font-size="13" font-family="sans-serif" '
        f'transform="rotate(-90 18 {MARGIN_T+plot_h/2})">{y_label}</text>'
    )
    parts.append(
        f'<text x="{MARGIN_L+plot_w/2}" y="{HEIGHT-16}" text-anchor="middle" '
        f'font-size="13" font-family="sans-serif">sequence length N (log2)</text>'
    )
    # Series.
    for idx, (name, vals) in enumerate(series.items()):
        color = SERIES_COLORS[idx % len(SERIES_COLORS)]
        pts = [
            (sx(n), sy(v))
            for n, v in zip(ns, vals)
            if not math.isnan(v)
        ]
        if not pts:
            continue
        parts.append(_polyline(pts, color))
        for (x, y), (n, v) in zip(
            pts, [(n, v) for n, v in zip(ns, vals) if not math.isnan(v)]
        ):
            parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="3" fill="{color}"/>')
        # Legend entry.
        ly = MARGIN_T + 10 + idx * 18
        lx = MARGIN_L + plot_w - 180
        parts.append(
            f'<line x1="{lx}" y1="{ly}" x2="{lx+24}" y2="{ly}" '
            f'stroke="{color}" stroke-width="3"/>'
        )
        parts.append(
            f'<text x="{lx+30}" y="{ly+4}" font-size="12" '
            f'font-family="sans-serif">{name}</text>'
        )
    parts.append("</svg>")
    return "\n".join(parts)


def plot_benchmark_csv(
    csv_path: str = "benchmark_results_torch.csv",
    out_path: str = "speedup_plot_torch.svg",
    roofline_out_path: str = "roofline_plot_torch.svg",
) -> None:
    header, rows = parse_csv(csv_path)
    col = {name: i for i, name in enumerate(header)}
    ns = [int(r[col["N"]]) for r in rows]

    speedups = {
        "FlashV1": [r[col["SpeedupV1"]] for r in rows],
        "FlashV2": [r[col["SpeedupV2"]] for r in rows],
        "FlashMXU": [r[col["SpeedupMXU"]] for r in rows],
    }
    svg = generate_svg(
        ns,
        speedups,
        title="Flash attention speedup vs naive kernel (H100)",
        y_label="speedup (x)",
    )
    with open(out_path, "w") as f:
        f.write(svg)

    rooflines = {
        "MXU non-causal": [r[col["Roofline_MXU"]] for r in rows],
        "MXU causal": [r[col["Roofline_MXU_causal"]] for r in rows],
    }
    svg2 = generate_svg(
        ns,
        rooflines,
        title="Fraction of roofline (speed-of-light)",
        y_label="fraction of roofline",
        y_max=1.0,
    )
    with open(roofline_out_path, "w") as f:
        f.write(svg2)


if __name__ == "__main__":
    import sys

    paths = sys.argv[1:] + list(plot_benchmark_csv.__defaults__)[len(sys.argv[1:]):]
    plot_benchmark_csv(*paths)
    print(f"wrote {paths[1]}, {paths[2]}")
