"""Sweep sizing shared by the benchmark.

Counterpart of ``flash_attention_metal_tpu/harness/benchmark.py``'s
``amortizing_batch``.  The CSV sweep (``run_sweep``, ``SweepRow``) is not
ported yet (ROADMAP.md, Queue A item 9).
"""

from __future__ import annotations


def amortizing_batch(n: int) -> int:
    """Batch of a sweep point at sequence length ``n``: B * N^2 ~ 2^23
    (B = 512 at N = 128 down to B = 1 from N = 4096), so every point is
    kernel work rather than the launch floor, for naive and flash alike."""
    return max(1, (1 << 23) // (n * n))
