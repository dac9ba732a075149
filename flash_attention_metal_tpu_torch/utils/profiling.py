"""Profiling and tracing helpers.

Counterpart of ``flash_attention_metal_tpu/utils/profiling.py``: where the
JAX package captures ``jax.profiler`` traces, the port records
``torch.profiler`` traces (CPU and CUDA activities; the CUDA kernels'
device time comes from CUPTI), viewable in Perfetto or
``chrome://tracing``, and reads the caching allocator's statistics.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU ops, and the card's kernels when CUDA is
    available) and write a Chrome trace ``trace.json`` under ``log_dir``::

        with trace("traces/attention") as prof:
            flash_attention(q, k, v)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a trace (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


def device_memory_stats(device: Optional[torch.device] = None) -> dict:
    """Live, peak and total bytes of a CUDA device's memory, for OOM
    debugging (``torch.cuda.memory_stats``; empty for a CPU device or
    without CUDA)."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }
