"""The backward autotuner: race the backward kernels for a shape, keep the
winner, and let the backward router follow it.

Counterpart of the backward half of
``flash_attention_metal_tpu/harness/autotune.py`` (``_key``, ``_load``,
``_store``, ``bwd_candidates``, ``autotune_bwd``, ``lookup_bwd``, ``main``),
with ``record_bwd`` to store a decision by hand.
The port keeps its own cache, ``autotune_cache_torch.json``, never the JAX
package's v5e ``autotune_cache.json``.  Its key adds the KV head count to
the JAX key: the JAX op repeats K/V before its backward, so its kernels see
equal heads; the port's kernels take GQA natively, and a 16/8-head shape is
not a 16/16 one.  The candidates are the kernels the port has: the split
pair and the fused kernel (the tiles of both are fixed), and the
triangular kernel where it applies (causal, equal heads, not fp16).  The
router reads the decisions from ``DEFAULT_CACHE``, the one name of that
file.  The forward tuner, ``validate``, ``audit`` and ``lookup_fwd_impl``
are not ported (ROADMAP.md, Queue A item 9).

    python -m flash_attention_metal_tpu_torch.harness.autotune --phase train [--cache PATH] [--force]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels.flash_bwd import flash_attention_bwd, flash_attention_bwd_fused
from ..kernels.flash_fwd import flash_attention_fwd
from ..kernels.flash_tri import flash_attention_bwd_tri
from ..reference import make_qkv
from ..utils.roofline import detect_chip
from ..utils.timing import measure

DEFAULT_CACHE = "autotune_cache_torch.json"
# The training step's attention and the benchmark's high-occupancy shape:
# (batch, q-heads, KV heads, N, head dim), tuned by ``--phase train``.
TRAIN_SHAPES = ((4, 16, 8, 2048, 64), (16, 8, 8, 2048, 64))
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.float16: "float16"}


def device_name(device) -> str:
    """The key's device field: the card's name as ``detect_chip`` reports
    it, or ``"cpu"`` for the plain versions."""
    device = torch.device(device)
    return "cpu" if device.type == "cpu" else detect_chip(device).name


def _key(kind: str, b, h, h_kv, n_q, n_kv, d, causal, dtype, device="cuda") -> str:
    return (
        f"{device_name(device)}/{kind}/b{b}h{h}kv_heads{h_kv}q{n_q}kv{n_kv}d{d}"
        f"/causal{int(causal)}/{_DTYPE_NAMES[dtype]}"
    )


def _load(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _store(path: str, cache: dict) -> None:
    with open(path, "w") as f:
        json.dump(cache, f, indent=2, sort_keys=True)


def bwd_candidates(h: int, h_kv: int, causal: bool, dtype) -> List[Tuple[str, dict]]:
    """``(impl, blocks)`` candidates: the split pair, the fused kernel, the
    triangular kernel where it applies.  No kernel of the port has a tile
    to tune yet: every ``blocks`` is empty."""
    out = [("split", {}), ("fused", {})]
    if causal and h == h_kv and dtype != torch.float16:
        out.append(("tri", {}))
    return out


def _host_seconds(fn: Callable[[], object], iters: int) -> float:
    """Median host seconds of ``fn`` (the CPU route: the plain versions)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _candidate_fn(impl: str, causal: bool):
    if impl == "tri":
        return flash_attention_bwd_tri
    if impl == "fused":
        return functools.partial(flash_attention_bwd_fused, causal=causal)
    return functools.partial(flash_attention_bwd, causal=causal)


def autotune_bwd(
    shape: Sequence[int],
    *,
    causal: bool = True,
    dtype=torch.bfloat16,
    cache_path: Optional[str] = None,
    force: bool = False,
    device="cuda",
    iters: int = 10,
    log=print,
) -> Tuple[str, dict]:
    """Race the backward candidates for ``(B, H, H_kv, N, D)`` and store the
    fastest under its key; returns ``(impl, blocks)``.  A stored decision is
    returned as it is unless ``force``.  On a card each candidate's time is
    the median device time (``utils/timing.measure``); ``device="cpu"``
    races the plain versions on the host clock, under the key ``cpu/...``.
    """
    b, h, h_kv, n, d = shape
    path = DEFAULT_CACHE if cache_path is None else cache_path
    key = _key("bwd", b, h, h_kv, n, n, d, causal, dtype, device)
    cache = _load(path)
    if key in cache and not force:
        return cache[key]["impl"], dict(cache[key]["blocks"])
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    q = make_qkv(gen, (b, h, n, d), dtype=dtype)[0]
    k, v = make_qkv(gen, (b, h_kv, n, d), dtype=dtype)[1:]
    o, lse = flash_attention_fwd(q, k, v, causal=causal, save_lse=True)
    do = q * 0.01
    args = (q, k, v, o, do, lse)
    times: Dict[str, float] = {}
    best = None
    for impl, blocks in bwd_candidates(h, h_kv, causal, dtype):
        fn = _candidate_fn(impl, causal)
        if torch.device(device).type == "cpu":
            t = _host_seconds(lambda: fn(*args), iters)
        else:
            t = measure(fn, args, iters=iters)["median_s"]
        times[impl] = t * 1e6
        log(f"  bwd {key} {impl}: {t * 1e6:.1f} us")
        if best is None or t < best[2]:
            best = (impl, blocks, t)
    impl, blocks, t = best
    record_bwd(shape, impl, blocks, causal=causal, dtype=dtype, cache_path=path, device=device,
               us=t * 1e6, raced_us=times)
    return impl, blocks


def record_bwd(shape: Sequence[int], impl: str, blocks: dict, *, causal: bool = True,
               dtype=torch.bfloat16, cache_path: Optional[str] = None, device="cuda",
               **extra) -> None:
    """Store ``(impl, blocks)`` as the backward decision for ``(B, H, H_kv,
    N, D)`` (with ``extra`` fields beside it); the router follows it from
    the next lookup on."""
    if impl not in ("split", "fused", "tri"):
        raise ValueError(f"unknown backward impl {impl!r}")
    b, h, h_kv, n, d = shape
    path = DEFAULT_CACHE if cache_path is None else cache_path
    cache = _load(path)
    cache[_key("bwd", b, h, h_kv, n, n, d, causal, dtype, device)] = {
        "impl": impl, "blocks": dict(blocks), **extra}
    _store(path, cache)
    _MEMO.pop(path, None)


# Loaded caches by path, read once per process; ``reset_memo`` forgets them.
_MEMO: Dict[str, dict] = {}


def reset_memo() -> None:
    """Forget the loaded caches, so the next lookup reads the file again."""
    _MEMO.clear()


def lookup_bwd(b, h, h_kv, n_q, n_kv, d, causal, dtype, *,
               device="cuda") -> Optional[Tuple[str, dict]]:
    """``(impl, blocks)`` saved for this shape on this device, or None.

    ``impl`` is ``"split"``, ``"fused"`` or ``"tri"``.  The cache is
    ``DEFAULT_CACHE`` as it names a file when the lookup is made; without
    that file every lookup misses, and no device name is asked for.
    """
    path = DEFAULT_CACHE
    if path not in _MEMO:
        _MEMO[path] = _load(path)
    cache = _MEMO[path]
    if not cache:
        return None
    entry = cache.get(_key("bwd", b, h, h_kv, n_q, n_kv, d, causal, dtype, device))
    if entry is None:
        return None
    if entry["impl"] not in ("split", "fused", "tri"):
        raise ValueError(f"unknown backward impl {entry['impl']!r} in {path}")
    if entry["blocks"]:
        raise ValueError(f"backward tiles {entry['blocks']} in {path}: the tiles of the "
                         "port's backward kernels are built in")
    return entry["impl"], {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default=DEFAULT_CACHE)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--phase", default="train", choices=("train",),
                    help="the shapes to tune: the training step's and the high-occupancy one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in TRAIN_SHAPES:
        impl, blocks = autotune_bwd(shape, cache_path=args.cache, force=args.force)
        print(f"bwd {shape} on {torch.cuda.get_device_name(0)}: {impl} {blocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
