"""The autotuner: race the port's kernels for a shape, keep the winner, and
let the forward and backward routers follow it.

Counterpart of ``flash_attention_metal_tpu/harness/autotune.py``:
``_key``, ``_load``, ``_store``, ``fwd_candidates``, ``tri_candidates``,
``autotune_fwd``, ``bwd_candidates``, ``autotune_bwd``, ``validate``,
``audit``, ``lookup``, ``lookup_fwd_impl``, ``lookup_bwd`` and ``main``, with
``record_fwd`` / ``record_bwd`` to store a decision by hand.
The port keeps its own cache, ``autotune_cache_torch.json``, never the JAX
package's v5e ``autotune_cache.json``.  Its key adds the KV head count to
the JAX key: the JAX op repeats K/V before its backward, so its kernels see
equal heads; the port's kernels take GQA natively, and a 16/8-head shape is
not a 16/16 one.  No kernel of the port has a tile to tune (the JAX tuner's
candidates are Mosaic block sizes): the candidates are whole kernels.
Forward: the general kernel always, the triangular kernel for a causal
shape, the lean kernel for a non-causal one whose KV row fits its block
(``fwd_candidates``).  Backward: the split pair and the fused kernel, and
the triangular kernel where it applies (causal, equal heads, not fp16).
The routers read the decisions from ``DEFAULT_CACHE``, the one name of that
file, and decline a decision that does not apply to the call.

    python -m flash_attention_metal_tpu_torch.harness.autotune --phase train|sweep|sweep-causal|validate|audit|all [--cache PATH] [--force]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels.flash_bwd import (
    UNTUNED_BWD_ROUTE,
    flash_attention_bwd,
    flash_attention_bwd_fused,
)
from ..kernels.flash_fwd import (
    LEAN_MAX_KV,
    flash_attention_fwd,
    flash_fwd_general,
    flash_fwd_lean,
    fwd_route,
)
from ..kernels.flash_tri import flash_attention_bwd_tri, flash_attention_tri
from ..reference import make_qkv
from ..utils.roofline import detect_chip
from ..utils.timing import measure, measure_kernel_pair

DEFAULT_CACHE = "autotune_cache_torch.json"
# The training step's attention and the benchmark's high-occupancy shape:
# (batch, q-heads, KV heads, N, head dim), tuned by ``--phase train``.
TRAIN_SHAPES = ((4, 16, 8, 2048, 64), (16, 8, 8, 2048, 64))
# ``--phase train`` races each of TRAIN_SHAPES at these head dims.
RACE_HEAD_DIMS = (64, 128)
FWD_IMPLS = ("general", "lean", "tri")
BWD_IMPLS = ("split", "fused", "tri")
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.float16: "float16"}
_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}
_KEY_RE = re.compile(
    r"(?P<dev>.+)/(?P<kind>fwd|bwd)/b(\d+)h(\d+)kv_heads(\d+)q(\d+)kv(\d+)d(\d+)"
    r"/causal([01])/(\w+)$")

# timer(fn, args, iters) -> seconds: replaces the clock (the tests inject one).
Timer = Callable[[Callable[..., object], Sequence, int], float]


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


def _parse_key(key: str) -> Optional[dict]:
    """The fields of a key ``_key`` wrote, or None for another string."""
    m = _KEY_RE.match(key)
    if m is None or m.group(10) not in _DTYPES:
        return None
    b, h, h_kv, n_q, n_kv, d = (int(m.group(i)) for i in range(3, 9))
    return dict(device=m.group("dev"), kind=m.group("kind"), b=b, h=h, h_kv=h_kv, n_q=n_q,
                n_kv=n_kv, d=d, causal=m.group(9) == "1", dtype=_DTYPES[m.group(10)])


def _load(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _store(path: str, cache: dict) -> None:
    with open(path, "w") as f:
        json.dump(cache, f, indent=2, sort_keys=True)


def tri_candidates(n: int) -> List[str]:
    """The triangular forward's candidates at sequence length ``n``:
    ``["tri"]`` at every ``n``.

    The JAX list holds Mosaic tiles ``(block_q, block_k, pv_transposed)``
    under an unroll cap, and none past its compile wall (``_TRI_MAX_N``).
    The port's triangular kernel is the general forward's ``wgmma`` kernel
    given one int offset: its 64-row tiles are built in, nothing is
    unrolled, and it takes every N.  So it is one candidate, and this list
    folds into ``fwd_candidates``."""
    del n
    return ["tri"]


def fwd_candidates(n_q: int, n_kv: int, causal: bool) -> List[str]:
    """The forward kernels that compute a plain call of this shape (a static
    offset, no feature): the general kernel always; the triangular kernel
    when causal (``tri_candidates``); the lean kernel when not causal and
    the KV row fits its block (``n_kv <= LEAN_MAX_KV``)."""
    out = ["general"]
    if causal:
        out += tri_candidates(n_q)
    elif n_kv <= LEAN_MAX_KV:
        out.append("lean")
    return out


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


def _host_timer(fn, args, iters: int) -> float:
    return _host_seconds(lambda: fn(*args), iters)


def _seconds(fn, args, device, iters: int) -> float:
    """Median seconds of ``fn(*args)``: device time on a card, the host
    clock for the CPU's plain versions."""
    if torch.device(device).type == "cpu":
        return _host_timer(fn, args, iters)
    return measure(fn, args, iters=iters)["median_s"]


def _fwd_fn(impl: str, causal: bool):
    if impl == "tri":
        return flash_attention_tri
    if impl == "lean":
        return functools.partial(flash_fwd_lean, causal=causal)
    if impl == "general":
        return functools.partial(flash_fwd_general, causal=causal)
    raise ValueError(f"unknown forward impl {impl!r}")


def _bwd_fn(impl: str, causal: bool):
    if impl == "tri":
        return flash_attention_bwd_tri
    if impl == "fused":
        return functools.partial(flash_attention_bwd_fused, causal=causal)
    if impl == "split":
        return functools.partial(flash_attention_bwd, causal=causal)
    raise ValueError(f"unknown backward impl {impl!r}")


def _inputs(shape: Sequence[int], dtype, device, causal: bool, backward: bool) -> tuple:
    """Seeded inputs of ``(B, H, H_kv, N, D)``: ``(q, k, v)``, and for the
    backward ``(q, k, v, o, do, lse)``."""
    b, h, h_kv, n, d = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    q = make_qkv(gen, (b, h, n, d), dtype=dtype)[0]
    k, v = make_qkv(gen, (b, h_kv, n, d), dtype=dtype)[1:]
    if not backward:
        return q, k, v
    o, lse = flash_attention_fwd(q, k, v, causal=causal, save_lse=True)
    return q, k, v, o, q * 0.01, lse


def _race(kind: str, key: str, cands: Sequence[str], causal: bool, args: tuple, device,
          iters: int, log) -> Tuple[str, float, Dict[str, float]]:
    """``(winner, seconds, {impl: us})`` of one race."""
    make = _fwd_fn if kind == "fwd" else _bwd_fn
    times: Dict[str, float] = {}
    best = None
    for impl in cands:
        t = _seconds(make(impl, causal), args, device, iters)
        times[impl] = t * 1e6
        log(f"  {kind} {key} {impl}: {t * 1e6:.1f} us")
        if best is None or t < best[1]:
            best = (impl, t)
    return best[0], best[1], times


def autotune_fwd(
    shape: Sequence[int],
    *,
    causal: bool = True,
    dtype=torch.bfloat16,
    cache_path: Optional[str] = None,
    force: bool = False,
    device="cuda",
    iters: int = 10,
    log=print,
) -> str:
    """Race the forward candidates (``fwd_candidates``) for ``(B, H, H_kv,
    N, D)`` at a static offset and store the fastest under its key; returns
    the impl (``"general"``, ``"lean"`` or ``"tri"``).  A stored decision is
    returned as it is unless ``force``.  Times as ``autotune_bwd``'s."""
    b, h, h_kv, n, d = shape
    path = DEFAULT_CACHE if cache_path is None else cache_path
    key = _key("fwd", b, h, h_kv, n, n, d, causal, dtype, device)
    cache = _load(path)
    if key in cache and not force:
        return cache[key]["impl"]
    args = _inputs(shape, dtype, device, causal, backward=False)
    impl, t, times = _race("fwd", key, fwd_candidates(n, n, causal), causal, args, device, iters,
                           log)
    record_fwd(shape, impl, causal=causal, dtype=dtype, cache_path=path, device=device,
               us=t * 1e6, raced_us=times)
    return impl


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
    args = _inputs(shape, dtype, device, causal, backward=True)
    cands = [impl for impl, _ in bwd_candidates(h, h_kv, causal, dtype)]
    impl, t, times = _race("bwd", key, cands, causal, args, device, iters, log)
    record_bwd(shape, impl, {}, causal=causal, dtype=dtype, cache_path=path, device=device,
               us=t * 1e6, raced_us=times)
    return impl, {}


def _record(kind: str, shape: Sequence[int], entry: dict, causal: bool, dtype, cache_path,
            device) -> None:
    b, h, h_kv, n, d = shape
    path = DEFAULT_CACHE if cache_path is None else cache_path
    cache = _load(path)
    cache[_key(kind, b, h, h_kv, n, n, d, causal, dtype, device)] = entry
    _store(path, cache)
    _MEMO.pop(path, None)


def record_fwd(shape: Sequence[int], impl: str, *, causal: bool = True, dtype=torch.bfloat16,
               cache_path: Optional[str] = None, device="cuda", **extra) -> None:
    """Store ``impl`` as the forward decision for ``(B, H, H_kv, N, D)``
    (with ``extra`` fields beside it); the router follows it from the next
    lookup on."""
    if impl not in FWD_IMPLS:
        raise ValueError(f"unknown forward impl {impl!r}")
    _record("fwd", shape, {"impl": impl, **extra}, causal, dtype, cache_path, device)


def record_bwd(shape: Sequence[int], impl: str, blocks: dict, *, causal: bool = True,
               dtype=torch.bfloat16, cache_path: Optional[str] = None, device="cuda",
               **extra) -> None:
    """Store ``(impl, blocks)`` as the backward decision for ``(B, H, H_kv,
    N, D)`` (with ``extra`` fields beside it); the router follows it from
    the next lookup on."""
    if impl not in BWD_IMPLS:
        raise ValueError(f"unknown backward impl {impl!r}")
    _record("bwd", shape, {"impl": impl, "blocks": dict(blocks), **extra}, causal, dtype,
            cache_path, device)


# Loaded caches by path, read once per process; ``reset_memo`` forgets them.
_MEMO: Dict[str, dict] = {}


def reset_memo() -> None:
    """Forget the loaded caches, so the next lookup reads the file again."""
    _MEMO.clear()


def lookup(kind: str, b, h, h_kv, n_q, n_kv, d, causal, dtype, *,
           device="cuda") -> Optional[dict]:
    """The entry saved for this shape on this device (``kind`` ``"fwd"`` or
    ``"bwd"``), or None.  The cache is ``DEFAULT_CACHE`` as it names a file
    when the lookup is made, read once (``reset_memo``); without that file
    every lookup misses, and no device name is asked for."""
    path = DEFAULT_CACHE
    if path not in _MEMO:
        _MEMO[path] = _load(path)
    cache = _MEMO[path]
    if not cache:
        return None
    return cache.get(_key(kind, b, h, h_kv, n_q, n_kv, d, causal, dtype, device))


def lookup_fwd_impl(b, h, h_kv, n_q, n_kv, d, causal, dtype, *,
                    device="cuda") -> Optional[str]:
    """The forward kernel saved for this shape on this device (``"general"``,
    ``"lean"`` or ``"tri"``), or None.  Whether it applies to a given call
    is the router's to say (``kernels/flash_fwd.py::fwd_route``)."""
    entry = lookup("fwd", b, h, h_kv, n_q, n_kv, d, causal, dtype, device=device)
    if entry is None:
        return None
    if entry["impl"] not in FWD_IMPLS:
        raise ValueError(f"unknown forward impl {entry['impl']!r} in {DEFAULT_CACHE}")
    return entry["impl"]


def lookup_bwd(b, h, h_kv, n_q, n_kv, d, causal, dtype, *,
               device="cuda") -> Optional[Tuple[str, dict]]:
    """``(impl, blocks)`` saved for this shape on this device, or None.

    ``impl`` is ``"split"``, ``"fused"`` or ``"tri"``; ``lookup`` says where
    the decisions are read from."""
    entry = lookup("bwd", b, h, h_kv, n_q, n_kv, d, causal, dtype, device=device)
    if entry is None:
        return None
    if entry["impl"] not in BWD_IMPLS:
        raise ValueError(f"unknown backward impl {entry['impl']!r} in {DEFAULT_CACHE}")
    if entry["blocks"]:
        raise ValueError(f"backward tiles {entry['blocks']} in {DEFAULT_CACHE}: the tiles of the "
                         "port's backward kernels are built in")
    return entry["impl"], {}


def untuned_route(kind: str, b, h, h_kv, n_q, n_kv, d, causal, dtype) -> str:
    """The kernel the router runs for a plain call of this shape (a static
    offset, no feature) when no decision is saved."""
    if kind == "fwd":
        return fwd_route(n_kv, None, causal=causal)
    return UNTUNED_BWD_ROUTE


def validate(cache_path: Optional[str] = None, *, device="cuda", repeats: int = 5,
             iters: int = 10, timer: Optional[Timer] = None, log=print) -> List[str]:
    """Paired re-check of every entry saved for this device against the
    untuned route (``untuned_route``): the two kernels timed in turns,
    repeat by repeat (``utils/timing.measure_kernel_pair``), so a drift of
    the card's clocks is shared by both.  An entry that does not beat the
    untuned route (ratio untuned / tuned <= 1) is dropped: its decision is
    replaced by the untuned route's, so the router runs what it would run
    without the entry and ``audit`` still sees the shape raced.  Entries
    that name the untuned route are not raced.  Returns the dropped keys.
    ``timer(fn, args, iters) -> seconds`` replaces the clock (CPU tests);
    ``device="cpu"`` times the plain versions on the host clock."""
    path = DEFAULT_CACHE if cache_path is None else cache_path
    cache = _load(path)
    here = device_name(device)
    if timer is None and torch.device(device).type == "cpu":
        timer = _host_timer
    dropped = []
    for key, entry in sorted(cache.items()):
        f = _parse_key(key)
        if f is None or f["device"] != here or f["n_q"] != f["n_kv"]:
            continue
        base = untuned_route(f["kind"], f["b"], f["h"], f["h_kv"], f["n_q"], f["n_kv"], f["d"],
                             f["causal"], f["dtype"])
        if entry["impl"] == base:
            log(f"  {key}: {base} is the untuned route; kept")
            continue
        make = _fwd_fn if f["kind"] == "fwd" else _bwd_fn
        args = _inputs((f["b"], f["h"], f["h_kv"], f["n_q"], f["d"]), f["dtype"], device,
                       f["causal"], backward=f["kind"] == "bwd")
        r = measure_kernel_pair(make(base, f["causal"]), args, make(entry["impl"], f["causal"]),
                                args, repeats=repeats, iters=iters, timer=timer)
        keep = r["ratio"] > 1.0
        log(f"  {key}: untuned {base} {r['a_s'] * 1e6:.1f} us vs tuned {entry['impl']} "
            f"{r['b_s'] * 1e6:.1f} us (ratio {r['ratio']:.3f}) -> {'keep' if keep else 'drop'}")
        if not keep:
            dropped.append(key)
            new = {"impl": base, "us": r["a_s"] * 1e6, "dropped": entry["impl"]}
            if f["kind"] == "bwd":
                new["blocks"] = {}
            cache[key] = new
    _store(path, cache)
    _MEMO.pop(path, None)
    log(f"validate: dropped {len(dropped)} entries that did not beat the untuned route")
    return dropped


def audit_keys(device="cuda") -> List[str]:
    """The keys the benchmark runs: every sweep point of
    ``harness/benchmark.py`` (``amortizing_batch(n)``, one head, D 64,
    bf16), causal and not, forward; and ``TRAIN_SHAPES`` at each of
    ``RACE_HEAD_DIMS``, causal bf16, forward and backward."""
    from .benchmark import DEFAULT_SWEEP, amortizing_batch

    keys = [
        _key("fwd", amortizing_batch(n), 1, 1, n, n, 64, causal, torch.bfloat16, device)
        for causal in (False, True) for n in DEFAULT_SWEEP
    ]
    for b, h, h_kv, n, _ in TRAIN_SHAPES:
        for d in RACE_HEAD_DIMS:
            keys += [_key(kind, b, h, h_kv, n, n, d, True, torch.bfloat16, device)
                     for kind in ("fwd", "bwd")]
    return keys


def audit(cache_path: Optional[str] = None, *, device="cuda", log=print) -> List[str]:
    """The benchmark's keys (``audit_keys``) with no entry in the cache;
    ``--phase audit`` exits 1 when any is missing."""
    cache = _load(DEFAULT_CACHE if cache_path is None else cache_path)
    missing = [key for key in audit_keys(device) if key not in cache]
    for key in missing:
        log(f"  UNRACED: {key}")
    log(f"audit: {len(missing)} benchmark shapes missing from the tuner cache"
        + ("" if missing else " - all covered"))
    return missing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default=DEFAULT_CACHE)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--phase", default="all",
                    choices=("sweep", "sweep-causal", "train", "validate", "audit", "all"),
                    help="sweep / sweep-causal: the benchmark's sweep points, forward; train: "
                         "TRAIN_SHAPES at each of RACE_HEAD_DIMS, forward and backward; all: "
                         "those three")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    if args.phase == "validate":
        validate(args.cache)
        return 0
    if args.phase == "audit":
        return 1 if audit(args.cache) else 0
    from .benchmark import DEFAULT_SWEEP, amortizing_batch

    for causal, phase in ((False, "sweep"), (True, "sweep-causal")):
        if args.phase in (phase, "all"):
            for n in DEFAULT_SWEEP:
                impl = autotune_fwd((amortizing_batch(n), 1, 1, n, 64), causal=causal,
                                    cache_path=args.cache, force=args.force)
                print(f"fwd n={n} causal={int(causal)} on {card}: {impl}")
    if args.phase in ("train", "all"):
        for b, h, h_kv, n, _ in TRAIN_SHAPES:
            for d in RACE_HEAD_DIMS:
                shape = (b, h, h_kv, n, d)
                impl = autotune_fwd(shape, cache_path=args.cache, force=args.force)
                print(f"fwd {shape} on {card}: {impl}")
                impl, blocks = autotune_bwd(shape, cache_path=args.cache, force=args.force)
                print(f"bwd {shape} on {card}: {impl} {blocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
