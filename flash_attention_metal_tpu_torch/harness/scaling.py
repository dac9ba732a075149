"""Sequence-parallel scaling run: ring attention on 1, 2 and 4 sp ranks.

Counterpart of ``flash_attention_metal_tpu/harness/scaling.py``.  For a
fixed global problem (``[1, H, N, D]`` bf16, causal) it spawns a group of
``c`` ranks for each shard count ``c``, runs the ring forward
(``parallel/ring.py``) on each rank's shard and reports rank 0's median
wall milliseconds and tokens per second.  On ranks that share one card
(``--backend gloo``, the only way one card hosts several ranks) or share
the CPU, the ranks contend for the device and their transfers go through
host memory: every row is then a functional check of the code path,
labelled so, and no scaling efficiency is claimed.  Only NCCL ranks on
cards of their own measure scaling.

    python -m flash_attention_metal_tpu_torch.harness.scaling [--backend nccl|gloo] [--device cuda|cpu] [--out scaling_results_torch.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional, Sequence

import torch

from ..parallel.mesh import make_mesh, shard, spawn
from ..parallel.ring import ring_flash_attention
from ..reference import make_qkv

DEFAULT_OUT = "scaling_results_torch.json"


def _ring_rank(rank: int, job: dict) -> dict:
    device = torch.device(job["device"])
    mesh = make_mesh((1, 1, job["shards"]), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    q, k, v = (shard(x, mesh, (None, None, "sp", None)) for x in make_qkv(
        gen, (1, job["heads"], job["n"], job["head_dim"]), dtype=torch.bfloat16))
    times = []
    for i in range(job["iters"] + 1):
        torch.distributed.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        ring_flash_attention(q, k, v, mesh, causal=job["causal"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if i:  # the first call builds and warms up
            times.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(times)}


def run_scaling(n_global: int = 8192, heads: int = 8, head_dim: int = 64,
                shard_counts: Sequence[int] = (1, 2, 4), *, causal: bool = True,
                backend: str = "nccl", device="cuda", iters: int = 10,
                log=print) -> List[dict]:
    """A row per shard count: ``shards``, ``ms``, ``tokens_per_s`` and
    ``scaling_efficiency`` (tokens/s over the one-shard rate times the
    shards), with ``meaningful``: whether each rank had a card of its own
    (NCCL ranks on the card, no more of them than cards)."""
    rows, base = [], None
    for c in shard_counts:
        job = dict(shards=c, n=n_global, heads=heads, head_dim=head_dim, causal=causal,
                   device=str(device), iters=iters)
        median_s = spawn(_ring_rank, c, (job,), backend=backend, device=device)[0]["median_s"]
        tps = n_global / median_s
        base = tps if base is None else base
        own = (torch.device(device).type == "cuda" and backend == "nccl"
               and c <= torch.cuda.device_count())
        row = dict(shards=c, ms=median_s * 1e3, tokens_per_s=tps,
                   scaling_efficiency=tps / (base * c), meaningful=bool(own))
        rows.append(row)
        label = "" if own else " (functional check: ranks share the device; not a scaling figure)"
        log(f"sp={c}: {row['ms']:.3f} ms, {tps:,.0f} tok/s, efficiency "
            f"{row['scaling_efficiency']:.0%}{label}")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"device: {card}, backend {args.backend}")
    rows = run_scaling(args.n, backend=args.backend, device=args.device)
    payload = {"device": card, "backend": args.backend, "rows": rows,
               "note": "rows with meaningful false are functional checks on ranks sharing one "
                       "device; their efficiency is not a result"}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
