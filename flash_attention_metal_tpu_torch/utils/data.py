"""Training data: memmapped token shards -> deterministic batches -> the card.

Counterpart of ``flash_attention_metal_tpu/utils/data.py``, with the same
shard format and the same batch order, so a shard written by either
package reads in the other and a run resumed in one continues the other's
stream:

* storage: flat little-endian ``uint16`` (or ``uint32`` past 65535) token
  files (``.bin``) beside a JSON header (``fam_tokens_v1``, the dtype, the
  count); ``np.memmap`` reads them without a copy on the hot path;
* batching: the corpus is cut into ``seq_len + 1`` windows that never
  straddle a shard; each epoch visits them in the permutation numpy's
  ``default_rng((seed, epoch))`` draws, host ``h`` of ``n`` takes every
  ``n``-th window of it, so a run resumes from ``(epoch, step)`` alone;
* prefetch: ``prefetch_to_device`` keeps ``size`` batches in flight on the
  card, each copied from pinned host memory with ``non_blocking``, so the
  host's reads and the copy overlap the step before; with a ``sharding``
  each rank copies only its block of the global batch.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

_MAGIC = "fam_tokens_v1"


def write_token_shard(path: str, tokens: np.ndarray) -> None:
    """Write a 1-D token array as a memmappable shard and its JSON header
    (``path + ".json"``)."""
    tokens = np.ascontiguousarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got shape {tokens.shape}")
    if tokens.min() < 0:
        raise ValueError("tokens must be non-negative")
    dtype = np.uint16 if tokens.max() < 2**16 else np.uint32
    tokens.astype(dtype).tofile(path)
    with open(path + ".json", "w") as f:
        json.dump({"magic": _MAGIC, "dtype": np.dtype(dtype).name, "n_tokens": int(tokens.size)},
                  f)


class TokenDataset:
    """Memmapped view over one or more token shards, as ``seq_len + 1``
    windows (a window's inputs and targets share the extra token)."""

    def __init__(self, paths: Sequence[str]):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self._maps = []
        for p in paths:
            with open(str(p) + ".json") as f:
                hdr = json.load(f)
            if hdr.get("magic") != _MAGIC:
                raise ValueError(f"{p}: not a {_MAGIC} shard")
            self._maps.append(np.memmap(p, dtype=np.dtype(hdr["dtype"]), mode="r"))
        self._sizes = [m.size for m in self._maps]

    @property
    def n_tokens(self) -> int:
        return int(sum(self._sizes))

    def n_windows(self, seq_len: int) -> int:
        # Windows never straddle shard boundaries (reads stay contiguous).
        return sum(s // (seq_len + 1) for s in self._sizes)

    def window(self, idx: int, seq_len: int) -> np.ndarray:
        w = seq_len + 1
        for m, s in zip(self._maps, self._sizes):
            n = s // w
            if idx < n:
                return np.asarray(m[idx * w : (idx + 1) * w])
            idx -= n
        raise IndexError(idx)


def batch_iterator(
    dataset: TokenDataset,
    batch_size: int,
    seq_len: int,
    *,
    seed: int = 0,
    start_epoch: int = 0,
    start_step: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
    epochs: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, Tuple[int, int]]]:
    """Deterministic shuffled int32 ``[batch, seq_len + 1]`` batches, each
    with its ``(epoch, step)``.  Restarting at ``start_epoch`` /
    ``start_step`` reproduces the stream from there (the permutation is a
    function of ``seed`` and the epoch alone); each host sees a disjoint
    interleaved slice of every epoch."""
    n = dataset.n_windows(seq_len)
    per_host = n // num_hosts
    steps_per_epoch = per_host // batch_size
    if steps_per_epoch == 0:
        raise ValueError(f"{n} windows / {num_hosts} hosts < batch_size={batch_size}")
    epoch = start_epoch
    while epochs is None or epoch < epochs:
        perm = np.random.default_rng((seed, epoch)).permutation(n)
        local = perm[host_id::num_hosts]
        first = start_step if epoch == start_epoch else 0
        for step in range(first, steps_per_epoch):
            idx = local[step * batch_size : (step + 1) * batch_size]
            out = np.stack([dataset.window(i, seq_len) for i in idx])
            yield out.astype(np.int32), (epoch, step)
        epoch += 1


def _to_device(x, device: torch.device, block=None):
    """Arrays and tensors of ``x`` (a batch, or a tuple / list / dict of
    them) on ``device``, each cut to ``block(shape)`` first when given;
    other leaves (the ``(epoch, step)`` tag) as they are."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if torch.is_tensor(x):
        if block is not None:
            x = x[block(x.shape)].contiguous()
        if device.type == "cuda":
            # Pinned memory makes the copy asynchronous with the host.
            return x.pin_memory().to(device, non_blocking=True)
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_to_device(a, device, block) for a in x)
    if isinstance(x, list):
        return [_to_device(a, device, block) for a in x]
    if isinstance(x, dict):
        return {k: _to_device(a, device, block) for k, a in x.items()}
    return x


def prefetch_to_device(it: Iterator, size: int = 2, device="cuda", sharding=None) -> Iterator:
    """Keep ``size`` batches of ``it`` in flight on ``device`` (the card by
    default; CPU runs pass ``device="cpu"``).  Each host array becomes a
    tensor copied from pinned memory with ``non_blocking``, on the current
    stream, so the copy and the host's next reads overlap the step the
    consumer is running; non-array leaves (the ``(epoch, step)`` tag) pass
    through.

    ``sharding``: a ``parallel.mesh.Sharding`` (JAX's ``NamedSharding``),
    e.g. ``models.parallel_train.batch_sharding(mesh)``: each rank takes
    only its block of every array, in the global batch's order (the
    ``(dp, sp)`` block of a ``[B, N]`` batch: rows ``dp * B / n_dp`` on,
    columns ``sp * N / n_sp`` on), so the ranks of a mesh read one global
    stream, as JAX's ``device_put`` lays it over the devices."""
    from ..parallel.mesh import Sharding

    if sharding is not None and not isinstance(sharding, Sharding):
        raise TypeError(f"sharding must be a parallel.mesh.Sharding, got {type(sharding).__name__}")
    block = None if sharding is None else sharding.block
    device = torch.device(device)
    queue = collections.deque()
    for item in it:
        queue.append(_to_device(item, device, block))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
