"""Process meshes on ``torch.distributed``: groups, coordinates and shards.

Counterpart of ``flash_attention_metal_tpu/parallel/mesh.py``.  A JAX mesh
is an array of devices with named axes that ``shard_map`` lays a program
over; here every rank is one process running the same program, and a
``Mesh`` names this rank's coordinates and its process group along each
axis (data ``dp``, heads/tensor ``tp``, sequence ``sp``).  Ranks lie in
row-major order over the mesh's shape, as ``np.reshape`` lays the JAX
mesh's devices, so the global rank order along an axis is its coordinate
order.

The collectives run on the backend the process group was initialised with:
``"nccl"``, one card a rank, or ``"gloo"``, where ranks may share a card
(one H100 hosts no two NCCL ranks).  ``parallel/comm.py`` stages a CUDA
tensor through a host buffer under gloo, whatever the operation, and
passes it as it is under NCCL.  That follows from the backend's name only:
nothing switches backend or device after an error.

``spawn`` runs a function on a fresh group of processes (start method
spawn, as CUDA needs), with the ``FileStore`` under a directory of the
caller and a timeout on the store and every collective, so a hung rank
fails the run instead of waiting forever.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS_DATA = "dp"
AXIS_TENSOR = "tp"
AXIS_SEQUENCE = "sp"
AXES = (AXIS_DATA, AXIS_TENSOR, AXIS_SEQUENCE)
# Seconds a rank waits for the store or a collective before it fails.
DEFAULT_TIMEOUT_S = 300.0


def init_group(store_path: str, rank: int, world_size: int, *, backend: str = "nccl",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Initialise the default process group of ``world_size`` ranks from a
    ``FileStore`` at ``store_path`` (no network: every rank of one host
    names the same file), on ``backend``.  ``timeout_s`` bounds the store's
    waits and every collective of the group: a rank that does not answer
    fails the others within it."""
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.FileStore(store_path, world_size)
    store.set_timeout(timeout)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timeout)


@dataclasses.dataclass
class Mesh:
    """This rank's place on a mesh of ranks: the axes' names and sizes, its
    coordinates, and a process group along every set of axes."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    backend: str
    device: torch.device
    _groups: Dict[Tuple[str, ...], Tuple[object, List[int]]]

    def _axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} not in the mesh's {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    @property
    def coords(self) -> Dict[str, int]:
        idx = np.unravel_index(self.rank, self.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def size(self, *axes: str) -> int:
        """The number of ranks along ``axes`` (1 for none)."""
        return int(np.prod([self.shape[self.axis_names.index(a)] for a in self._axes(axes)]))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self._axes((axis,))[0]]

    def group(self, *axes: str):
        """This rank's process group along ``axes``."""
        return self._groups[self._axes(axes)][0]

    def ranks(self, *axes: str) -> List[int]:
        """The global ranks of this rank's group along ``axes``, in the
        order of their coordinates (row-major over several axes)."""
        return list(self._groups[self._axes(axes)][1])

    def peer(self, axis: str, shift: int) -> int:
        """The global rank ``shift`` places further along ``axis`` (ring
        order, wrapping)."""
        ranks = self.ranks(axis)
        return ranks[(self.index(axis) + shift) % len(ranks)]


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = AXES, *,
              device="cuda", ranks: Optional[int] = None) -> Optional[Mesh]:
    """The mesh of ``shape`` over the initialised default group.

    Default: every rank on the last axis (the JAX default, a 1-D ``sp``
    ring).  Axis sizes of 1 are legal.  Every rank must call this, in the
    same order as its other group constructions: it creates one process
    group for every set of axes and every coordinate of the others
    (``dist.new_group`` is collective over the world).  ``device``: where
    this rank's tensors live (the card by default; a CUDA device with no
    index is the current one).  ``ranks``: the mesh spans the world's first
    ``ranks`` ranks (JAX's ``devices=jax.devices()[:n]``; default all of
    them), and a rank past them gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (init_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if ranks is None else int(ranks)
    names = tuple(axis_names)
    if shape is None:
        shape = (1,) * (len(names) - 1) + (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} does not match axes {names}")
    if int(np.prod(shape)) != n or n > world:
        raise ValueError(f"mesh shape {shape} != {n} ranks (of a world of {world})")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    grid = np.arange(n).reshape(shape)
    groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
    for r in range(1, len(names) + 1):
        for axes in itertools.combinations(names, r):
            dims = [names.index(a) for a in axes]
            others = [i for i in range(len(names)) if i not in dims]
            # Each coordinate of the other axes is one group; ranks in
            # row-major order of ``axes``.
            moved = np.moveaxis(grid, others + dims, list(range(len(names))))
            for block in moved.reshape(-1, int(np.prod([shape[d] for d in dims]))):
                members = [int(x) for x in block]
                group = dist.group.WORLD if len(members) == world else dist.new_group(members)
                if rank in members:
                    groups[axes] = (group, members)
    if rank >= n:
        return None
    return Mesh(names, shape, rank, dist.get_backend(), device, groups)


def _block(mesh: Mesh, shape: Sequence[int], spec: Sequence[Optional[str]]) -> Tuple[slice, ...]:
    if len(spec) > len(shape):
        raise ValueError(f"spec {tuple(spec)} has more entries than the shape {tuple(shape)}")
    out = []
    for n, axis in itertools.zip_longest(shape, spec):
        if axis is None:
            out.append(slice(None))
            continue
        # A tuple of axes splits the dim over all of them, the first major
        # (a PartitionSpec's ("dp", "ep")).
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        parts = mesh.size(*axes)
        if n % parts:
            raise ValueError(f"dim of {n} does not split over {parts} ranks of {axis!r}")
        i = 0
        for a in axes:
            i = i * mesh.size(a) + mesh.index(a)
        step = n // parts
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def shard(x: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]]) -> torch.Tensor:
    """This rank's block of the global tensor ``x``: dim ``i`` split over
    the ranks of axis ``spec[i]`` (a name, a tuple of names, or None:
    whole), as a ``PartitionSpec``
    places it; a contiguous copy on ``mesh.device`` (differentiable: the
    gradient flows back into this rank's block of ``x``)."""
    return x[_block(mesh, x.shape, spec)].to(mesh.device).contiguous().clone()


def unshard(x: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]]) -> torch.Tensor:
    """The global tensor from every rank's block ``x`` (``shard``'s
    inverse): an all-gather along each split dim.  Collective: every rank
    of the mesh calls it."""
    from .comm import all_gather

    for dim, axis in enumerate(spec):
        if axis is not None:
            x = all_gather(x, mesh, axis, dim)
    return x


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A ``spec`` (an axis name or None per dim) on a mesh: the counterpart
    of a ``NamedSharding``."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def block(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """The index of this rank's block of a global tensor of ``shape``."""
        return _block(self.mesh, shape, self.spec)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return shard(x, self.mesh, self.spec)


def attention_shardings(
    mesh: Mesh,
    *,
    data_axis: Optional[str] = AXIS_DATA,
    head_axis: Optional[str] = AXIS_TENSOR,
    seq_axis: Optional[str] = None,
) -> Tuple[Sharding, Sharding, Sharding]:
    """(q, k, v) shardings of ``[B, H, N, D]`` tensors: batch on
    ``data_axis``, heads on ``head_axis`` and, for sequence or context
    parallelism, the sequence on ``seq_axis``."""
    spec = (data_axis, head_axis, seq_axis, None)
    return Sharding(mesh, spec), Sharding(mesh, spec), Sharding(mesh, spec)


def _to_host(x):
    """``x`` with every tensor detached on the CPU (a rank's result)."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank: int, fn: Callable, world_size: int, workdir: str, backend: str,
               device: str, timeout_s: float) -> None:
    # Ranks share the host's cores; one intra-op thread each keeps them
    # apart (a rank on the card only stages tensors on the host).
    torch.set_num_threads(1)
    if torch.device(device).type != "cpu":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init_group(os.path.join(workdir, "store"), rank, world_size, backend=backend,
               timeout_s=timeout_s)
    try:
        args = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
        out = fn(rank, *args)
        torch.save(_to_host(out), os.path.join(workdir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: tuple = (), *, backend: str = "nccl",
          device="cuda", workdir: Optional[str] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """``[fn(rank, *args) for every rank]``, each rank a process of a new
    group of ``world_size`` on ``backend`` (the card's NCCL by default;
    ``"gloo"`` for ranks that share a card or the CPU), its tensors moved to
    the CPU.  ``fn`` must be importable by name (a module-level function).

    A rank on the card is pinned to card ``rank % device_count``.  The
    kernels' library is built here, before the ranks start, so they load it
    and none builds (``kernels/_build.py`` takes no lock).  The store lives
    in ``workdir`` (a new temporary directory by default).  A rank that
    raises, dies or times out fails the whole call:
    ``torch.multiprocessing.spawn`` stops the others and raises."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        from ..kernels import _build

        _build.load()
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="fam_spawn_") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    # The arguments reach the ranks through a file: numpy arrays among
    # mp.spawn's own arguments were seen to delay each rank's start by ~15 s.
    torch.save(tuple(args), os.path.join(workdir, "args.pt"))
    mp.spawn(_rank_main, args=(fn, world_size, workdir, backend, str(device), timeout_s),
             nprocs=world_size, join=True)
    results = [torch.load(os.path.join(workdir, f"result_{r}.pt"), weights_only=False)
               for r in range(world_size)]
    if own:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return results
