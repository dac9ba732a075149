"""Block-sparse attention: ``BlockMask``, three CUDA kernels' wrappers, their
plain versions and the differentiable op.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_mask.py``.  A mask
is any elementwise predicate ``mask_fn(rows, cols) -> bool`` (True =
visible) that numpy can evaluate on int arrays.  ``BlockMask`` compiles it
on the host, as the JAX class does (``flash_mask.py:47-111``, the same
public fields bit for bit), and also into the tables the CUDA kernels read
(``MaskTables``): a Pallas kernel traces the predicate into its body, a
CUDA kernel cannot call it.

The tables use the kernels' own 64-row tiles, not the mask's blocks: the
mask is applied elementwise, so the result does not depend on the tile.
Per Q tile the list of KV tiles it visits; per KV tile the transposed list
of Q tiles; per visited pair either "full" or the index of a packed bit
tile of its visible elements (64 x 64 bits, 512 bytes).  Everything the
kernels read scales with the visited pairs, never with N^2.

Kernels (``csrc/flash_mask.cu``):

* ``flash_sparse_fwd`` (the Pallas ``_fwd_sparse_kernel``): online softmax
  over each Q tile's KV list, P zeroed where the mask is off, so a row that
  sees nothing gives ``o = 0`` and ``lse = -inf``; native GQA (KV head
  ``h // group``); lse fp32 ``[B, H, N_q]``.  bf16 runs the dense forward's
  ``wgmma`` kernel (``csrc/flash_fwd_sm90.cuh``) on its sparse walk, Q
  tiles issued longest list first across heads (``dq_order``).
* ``flash_sparse_dkv`` (``_dkv_sparse_kernel``): dK and dV per KV tile over
  the group's q-heads and its transposed Q list, P rebuilt from the lse
  (``LSE_SENTINEL`` for ``-inf``).  The JAX backward takes equal heads only
  (its op repeats K/V and sums the group after, in the input dtype); this
  kernel sums a KV head's group of q-heads in fp32 before its one store, as
  the split pair.  bf16 runs the split pair's ``wgmma`` kernel
  (``csrc/flash_bwd_sm90.cuh``) over a plan of chunks (``dkv_plan``): a
  tile's walk longer than ``dkv_chunk_cap`` pairs is cut into chunks, one
  block each, whose fp32 partials the last of them sums in chunk order.
* ``flash_sparse_dq`` (``_dq_sparse_kernel``): dQ per Q tile over its KV
  list again; bf16 on the split pair's ``wgmma`` kernel, Q tiles issued
  longest list first (``dq_order``).

Each wrapper takes its plain version (the dense masked softmax from the
predicate) for tensors on the CPU, and launches its kernel, or raises, for
CUDA tensors.  Nothing falls back.  fp16 runs in fp32 and is cast back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import DEFAULT_MASK_VALUE, default_scale
from . import _build
from . import flash_fwd as ff
from .flash_bwd import LSE_SENTINEL, _group_sum, bwd_delta
from .flash_fwd import _DTYPE_CODES, check_head_dim, check_shapes

MaskFn = Callable[[np.ndarray, np.ndarray], np.ndarray]

# Rows of the kernels' Q and KV tiles (csrc/flash_mask.cu, kTile).
TILE = 64


@dataclasses.dataclass(frozen=True)
class MaskTables:
    """A ``BlockMask`` at the kernels' tile, as int32 tensors.

    ``q_ptr [nqt + 1]`` / ``q_list [nnz, 2]``: Q tile ``i``'s visited pairs
    are entries ``q_ptr[i] .. q_ptr[i + 1] - 1``, each ``(KV tile, bits)``
    in KV order.  ``kv_ptr`` / ``kv_list``: the same pairs per KV tile, each
    ``(Q tile, bits)`` in Q order.  ``bits`` is -1 for a full pair, else a
    row of ``bit_tiles [n_partial, 64, 2]``: bit ``c % 32`` of word
    ``c // 32`` of row ``r`` is element ``(r, c)`` of the pair (the int32
    holds the word's 32 bits).  Elements past ``n_q`` or ``n_kv`` are off,
    so a ragged edge tile is never full.
    """

    q_ptr: torch.Tensor
    q_list: torch.Tensor
    kv_ptr: torch.Tensor
    kv_list: torch.Tensor
    bit_tiles: torch.Tensor

    def to(self, device) -> "MaskTables":
        return MaskTables(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f.name).numel() * 4 for f in dataclasses.fields(self))


def _mask_tile(mask_fn: MaskFn, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The predicate on a ``[len(rows), len(cols)]`` tile, as bool."""
    out = np.asarray(mask_fn(rows[:, None], cols[None, :]))
    return np.broadcast_to(out, (len(rows), len(cols))).astype(bool)


def _pack_bits(tile: np.ndarray) -> np.ndarray:
    """A ``[64, 64]`` bool tile as ``[64, 2]`` int32 words (bit ``c % 32``
    of word ``c // 32``)."""
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    words = (tile.reshape(TILE, TILE // 32, 32).astype(np.uint64) * weights).sum(axis=-1)
    return words.astype(np.uint32).view(np.int32)


def compile_tables(mask_fn: MaskFn, n_q: int, n_kv: int) -> MaskTables:
    """``MaskTables`` of ``mask_fn`` over ``[n_q, n_kv]`` (CPU tensors): the
    predicate evaluated once per 64 x 64 tile, with numpy."""
    nqt, nkt = -(-n_q // TILE), -(-n_kv // TILE)
    pairs = {}  # (i, j) -> bits index or -1
    bit_tiles = []
    for i in range(nqt):
        rows = np.arange(i * TILE, (i + 1) * TILE)
        for j in range(nkt):
            cols = np.arange(j * TILE, (j + 1) * TILE)
            tile = _mask_tile(mask_fn, rows, cols)
            tile &= (rows[:, None] < n_q) & (cols[None, :] < n_kv)
            if not tile.any():
                continue
            if tile.all():
                pairs[i, j] = -1
            else:
                pairs[i, j] = len(bit_tiles)
                bit_tiles.append(_pack_bits(tile))

    def csr(n_rows, key):
        order = sorted(pairs, key=key)
        ptr = np.zeros(n_rows + 1, dtype=np.int32)
        for pair in order:
            ptr[key(pair)[0] + 1] += 1
        entries = np.array([(key(p)[1], pairs[p]) for p in order], dtype=np.int32).reshape(-1, 2)
        return torch.from_numpy(np.cumsum(ptr).astype(np.int32)), torch.from_numpy(entries)

    q_ptr, q_list = csr(nqt, lambda p: (p[0], p[1]))
    kv_ptr, kv_list = csr(nkt, lambda p: (p[1], p[0]))
    bits = np.stack(bit_tiles) if bit_tiles else np.zeros((0, TILE, TILE // 32), np.int32)
    return MaskTables(q_ptr, q_list, kv_ptr, kv_list, torch.from_numpy(np.ascontiguousarray(bits)))


# The dK/dV grid (csrc/flash_bwd_sm90.cuh, SparseWalk).  A (KV tile, KV
# head, batch) walks group x list-length tile pairs; the transposed lists
# of a causal mask are uneven (rung 11's at N = 2048: 1 to 32 entries), and
# with one block per walk the longest ones set the kernel's time.  A walk
# longer than the cap is cut into chunks of near-equal length, one block
# each, the fp32 partials summed in chunk order by the last chunk to end.
# The cap is CHUNK_SLACK times the pairs per block slot of the card when
# every walk is spread evenly (DKV_BLOCKS_PER_SM: the kernel holds 3
# blocks an SM at D = 64, csrc/flash_bwd_sm90.cuh's launch bound, and 2 at
# D = 128, by its registers), but at least MIN_CHUNK_PAIRS: a shorter
# chunk pays its K/V tile loads, its 64 x D x 2 fp32 partial and its share
# of the merge for too few products.  The slack is measured on the H100
# (`onchip sparse_splits`, PERF.md §6): the longest-first issue order
# absorbs that much imbalance, and a finer split costs more than it gains.
# Under rung 11's mask the best caps were 15-17 pairs at the D = 128 shape
# (3008 pairs, 11.4 a slot; 12 ran 8% and no split 2x slower) and no split
# at the D = 64 training shape (60.8 a slot; cap 61 ran 3-5% slower).
DKV_BLOCKS_PER_SM = {64: 3, 128: 2}
CHUNK_SLACK = 1.4
MIN_CHUNK_PAIRS = 4
# Ints per dK/dV plan entry (csrc/flash_bwd_sm90.cuh, kPlanInts): KV tile,
# first and end pair of the chunk in the tile's walk, the chunk's index,
# the tile's chunk count, the tile's first workspace slot, the tile's index
# among the split tiles (its tickets), padding.
PLAN_INTS = 8


def dkv_chunk_cap(kv_lengths: np.ndarray, batch: int, n_kv_heads: int, group: int,
                  head_dim: int, sm_count: int) -> int:
    """The most tile pairs one dK/dV block walks, from the transposed lists'
    lengths and static shapes alone (no tensor data): ``CHUNK_SLACK`` times
    the pairs of the whole call over ``sm_count *
    DKV_BLOCKS_PER_SM[head_dim]`` block slots, rounded up, at least
    ``MIN_CHUNK_PAIRS``."""
    total = batch * n_kv_heads * group * int(np.sum(kv_lengths))
    slots = sm_count * DKV_BLOCKS_PER_SM[head_dim]
    return max(MIN_CHUNK_PAIRS, math.ceil(CHUNK_SLACK * total / slots))


class SparseGrid(NamedTuple):
    """The grid of one launch of a block-sparse kernel: the most tile pairs
    one block walks (dK/dV: the chunk cap; the forward and dQ: the longest
    Q list), the blocks per (head, batch) (dK/dV: chunks; the forward and
    dQ: Q tiles) and the blocks."""

    cap: int
    chunks: int
    blocks: int


@dataclasses.dataclass(frozen=True)
class DkvPlan:
    """The dK/dV kernel's chunks in issue order, longest first.

    ``entries [chunks, PLAN_INTS]`` int32, each ``(KV tile, first pair, end
    pair, chunk, chunks of the tile, first slot, split tile, 0)``: pairs
    ``p`` of a tile's walk are ``(q-head p // len, list entry p % len)``.
    A tile whose walk fits the cap is one chunk with no slot or ticket;
    ``slots`` workspace slots and ``split_tiles`` tickets serve the others.
    """

    cap: int
    entries: np.ndarray
    slots: int
    split_tiles: int

    @property
    def chunks(self) -> int:
        return len(self.entries)

    def grid(self, batch: int, n_kv_heads: int) -> SparseGrid:
        return SparseGrid(self.cap, self.chunks, self.chunks * batch * n_kv_heads)

    def part_numel(self, batch: int, n_kv_heads: int, head_dim: int) -> int:
        """fp32 elements of the workspace: 64 x D for dK and for dV per
        (slot, KV head, batch)."""
        return self.slots * batch * n_kv_heads * 2 * TILE * head_dim


def dkv_plan(kv_lengths: np.ndarray, group: int, cap: int) -> DkvPlan:
    """Every KV tile's walk of ``group * length`` pairs cut into
    ``ceil(walk / cap)`` chunks of near-equal length (an empty tile is one
    empty chunk, which stores zeros), ordered longest first, ties in tile
    and chunk order.  A pure function of the lengths, ``group`` and
    ``cap``."""
    rows, slots, split = [], 0, 0
    for tile, length in enumerate(int(n) for n in kv_lengths):
        walk = group * length
        n = max(1, -(-walk // cap))
        bounds = [walk * i // n for i in range(n + 1)]
        for c in range(n):
            rows.append((tile, bounds[c], bounds[c + 1], c, n, slots if n > 1 else 0,
                         split if n > 1 else 0, 0))
        if n > 1:
            slots += n
            split += 1
    rows.sort(key=lambda r: (r[1] - r[2], r[0], r[3]))
    entries = np.array(rows, dtype=np.int32).reshape(-1, PLAN_INTS)
    return DkvPlan(cap, entries, slots, split)


def dq_order(q_lengths: np.ndarray) -> np.ndarray:
    """The bf16 forward's and dQ kernel's Q tiles in issue order: longest
    list first, ties in tile order (int32)."""
    return np.argsort(-np.asarray(q_lengths), kind="stable").astype(np.int32)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class BlockMask:
    """Compiled block-sparse mask for a fixed ``(n_q, n_kv, blocks)`` layout.

    The fields of the JAX class, bit for bit: ``occupancy [nqb, nkb]``
    (any visible element per block), ``q_counts``, ``kv_ids`` (each Q
    block's visited KV blocks, padded by repeating the last id; id 0 and
    count 0 for a block row that sees nothing), ``max_kv``, and the
    transposed ``kv_counts``, ``q_ids``, ``max_q``; ``density``.  The
    predicate is evaluated on numpy int arrays, one block tile at a time.

    ``tables(device)``: the kernels' tables (``MaskTables``), built at
    construction and copied once per device; ``q_lengths`` and
    ``kv_lengths`` their lists' lengths; ``dkv_plan`` and ``dq_order`` the
    kernels' grids (``dq_order`` also the bf16 forward's), kept beside
    them.
    """

    def __init__(self, mask_fn: MaskFn, n_q: int, n_kv: int, block_q: int, block_kv: int):
        if n_q % block_q or n_kv % block_kv:
            raise ValueError(f"({n_q},{n_kv}) not divisible by blocks ({block_q},{block_kv})")
        self.mask_fn = mask_fn
        self.n_q, self.n_kv = n_q, n_kv
        self.block_q, self.block_kv = block_q, block_kv
        nqb, nkb = n_q // block_q, n_kv // block_kv

        occupancy = np.zeros((nqb, nkb), dtype=bool)
        rows = np.arange(block_q)
        cols = np.arange(block_kv)
        for i in range(nqb):
            r = (rows + i * block_q)[:, None]
            for j in range(nkb):
                c = (cols + j * block_kv)[None, :]
                occupancy[i, j] = bool(np.any(np.asarray(mask_fn(r, c))))
        self.occupancy = occupancy

        self.q_counts = occupancy.sum(axis=1).astype(np.int32)
        self.max_kv = max(int(self.q_counts.max()), 1)
        self.kv_ids = self._padded_lists(occupancy, self.max_kv)
        self.kv_counts = occupancy.sum(axis=0).astype(np.int32)
        self.max_q = max(int(self.kv_counts.max()), 1)
        self.q_ids = self._padded_lists(occupancy.T, self.max_q)

        cpu = compile_tables(mask_fn, n_q, n_kv)
        self._tables: Dict[torch.device, MaskTables] = {torch.device("cpu"): cpu}
        # Entries of each Q tile's and each KV tile's list.
        self.q_lengths = np.diff(cpu.q_ptr.numpy())
        self.kv_lengths = np.diff(cpu.kv_ptr.numpy())
        self._plans: Dict[tuple, Tuple[DkvPlan, torch.Tensor]] = {}
        self._orders: Dict[torch.device, torch.Tensor] = {}

    @staticmethod
    def _padded_lists(occupancy: np.ndarray, width: int) -> np.ndarray:
        """Each row's visited column ids, padded by repeating the last one."""
        ids = np.zeros((occupancy.shape[0], width), dtype=np.int32)
        for i, row in enumerate(occupancy):
            nz = np.nonzero(row)[0]
            if len(nz):
                ids[i, : len(nz)] = nz
                ids[i, len(nz):] = nz[-1]
        return ids

    @property
    def density(self) -> float:
        return float(self.occupancy.mean())

    def tables(self, device) -> MaskTables:
        """The kernels' tables on ``device`` (copied there once)."""
        device = _device(device)
        if device not in self._tables:
            self._tables[device] = self._tables[torch.device("cpu")].to(device)
        return self._tables[device]

    def dkv_plan(self, device, group: int, cap: int) -> Tuple[DkvPlan, torch.Tensor]:
        """``dkv_plan`` of this mask's transposed lists, and its entries on
        ``device`` (built and copied once per (device, group, cap))."""
        key = (_device(device), group, cap)
        if key not in self._plans:
            plan = dkv_plan(self.kv_lengths, group, cap)
            self._plans[key] = plan, torch.from_numpy(plan.entries).to(key[0])
        return self._plans[key]

    def dq_order(self, device) -> torch.Tensor:
        """``dq_order`` of this mask's lists on ``device`` (copied once)."""
        device = _device(device)
        if device not in self._orders:
            self._orders[device] = torch.from_numpy(dq_order(self.q_lengths)).to(device)
        return self._orders[device]

    def dense(self, device=None) -> torch.Tensor:
        """The elementwise mask ``[n_q, n_kv]`` (bool): the plain versions'
        mask, never the kernels'."""
        vis = _mask_tile(self.mask_fn, np.arange(self.n_q), np.arange(self.n_kv))
        return torch.from_numpy(np.ascontiguousarray(vis)).to(device)

    def visible_pairs(self) -> int:
        """Element-visible (row, column) pairs of one head."""
        return int(self.dense().sum())


# ---------------------------------------------------------------------------
# Plain versions: the dense masked softmax from the predicate.
# ---------------------------------------------------------------------------


def flash_sparse_fwd_plain(q, k, v, mask: BlockMask, *, sm_scale: float, save_lse: bool = False):
    """The forward kernel's contract in fp32 PyTorch."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    visible = mask.dense(q.device)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    s = s.masked_fill(~visible, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * visible
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (torch.matmul(p, vf) / l_safe).to(q.dtype)
    if not save_lse:
        return o
    return o, torch.where(l == 0.0, float("-inf"), m + torch.log(l_safe))[..., 0]


def _plain_p_ds(q, k, v, do, lse, delta, mask, sm_scale):
    """fp32 P (rebuilt from ``lse``) and dS over repeated KV heads."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    lse_safe = torch.where(torch.isneginf(lse), LSE_SENTINEL, lse.float())
    # masked_fill, not a product: an invisible score far above the row's
    # lse overflows exp to inf, and inf * 0 is NaN.
    p = torch.exp(s.sub_(lse_safe[..., None])).masked_fill_(~mask.dense(q.device), 0.0)
    dp = torch.matmul(do.float(), vf.transpose(-1, -2))
    return p, dp.sub_(delta[..., None]).mul_(p), kf


def flash_sparse_dkv_plain(q, k, v, do, lse, delta, mask: BlockMask, *, sm_scale: float):
    """The dK/dV kernel's contract in fp32 PyTorch: ``(dk, dv)`` summed over
    each KV head's group of q-heads."""
    p, ds, _ = _plain_p_ds(q, k, v, do, lse, delta, mask, sm_scale)
    h_kv = k.shape[1]
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), do.float()), h_kv)
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), q.float()), h_kv) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_sparse_dq_plain(q, k, v, do, lse, delta, mask: BlockMask, *, sm_scale: float):
    """The dQ kernel's contract in fp32 PyTorch."""
    _, ds, kf = _plain_p_ds(q, k, v, do, lse, delta, mask, sm_scale)
    return (torch.matmul(ds, kf) * sm_scale).to(q.dtype)


def _bit_tiles_dense(t: MaskTables) -> torch.Tensor:
    """The partial pairs' bit tiles as bool ``[n_partial, 64, 64]``."""
    words = t.bit_tiles.numpy().view(np.uint32)
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return torch.from_numpy(bits.reshape(-1, TILE, TILE).astype(bool))


def flash_sparse_dkv_chunked_plain(q, k, v, do, lse, delta, mask: BlockMask, plan: DkvPlan, *,
                                   sm_scale: float):
    """The bf16 dK/dV kernel's split walk in fp32 PyTorch, for the tests:
    for every plan entry, the fp32 partial dK and dV of its pairs (each a
    list entry of the mask's tables and its bit tile, or full), summed per
    tile in chunk order, then scaled and cast as the kernel stores."""
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    group = h // h_kv
    t = mask.tables("cpu")
    kv_ptr, kv_list = t.kv_ptr.tolist(), t.kv_list.tolist()
    bits = _bit_tiles_dense(t).to(q.device)
    qf = q.float().view(b, h_kv, group, n_q, d)
    dof = do.float().view(b, h_kv, group, n_q, d)
    lse_safe = torch.where(torch.isneginf(lse), LSE_SENTINEL, lse.float()).view(b, h_kv, group, n_q)
    delta = delta.float().view(b, h_kv, group, n_q)
    kf, vf = k.float(), v.float()
    dk = torch.zeros((b, h_kv, n_kv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    partials: Dict[int, Dict[int, Tuple[torch.Tensor, torch.Tensor]]] = {}
    for tile, first_pair, end_pair, chunk, *_ in plan.entries.tolist():
        first, length = kv_ptr[tile], kv_ptr[tile + 1] - kv_ptr[tile]
        cols = slice(tile * TILE, min(n_kv, (tile + 1) * TILE))
        kt, vt = kf[:, :, cols], vf[:, :, cols]
        acc_k = torch.zeros_like(kt)
        acc_v = torch.zeros_like(vt)
        for pair in range(first_pair, end_pair):
            g = pair // length
            q_tile, bit = kv_list[first + pair % length]
            rows = slice(q_tile * TILE, min(n_q, (q_tile + 1) * TILE))
            qt, dot = qf[:, :, g, rows], dof[:, :, g, rows]
            s = torch.matmul(qt, kt.transpose(-1, -2)) * sm_scale
            p = torch.exp(s - lse_safe[:, :, g, rows, None])
            if bit >= 0:
                seen = bits[bit, : p.shape[-2], : p.shape[-1]]
                p = p.masked_fill(~seen, 0.0)
            dp = torch.matmul(dot, vt.transpose(-1, -2))
            ds = p * (dp - delta[:, :, g, rows, None])
            acc_v += torch.matmul(p.transpose(-1, -2), dot)
            acc_k += torch.matmul(ds.transpose(-1, -2), qt)
        partials.setdefault(tile, {})[chunk] = (acc_k, acc_v)
    for tile, chunks in partials.items():
        cols = slice(tile * TILE, min(n_kv, (tile + 1) * TILE))
        for c in range(len(chunks)):  # in chunk order, from zero, as the kernel merges
            dk[:, :, cols] += chunks[c][0]
            dv[:, :, cols] += chunks[c][1]
    return (dk * sm_scale).to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the block-sparse entry points' C signatures on a library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shape = [i32] * 6 + [ctypes.c_float, i32, ptr]  # b, h, h_kv, n_q, n_kv, d, scale, dtype, stream
    # q, k, v, o, lse, q_ptr, q_list, bits, order
    lib.fam_flash_sparse_fwd.argtypes = [ptr] * 9 + shape
    lib.fam_flash_sparse_fwd.restype = ctypes.c_int
    # q, k, v, dout, lse, delta, dk, dv, kv_ptr, kv_list, bits, plan, part,
    # tickets; the shape; n_chunks before the stream
    lib.fam_flash_sparse_dkv.argtypes = [ptr] * 14 + shape[:-1] + [i32, ptr]
    lib.fam_flash_sparse_dkv.restype = ctypes.c_int
    # q, k, v, dout, lse, delta, dq, q_ptr, q_list, bits, order
    lib.fam_flash_sparse_dq.argtypes = [ptr] * 11 + shape
    lib.fam_flash_sparse_dq.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load())


def _check_cuda(mask: BlockMask, *tensors) -> None:
    """Types, head dim, devices, contiguity and alignment the kernels take
    (``tensors``: q first, then k, v and the rest of q's dtype)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes bf16 or fp32 inputs, got {q.dtype}")
    check_head_dim(q.shape[-1])
    for t in tensors:
        if t.dtype != q.dtype:
            raise TypeError("q, k, v (and do) must share one dtype")
        if t.device != q.device:
            raise ValueError(f"an input is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("inputs must be contiguous and 16-byte aligned")


def _check_rows(q, *rows) -> None:
    for t in rows:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError("lse and delta must be contiguous fp32 tensors on q's device")


def _dims(q, k, sm_scale, stream):
    b, h, n_q, d = q.shape
    return b, h, k.shape[1], n_q, k.shape[2], d, sm_scale, _DTYPE_CODES[q.dtype], stream


def flash_sparse_fwd(q, k, v, mask: BlockMask, *, sm_scale: float, save_lse: bool = False):
    """``o`` or ``(o, lse)`` from the forward kernel (CPU: the plain
    version).  Keeps the launch's ``SparseGrid`` as ``.grid`` beside
    ``.launches``."""
    if q.device.type == "cpu":
        return flash_sparse_fwd_plain(q, k, v, mask, sm_scale=sm_scale, save_lse=save_lse)
    _check_cuda(mask, q, k, v)
    o, lse = _launch_fwd(q, k, v, mask, sm_scale, save_lse)
    return (o, lse) if save_lse else o


def _launch_fwd(q, k, v, mask: BlockMask, sm_scale: float, save_lse: bool):
    """The forward entry's launch on checked inputs (bf16: Q tiles longest
    list first); ``(o, lse or None)``."""
    t = mask.tables(q.device)
    stream, _ = ff._cuda_args(q)
    order = mask.dq_order(q.device) if q.dtype == torch.bfloat16 else None
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if save_lse else None
    err = _lib().fam_flash_sparse_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ff._ptr(lse),
        t.q_ptr.data_ptr(), t.q_list.data_ptr(), t.bit_tiles.data_ptr(), ff._ptr(order),
        *_dims(q, k, sm_scale, stream),
    )
    if err:
        raise RuntimeError(f"flash_sparse_fwd kernel launch failed: cudaError_t {err}")
    flash_sparse_fwd.launches += 1
    flash_sparse_fwd.grid = _q_tile_grid(mask, q)
    return o, lse


def _q_tile_grid(mask: BlockMask, q) -> SparseGrid:
    """The forward's and dQ's grid: one block per (Q tile, q-head, batch)."""
    tiles = len(mask.q_lengths)
    return SparseGrid(int(mask.q_lengths.max()), tiles, tiles * q.shape[0] * q.shape[1])


def flash_sparse_dkv(q, k, v, do, lse, delta, mask: BlockMask, *, sm_scale: float):
    """``(dk, dv)`` from the dK/dV kernel (CPU: the plain version).  Keeps
    the launch's ``SparseGrid`` as ``.grid`` beside ``.launches``."""
    if q.device.type == "cpu":
        return flash_sparse_dkv_plain(q, k, v, do, lse, delta, mask, sm_scale=sm_scale)
    _check_cuda(mask, q, k, v, do)
    _check_rows(q, lse, delta)
    return _launch_dkv(q, k, v, do, lse, delta, mask, sm_scale)


def _launch_dkv(q, k, v, do, lse, delta, mask: BlockMask, sm_scale: float):
    """The dK/dV entry's launch on checked inputs: the bf16 plan at the
    cap ``dkv_chunk_cap`` gives for these shapes, its workspace (torch's
    caching allocator) and the stream's kept tickets; or the fp32
    template's grid."""
    t = mask.tables(q.device)
    b, h, _, d = q.shape
    h_kv = k.shape[1]
    stream, sms = ff._cuda_args(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = tickets = entries = None
    if q.dtype == torch.bfloat16:
        cap = dkv_chunk_cap(mask.kv_lengths, b, h_kv, h // h_kv, d, sms)
        plan, entries = mask.dkv_plan(q.device, h // h_kv, cap)
        grid = plan.grid(b, h_kv)
        if plan.slots:
            part = torch.empty(plan.part_numel(b, h_kv, d), dtype=torch.float32, device=q.device)
            tickets = ff._tickets(q.device, stream, plan.split_tiles * b * h_kv)
    else:  # the fp32 template: one block per (KV tile, KV head, batch)
        walks = (h // h_kv) * mask.kv_lengths
        grid = SparseGrid(int(walks.max()), len(walks), len(walks) * b * h_kv)
    err = _lib().fam_flash_sparse_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), t.kv_ptr.data_ptr(),
        t.kv_list.data_ptr(), t.bit_tiles.data_ptr(), ff._ptr(entries), ff._ptr(part),
        ff._ptr(tickets), *_dims(q, k, sm_scale, stream)[:-1], grid.chunks, stream,
    )
    if err:
        raise RuntimeError(f"flash_sparse_dkv kernel launch failed: cudaError_t {err}")
    flash_sparse_dkv.launches += 1
    flash_sparse_dkv.grid = grid
    return dk, dv


def flash_sparse_dq(q, k, v, do, lse, delta, mask: BlockMask, *, sm_scale: float):
    """``dq`` from the dQ kernel (CPU: the plain version).  Keeps the
    launch's ``SparseGrid`` as ``.grid`` beside ``.launches``."""
    if q.device.type == "cpu":
        return flash_sparse_dq_plain(q, k, v, do, lse, delta, mask, sm_scale=sm_scale)
    _check_cuda(mask, q, k, v, do)
    _check_rows(q, lse, delta)
    return _launch_dq(q, k, v, do, lse, delta, mask, sm_scale)


def _launch_dq(q, k, v, do, lse, delta, mask: BlockMask, sm_scale: float):
    """The dQ entry's launch on checked inputs (bf16: Q tiles longest list
    first)."""
    t = mask.tables(q.device)
    stream, _ = ff._cuda_args(q)
    order = mask.dq_order(q.device) if q.dtype == torch.bfloat16 else None
    dq = torch.empty_like(q)
    err = _lib().fam_flash_sparse_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), t.q_ptr.data_ptr(), t.q_list.data_ptr(),
        t.bit_tiles.data_ptr(), ff._ptr(order), *_dims(q, k, sm_scale, stream),
    )
    if err:
        raise RuntimeError(f"flash_sparse_dq kernel launch failed: cudaError_t {err}")
    flash_sparse_dq.launches += 1
    flash_sparse_dq.grid = _q_tile_grid(mask, q)
    return dq


# Launches of each CUDA kernel since import (the CPU route does not count),
# and each kernel's grid at its last launch (None before one).
flash_sparse_fwd.launches = 0
flash_sparse_dkv.launches = 0
flash_sparse_dq.launches = 0
flash_sparse_fwd.grid = None
flash_sparse_dkv.grid = None
flash_sparse_dq.grid = None


def _checked(q, k, v, mask: BlockMask, sm_scale):
    check_shapes(q, k, v)
    if (q.shape[2], k.shape[2]) != (mask.n_q, mask.n_kv):
        raise ValueError(
            f"mask compiled for {(mask.n_q, mask.n_kv)}, inputs are {(q.shape[2], k.shape[2])}")
    return default_scale(q.shape[-1]) if sm_scale is None else sm_scale


def flash_attention_block_sparse_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: BlockMask,
    *,
    sm_scale: Optional[float] = None,
    save_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Forward attention under a block-sparse mask over ``[B, H, N, D]``
    inputs (``k``/``v`` may have fewer heads: GQA).  Returns ``o`` or
    ``(o, lse)``, lse fp32 ``[B, H, N_q]``; rows that see nothing give
    ``o = 0``, ``lse = -inf``.  Work and bytes scale with the visited tile
    pairs.  fp16 computes in fp32 and returns fp16."""
    sm_scale = _checked(q, k, v, mask, sm_scale)
    if q.dtype == torch.float16:
        out = flash_sparse_fwd(q.float(), k.float(), v.float(), mask, sm_scale=sm_scale,
                               save_lse=save_lse)
        return (out[0].half(), out[1]) if save_lse else out.half()
    return flash_sparse_fwd(q, k, v, mask, sm_scale=sm_scale, save_lse=save_lse)


def flash_attention_block_sparse_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    mask: BlockMask,
    *,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` under the block-sparse mask: ``delta = rowsum(o *
    dO)`` (a torch op), then the dK/dV and the dQ kernel.  GQA is native
    (dK/dV summed over the group in fp32); gradients in the inputs' dtype,
    fp16 computed in fp32."""
    sm_scale = _checked(q, k, v, mask, sm_scale)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("o and do must be shaped like q, lse like q[..., 0]")
    if q.dtype == torch.float16:
        grads = flash_attention_block_sparse_bwd(
            q.float(), k.float(), v.float(), o.float(), do.float(), lse, mask, sm_scale=sm_scale)
        return tuple(g.half() for g in grads)
    delta = bwd_delta(o, do, None)
    dk, dv = flash_sparse_dkv(q, k, v, do, lse, delta, mask, sm_scale=sm_scale)
    dq = flash_sparse_dq(q, k, v, do, lse, delta, mask, sm_scale=sm_scale)
    return dq, dk, dv


class _BlockSparse(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves o and lse, the backward runs
    the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mask, sm_scale):
        o, lse = flash_attention_block_sparse_fwd(q, k, v, mask, sm_scale=sm_scale, save_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.sm_scale = mask, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_block_sparse_bwd(
            q, k, v, o, do.contiguous(), lse, ctx.mask, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_block_sparse(q, k, v, mask: BlockMask, sm_scale: Optional[float] = None):
    """Differentiable block-sparse flash attention (the JAX op's positional
    form, less ``interpret``).  ``mask``: a ``BlockMask`` compiled for
    ``(n_q, n_kv)``; GQA native in both directions."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BlockSparse.apply(q, k, v, mask, sm_scale)
    return flash_attention_block_sparse_fwd(q, k, v, mask, sm_scale=sm_scale)


def block_sparse_attention(q, k, v, mask: BlockMask, *, sm_scale: Optional[float] = None):
    """Keyword front door of ``flash_attention_block_sparse``."""
    return flash_attention_block_sparse(q, k, v, mask, sm_scale)
