"""Forward flash attention: the router, two CUDA kernels' wrappers and
their plain versions.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_fwd.py``.
``flash_attention_fwd`` routes as the JAX wrapper does
(``flash_fwd.py:750-958``), between three kernels:

* ``flash_tri.flash_attention_tri`` (``csrc/flash_tri.cu``) for causal
  calls with a static offset (None or an int) and ``pos_div == 1``;
* ``flash_fwd_lean`` (``csrc/flash_lean.cu``, the Pallas
  ``_fwd_kernel_lean``) for the other calls with a static offset,
  ``pos_div == 1`` and the whole KV row in one block (``n_kv <=
  LEAN_MAX_KV``, the default ``block_k_major``);
* ``flash_fwd_general`` (``csrc/flash_fwd.cu``, the Pallas ``_fwd_kernel``)
  for everything else: tensor offsets (per-batch, on the device), the
  ``pos_div`` row fold of GQA decode, longer non-causal rows.

Lean and general compute one function (lean's offset is one int for every
batch), so on the card their bf16 calls with ``pos_div == 1`` run one
``wgmma`` kernel (``csrc/flash_fwd_sm90.cuh``), each entry with its own
launch count; fp32 prefill runs ``csrc/flash_fwd.cu``'s template.

Decode (``n_q <= DECODE_ROWS``) runs the split-KV grid of
``csrc/flash_decode.cuh`` over every cache, dense or not: the
KV columns are cut into chunks of ``decode_kv_chunk`` columns, a pure
function of static shapes and the card's SM count, each chunk a block; the
last block of a (q-head, batch) merges the chunks' partials
(``merge_splits_plain`` is that merge in PyTorch).  The wrappers of the
dense, 8-bit and paged caches share ``split_args`` for it.

fp16 inputs run the fp32 route and are cast back, as in JAX (Mosaic has no
fp16 datapath; the CUDA kernels take bf16 and fp32).  The JAX router also
sends causal calls away from the triangular kernel past N = 4096 or at
tile-unfriendly lengths (``tri_heuristic``, ``_TRI_MAX_N``,
``_UNROLL_CAP``): those are Mosaic compile limits, so the port's
triangular kernel takes every N.

The sliding window with attention sinks, packed segment ids, the score
transforms (the tanh softcap, ALiBi) and attention dropout are the general
kernel's, as in JAX (``flash_fwd.py:829-838, 932-958``): a call that asks
for any goes to it.
A window skips the KV tiles outside the window and the sinks, and the
decode grid's splits that hold none of them run no step.  Segment ids are
an element test on every step and take no split.  The transforms act on
each score between the QK^T product and the mask (``csrc/xf.cuh``); ALiBi
takes no GQA row fold (``pos_div`` 1: a folded row is not one q-head).
Dropout (``csrc/dropout.cuh``) multiplies each P of the PV product by a
keep factor hashed from a seed on the device and the score's tensor
coordinates; the row statistics and the lse stay those of the undropped
P.  It takes one row per position and one KV split, so a dropout call
never takes the decode grid (bf16 runs the ``wgmma`` kernel, fp32 the
template).  The rolling caches' position map (``kv_positions``, int32 ``[B,
N_kv]``: the global position each slot holds, -1 for none) moves the causal
mask, the window and ALiBi's distance into position space; slot order is
not position order after a wrap, so such a call visits every KV tile of
the cache (the walks' and the decode grid's ``kPos`` instances).

Each kernel's wrapper takes its plain version for a tensor on the CPU and
launches the kernel, or raises, for a CUDA tensor.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..config import DEFAULT_MASK_VALUE, SegmentIds, default_scale
from . import _build
from ._common import dropout_inv_keep, dropout_threshold, keep_factors, pack_dropout_seed

# The head dims every CUDA kernel is built for (a template parameter of
# each, dispatched at its C entry).
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

def check_positions(kv_positions: Optional[torch.Tensor], batch: int, n_kv: int, *,
                    causal: bool, pos_div: int = 1, dropout_rate: float = 0.0,
                    device=None) -> Optional[torch.Tensor]:
    """A rolling cache's position map as the kernels take it: int32 ``[B,
    N_kv]``, contiguous, on ``device`` (None: none).  It needs ``causal`` and
    takes no row fold, as in JAX (``flash_fwd.py:899-916``); dropout is a
    training-path feature it takes none of (``ops/attention.py:404-412``)."""
    if kv_positions is None:
        return None
    if not causal:
        raise ValueError("kv_positions requires causal=True")
    if pos_div != 1:
        raise NotImplementedError(
            "pos_div > 1 (GQA decode head-fold) does not compose with kv_positions"
        )
    if dropout_rate:
        raise NotImplementedError(
            "dropout is a training-path feature; rolling-cache (kv_positions) serving does "
            "not support it"
        )
    pos = torch.as_tensor(kv_positions)
    if pos.dtype.is_floating_point or tuple(pos.shape) != (batch, n_kv):
        raise ValueError(f"kv_positions must be integers [{batch}, {n_kv}], got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    return pos.to(device=device, dtype=torch.int32).contiguous()


def check_xf(softcap: Optional[float], alibi_slopes: Optional[torch.Tensor], heads: int,
             device, pos_div: int = 1) -> Tuple[float, Optional[torch.Tensor]]:
    """The score transforms as the C entries take them: ``(softcap, slopes)``
    with softcap 0.0 for none (a cap must be > 0) and the slopes an fp32
    ``[heads]`` contiguous tensor on ``device``, or None.  ALiBi takes no
    row fold (``pos_div`` 1), as in JAX."""
    cap = 0.0 if softcap is None else float(softcap)
    if softcap is not None and not cap > 0.0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if alibi_slopes is None:
        return cap, None
    if pos_div != 1:
        raise NotImplementedError(
            "pos_div > 1 (the GQA decode fold) needs per-row ALiBi slopes; use the unfolded path"
        )
    slopes = torch.as_tensor(alibi_slopes).to(device=device, dtype=torch.float32).reshape(-1)
    if slopes.shape != (heads,):
        raise ValueError(f"alibi_slopes must be [{heads}] (one per q-head), got "
                         f"{tuple(torch.as_tensor(alibi_slopes).shape)}")
    return cap, slopes.contiguous()


class Dropout(NamedTuple):
    """A call's attention dropout as the kernels take it: the rate, the
    packed int32 ``[seed, row_off, col_off, batch_off, head_off]`` on the
    call's device, and the (b, h) stream's head count (None: the call's
    q-heads)."""

    rate: float
    seed: torch.Tensor
    heads: Optional[int]

    def c_args(self, n_heads: int) -> tuple:
        """``(seed pointer, threshold, inv_keep, heads)`` of the C entries."""
        return (self.seed.data_ptr(), dropout_threshold(self.rate), dropout_inv_keep(self.rate),
                n_heads if self.heads is None else self.heads)

    def keep(self, shape, device) -> torch.Tensor:
        """fp32 keep factors of a ``[B, H, N_q, N_kv]`` call
        (``_common.keep_factors``): what the plain versions multiply."""
        return keep_factors(shape, self.rate, self.seed, self.heads, device)


# The C entries' dropout arguments of a call without dropout.
NO_DROPOUT_ARGS = (None, 0, 1.0, 0)


def check_dropout(rate: float, seed, offsets=None, heads: Optional[int] = None, device=None,
                  pos_div: int = 1) -> Optional[Dropout]:
    """A call's dropout, checked as JAX checks it (``flash_fwd.py:905-929``):
    None for a rate of 0 (the seed then unread), else a ``Dropout`` whose
    seed is packed (``_common.pack_dropout_seed``: a scalar, or packed
    ``[5]``, with ``offsets`` (row, col, batch, head)) and lies on
    ``device``, contiguous.  The rate is in (0, 1), a seed is given, and
    the row fold of GQA decode (``pos_div`` > 1) takes none."""
    if not rate:
        return None
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if pos_div != 1:
        raise NotImplementedError(
            "pos_div > 1 (GQA decode head-fold) does not compose with dropout"
        )
    if heads is not None and int(heads) < 1:
        raise ValueError(f"dropout_heads must be >= 1, got {heads}")
    packed = pack_dropout_seed(seed, offsets).to(device=device, dtype=torch.int32).contiguous()
    return Dropout(float(rate), packed, None if heads is None else int(heads))


def xf_parts(s: torch.Tensor, positions: torch.Tensor, softcap: Optional[float],
             alibi_slopes: Optional[torch.Tensor],
             kv_positions: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The score transforms on fp32 natural scores ``s [B, H, N_q, N_kv]``:
    ``(t, bias)`` with ``t = cap * tanh(s / cap)`` (``s`` without a cap) and
    the ALiBi bias ``slope_h * (c - p)`` in float64 (None without slopes),
    ``p`` the rows' positions (``[B or 1, 1, N_q, 1]``).  The transformed
    score is ``t + bias``; ``xf_exp`` takes ``exp(t + bias - ref)`` with the
    bias and the reference subtracted in float64, as the kernels do in one
    FMA (``csrc/xf.cuh``): a row far from every column it sees has scores
    in the thousands, where fp32 would keep 2^-13 of each.  With
    ``kv_positions`` (``[B, N_kv]``) ``c`` is the position a slot holds."""
    t = softcap * torch.tanh(s / softcap) if softcap else s
    if alibi_slopes is None:
        return t, None
    cols = (torch.arange(s.shape[-1], device=s.device) if kv_positions is None
            else kv_positions.to(s.device, torch.int64)[:, None, None, :])
    dist = (cols - positions).double()
    return t, alibi_slopes.to(s.device, torch.float64).reshape(1, -1, 1, 1) * dist


def xf_exp(t: torch.Tensor, bias: Optional[torch.Tensor], ref: torch.Tensor) -> torch.Tensor:
    """``exp(t + bias - ref)``, ``ref`` broadcast over the columns; ``bias
    - ref`` in float64 (``xf_parts``)."""
    if bias is None:
        return torch.exp(t - ref)
    return torch.exp(t + (bias - ref.double()).float())


def row_positions(n_q: int, q_offset: torch.Tensor, pos_div: int = 1, device=None) -> torch.Tensor:
    """``[B, 1, N_q, 1]`` positions ``r // pos_div + q_offset[b]``."""
    row = torch.arange(n_q, device=device) // pos_div
    return row[:, None] + q_offset.to(device, torch.int64).reshape(-1, 1, 1, 1)


def window_args(window: Optional[int], sinks: int, causal: bool) -> Tuple[int, int]:
    """``(window, sinks)`` as the C entries take them: 0 for no window (and
    then no sinks: they apply only beside a window, as in JAX).  A window
    needs ``causal`` and is at least 1; sinks are at least 0."""
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    if window is None:
        return 0, 0
    if not causal:
        raise ValueError("window requires causal=True")
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return int(window), int(sinks)


def check_segment_ids(segment_ids: Optional[SegmentIds], batch: int, n_q: int, n_kv: int,
                      device) -> Optional[SegmentIds]:
    """The ids as int32 ``[B, N_q]`` and ``[B, N_kv]`` tensors on ``device``
    (contiguous, as the kernels read them), or None."""
    if segment_ids is None:
        return None
    sq, skv = segment_ids.q, segment_ids.kv
    if tuple(sq.shape) != (batch, n_q) or tuple(skv.shape) != (batch, n_kv):
        raise ValueError(f"segment ids [{batch}, {n_q}] and [{batch}, {n_kv}] expected, got "
                         f"{tuple(sq.shape)} and {tuple(skv.shape)}")
    if sq.dtype.is_floating_point or skv.dtype.is_floating_point:
        raise TypeError("segment ids must be integers")
    return SegmentIds(sq.to(device=device, dtype=torch.int32).contiguous(),
                      skv.to(device=device, dtype=torch.int32).contiguous())


def plain_visible(n_q: int, n_kv: int, q_offset: torch.Tensor, *, causal: bool,
                  pos_div: int = 1, window: Optional[int] = None, sinks: int = 0,
                  segment_ids: Optional[SegmentIds] = None, device=None,
                  kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bool ``[B or 1, 1, N_q, N_kv]``: the pairs a kernel's contract lets a
    row see.  With ``causal`` row ``r`` of batch ``b`` sits at position ``p
    = r // pos_div + q_offset[b]`` and sees ``c <= p``, with a window only
    ``c > p - window`` unless ``c < sinks``; segment ids: equal ids only.
    With ``kv_positions`` (``[B, N_kv]``) ``c`` is the position slot ``j``
    holds, and a slot of a negative position (never written) is hidden."""
    visible = torch.ones((1, 1, n_q, n_kv), dtype=torch.bool, device=device)
    if causal:
        col = torch.arange(n_kv, device=device)
        pos = row_positions(n_q, q_offset, pos_div, device)
        if kv_positions is not None:
            col = kv_positions.to(device, torch.int64)[:, None, None, :]
        visible = col <= pos
        if kv_positions is not None:
            visible = visible & (col >= 0)
        if window is not None:
            keep = col > pos - window
            if sinks:
                keep = keep | (col < sinks)
            visible = visible & keep
    if segment_ids is not None:
        seg = segment_ids.q.to(device)[:, None, :, None] == segment_ids.kv.to(device)[:, None, None, :]
        visible = visible & seg
    return visible


def _offsets(q_offset, batch: int, default: int, device) -> torch.Tensor:
    """``q_offset`` (None, int or tensor) as an int32 ``[batch]`` tensor."""
    if q_offset is None:
        q_offset = default
    if not torch.is_tensor(q_offset):
        return torch.full((batch,), int(q_offset), dtype=torch.int32, device=device)
    off = q_offset.to(device=device, dtype=torch.int32).reshape(-1)
    return off.expand(batch).contiguous() if off.numel() == 1 else off


# Query rows of the decode grid's tile (csrc/kv_tiles.cuh, kDecodeRows):
# calls with at most this many rows split their KV walk across blocks.
DECODE_ROWS = 16
# Rows of the kernels' KV tile: a chunk is a whole number of tiles.
KV_TILE = 64
# The decode grid's split rule, measured by ``onchip decode_splits`` on an
# H100 (1 to 64 slots of 8 folded KV heads over 2048 columns, D 64 and
# 128): chunks of fewer than 4 tiles lose more to the merge and the
# blocks' fixed costs than they gain, and past about 16 blocks per SM a
# longer chunk is as fast.
SPLIT_BLOCKS_PER_SM = 16
MIN_CHUNK_TILES = 4


def decode_kv_chunk(batch: int, heads: int, n_q: int, n_kv: int, sm_count: int) -> int:
    """KV columns per split of a call: a multiple of ``KV_TILE``, from static
    shapes alone (never from the slots' lengths, which live on the device).

    A call of more than ``DECODE_ROWS`` query rows keeps one block per
    64-row q tile and is not split (one chunk over the row).  A decode call
    has one block per (q-head, batch); its row is cut into chunks of at
    least ``MIN_CHUNK_TILES`` tiles, and into as many more as it takes to
    give the grid ``SPLIT_BLOCKS_PER_SM`` blocks per SM.  The head dim does
    not enter the rule: the bytes of a tile scale with it on both sides of
    the trade (the same chunk measured fastest at 64 and 128).  At the
    serving shape (64 units over 2048 columns) the tile floor alone sets
    the chunk; the blocks-per-SM term lengthens it from 64 slots up.
    """
    tiles = -(-n_kv // KV_TILE)
    if n_q > DECODE_ROWS:
        return tiles * KV_TILE
    splits = -(-SPLIT_BLOCKS_PER_SM * sm_count // (batch * heads))
    return min(tiles, max(MIN_CHUNK_TILES, -(-tiles // splits))) * KV_TILE


def kv_splits(n_kv: int, kv_chunk: int) -> int:
    """Blocks a (q-head, batch) of a call takes: chunks of its KV row."""
    return -(-n_kv // kv_chunk)


class SplitGrid(NamedTuple):
    """The grid of one launch of a ``csrc/flash_fwd.cu`` entry: KV columns
    per split, splits per (q-head, batch), and blocks (split x q-head x
    batch on the decode grid; 64-row q tile x q-head x batch above it)."""

    kv_chunk: int
    kv_splits: int
    blocks: int


def split_workspace_numel(batch: int, heads: int, n_q: int, head_dim: int, splits: int) -> int:
    """fp32 elements of the partials: o ``[B*H*splits*n_q, D]``, then m and l."""
    return batch * heads * splits * n_q * (head_dim + 2)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cuda_args(q: torch.Tensor) -> Tuple[int, int]:
    """``(stream, sm_count)`` of the card q lies on."""
    return torch.cuda.current_stream(q.device).cuda_stream, _sm_count(q.device.index)


# One int32 ticket per (q-head, batch), all zero between calls (the merging
# block resets its own), per (device, stream): calls on one stream run in
# order, so they never share a ticket at once.
_TICKETS: Dict[Tuple[str, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (str(device), stream)
    held = _TICKETS.get(key)
    if held is None or held.numel() < n:
        held = _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return held


def split_args(q: torch.Tensor, n_kv: int, split: bool = True) -> tuple:
    """``(grid, part, tickets, stream)`` for a launch of a
    ``csrc/flash_fwd.cu`` entry over q and a KV row of ``n_kv`` columns:
    the ``SplitGrid`` of ``decode_kv_chunk``'s chunk, and for more than one
    split the partials' workspace (torch's caching allocator: no
    ``cudaMalloc`` per call) and the stream's tickets; else None for both.
    Keep ``part`` alive until the launch has been issued.  The wrapper
    keeps ``grid`` as its ``.grid`` beside its ``.launches``.  ``split``
    False (segment ids: no decode grid) keeps one chunk over the row."""
    batch, heads, n_q, head_dim = q.shape
    stream, sms = _cuda_args(q)
    kv_chunk = decode_kv_chunk(batch, heads, n_q, n_kv, sms)
    if not split:
        kv_chunk = -(-n_kv // KV_TILE) * KV_TILE
    splits = kv_splits(n_kv, kv_chunk)
    tiles = splits if n_q <= DECODE_ROWS and split else -(-n_q // KV_TILE)
    grid = SplitGrid(kv_chunk, splits, tiles * heads * batch)
    if splits == 1:
        return grid, None, None, stream
    part = torch.empty(split_workspace_numel(batch, heads, n_q, head_dim, splits),
                       dtype=torch.float32, device=q.device)
    return grid, part, _tickets(q.device, stream, batch * heads), stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _plain_scores(q, k, v, q_offset, sm_scale, causal, pos_div, k_scale, v_scale,
                  window=None, sinks=0, segment_ids=None, softcap=None, alibi_slopes=None,
                  kv_positions=None):
    """The plain versions' fp32 ``((t, bias), visible, v, v_scale
    columns)``: K/V repeated to q's heads, the K scale on each score
    column, the score transforms (``xf_parts``: the scores are ``t + bias``),
    the visibility of ``plain_visible``, and the V scale as a ``[B, H, 1,
    N_kv]`` factor of P's columns (None unscaled)."""
    _, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    if k_scale is not None:
        s = s * k_scale.repeat_interleave(group, dim=1)[:, :, None, :]
    s = xf_parts(s, row_positions(n_q, q_offset, pos_div, q.device), softcap, alibi_slopes,
                 kv_positions)
    visible = plain_visible(n_q, n_kv, q_offset, causal=causal, pos_div=pos_div, window=window,
                            sinks=sinks, segment_ids=segment_ids, device=q.device,
                            kv_positions=kv_positions)
    v_cols = None if v_scale is None else v_scale.repeat_interleave(group, dim=1)[:, :, None, :]
    return s, visible, vf, v_cols


def flash_attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: torch.Tensor,
    *,
    sm_scale: float,
    causal: bool,
    pos_div: int = 1,
    save_lse: bool = False,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    drop: Optional[Dropout] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The kernel's contract in fp32 PyTorch (``q_offset``: int32 ``[B]``).

    ``k_scale``, ``v_scale``: fp32 ``[B, H_kv, N_kv]`` per-token scales of
    an 8-bit ``k``, ``v`` (``kernels/quant.py``): the K scale multiplies
    each score column, the V scale each column of P.  ``window``,
    ``sinks``, ``segment_ids``: see ``plain_visible``; ``softcap``,
    ``alibi_slopes``: see ``xf_parts`` (rows at ``r // pos_div +
    q_offset[b]``, also when not causal).  ``drop``: a checked ``Dropout``
    (``check_dropout``) or None; P of the PV product times its keep
    factors, the row sums and the lse of the undropped P.  ``kv_positions``:
    a rolling cache's position map (``plain_visible``, ``xf_parts``).
    """
    (t, bias), visible, vf, v_cols = _plain_scores(q, k, v, q_offset, sm_scale, causal, pos_div,
                                                   k_scale, v_scale, window, sinks, segment_ids,
                                                   softcap, alibi_slopes, kv_positions)
    s = t if bias is None else t + bias.float()
    s = s.masked_fill(~visible, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    if bias is None:
        p = torch.exp(s - m) * visible
    else:  # a row that sees nothing has m = DEFAULT_MASK_VALUE: no inf * 0 here
        p = xf_exp(t, bias, m).masked_fill(~visible, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    pv = p if v_cols is None else p * v_cols
    if drop is not None:
        pv = pv * drop.keep(p.shape, q.device)
    o = (torch.matmul(pv, vf) / l_safe).to(q.dtype)
    if not save_lse:
        return o
    lse = torch.where(l == 0.0, float("-inf"), m + torch.log(l_safe))[..., 0]
    return o, lse


def split_partials_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: torch.Tensor,
    kv_chunk: int,
    *,
    sm_scale: float,
    causal: bool,
    pos_div: int = 1,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode grid's partials in fp32 PyTorch: ``(o_s, m_s, l_s)``, each
    with a leading split axis, for chunks of ``kv_chunk`` columns.

    Split s sees the columns of ``[s * kv_chunk, (s + 1) * kv_chunk)`` that
    the contract lets a row see: ``m_s`` is the row's max score over them
    (natural log units), ``l_s = sum exp(s - m_s)``, ``o_s = sum exp(s - m_s)
    * s_v * v``, not normalised.  A row that sees none of a split's columns
    (a chunk past the diagonal: an empty split) has ``m_s = -inf``, ``l_s =
    0`` and ``o_s = 0``: so is a split wholly outside a row's window and
    sinks, and under ``kv_positions`` a split of slots never written.
    """
    (t, bias), visible, vf, v_cols = _plain_scores(q, k, v, q_offset, sm_scale, causal, pos_div,
                                                   k_scale, v_scale, window, sinks, None, softcap,
                                                   alibi_slopes, kv_positions)
    s = t if bias is None else t + bias.float()
    n_kv = k.shape[2]
    col = torch.arange(n_kv, device=q.device)
    os_, ms_, ls_ = [], [], []
    for start in range(0, n_kv, kv_chunk):
        seen = visible & (col >= start) & (col < start + kv_chunk)
        m = s.masked_fill(~seen, float("-inf")).amax(dim=-1, keepdim=True)
        p = xf_exp(t, bias, torch.where(torch.isinf(m), 0.0, m)).masked_fill(~seen, 0.0)
        pv = p if v_cols is None else p * v_cols
        os_.append(torch.matmul(pv, vf))
        ms_.append(m[..., 0])
        ls_.append(p.sum(dim=-1))
    return torch.stack(os_), torch.stack(ms_), torch.stack(ls_)


def merge_splits_plain(
    o_s: torch.Tensor, m_s: torch.Tensor, l_s: torch.Tensor, dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` from the splits' partials (``split_partials_plain``'s
    layout), merged in split order: ``o = sum_s e^(m_s - M) o_s / sum_s
    e^(m_s - M) l_s`` with ``M = max_s m_s``, ``lse = M + log L``; a split
    with ``m_s = -inf`` weighs 0, and a row that no split saw gives 0 and
    -inf.  ``o`` in ``dtype``, ``lse`` fp32."""
    big = m_s.amax(dim=0)
    safe = torch.where(torch.isinf(big), 0.0, big)
    weight = torch.where(torch.isinf(m_s), 0.0, torch.exp(m_s - safe))
    o = torch.zeros_like(o_s[0])
    total = torch.zeros_like(l_s[0])
    for s in range(o_s.shape[0]):
        o = o + weight[s][..., None] * o_s[s]
        total = total + weight[s] * l_s[s]
    seen = total > 0.0
    o = o / torch.where(seen, total, 1.0)[..., None]
    lse = torch.where(seen, big + torch.log(torch.where(seen, total, 1.0)), float("-inf"))
    return o.to(dtype), lse


def flash_fwd_lean_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int,
    *,
    sm_scale: float,
    causal: bool,
    save_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The lean kernel's contract in fp32 PyTorch: the general contract
    with one static offset for every batch (the softmax exact, the whole
    row's max first)."""
    off = torch.full((q.shape[0],), int(q_offset), dtype=torch.int32, device=q.device)
    return flash_attention_fwd_plain(
        q, k, v, off, sm_scale=sm_scale, causal=causal, save_lse=save_lse
    )


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``fam_flash_fwd``'s C signature on a loaded library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fam_flash_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, q_offset, o, lse
        i32, i32, i32, i32, i32, i32,  # batch, heads, kv heads, n_q, n_kv, head_dim
        ctypes.c_float, i32, i32, i32,  # sm_scale, causal, pos_div, dtype
        i32, i32, ptr, ptr,  # window (0: none), sinks, q segment ids, kv segment ids
        ctypes.c_float, ptr,  # softcap (0: none), ALiBi slopes
        ptr, i32, ctypes.c_float, i32,  # dropout seed (null: none), threshold, 1/keep, heads
        ptr,  # kv positions (null: none)
        i32, ptr, ptr,  # kv_chunk, part, tickets
        ptr,  # stream
    ]
    lib.fam_flash_fwd.restype = ctypes.c_int
    return lib


def bind_lean(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``fam_flash_lean``'s C signature on a loaded library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fam_flash_lean.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, o, lse
        i32, i32, i32, i32, i32, i32,  # batch, heads, kv heads, n_q, n_kv, head_dim
        ctypes.c_float, i32, i32, i32,  # sm_scale, causal, q_offset, dtype
        ptr,  # stream
    ]
    lib.fam_flash_lean.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind_lean(bind(_build.load()))


def check_head_dim(head_dim: int) -> None:
    """Raise ``ValueError`` for a head dim the kernels are not built for."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(
            f"the CUDA kernels are built for head_dim {' or '.join(map(str, HEAD_DIMS))}, "
            f"got {head_dim}"
        )


def _check_cuda_inputs(q, k, v, q_offset=None) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes bf16 or fp32 inputs, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    check_head_dim(q.shape[-1])
    for name, t in (("q", q), ("k", k), ("v", v), ("q_offset", q_offset)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "q_offset" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """``[B, H, N, D]`` q over ``[B, H_kv, N_kv, D]`` k and v, ``H_kv | H``."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected [B, H, N, D] q, k, v; got {q.shape}, {k.shape}, {v.shape}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or q.shape[1] % k.shape[1]:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q shape {tuple(q.shape)}")


def _new_outputs(q: torch.Tensor, save_lse: bool):
    lse = (
        torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if save_lse else None
    )
    return torch.empty_like(q), lse


def flash_fwd_general(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: Union[None, int, torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    save_lse: bool = False,
    pos_div: int = 1,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_offsets=None,
    dropout_heads: Optional[int] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The general kernel (``csrc/flash_fwd.cu``; bf16 with ``pos_div ==
    1`` and more than ``DECODE_ROWS`` rows, or segment ids or dropout, on
    the ``wgmma`` kernel of ``csrc/flash_fwd_sm90.cuh``) over ``[B, H, N,
    D]``.

    ``k``/``v`` may have fewer heads than ``q`` (GQA: q-head ``h`` reads
    kv-head ``h // group``).  With ``causal``, row ``r`` of batch ``b`` sees
    columns ``c <= r // pos_div + q_offset[b]``; ``q_offset`` is an int or
    a ``[B]`` tensor and defaults to ``n_kv - n_q // pos_div``.  Returns
    ``o`` (``q``'s dtype) or ``(o, lse)`` with ``lse`` fp32 ``[B, H, N_q]``;
    rows with nothing visible give ``o = 0`` and ``lse = -inf``.

    ``window`` (needs ``causal``): row ``r`` at position ``p = r // pos_div
    + q_offset[b]`` sees only ``c > p - window``, besides ``c < sinks``;
    the KV tiles outside both are skipped.  ``segment_ids``
    (``config.SegmentIds``, not with ``pos_div > 1``): equal ids only.
    ``softcap`` (> 0): each scaled score ``s -> softcap * tanh(s /
    softcap)``; ``alibi_slopes`` (``[H]``, not with ``pos_div > 1``): then
    ``+ slope_h * (c - p)``, with ``p`` the row's position also when not
    causal.  ``dropout_rate`` (in [0, 1)) with ``dropout_seed`` (an int32
    scalar, or packed ``[5]``, a tensor on the card or on the host, or an
    int), ``dropout_offsets`` (row, col, batch, head) and ``dropout_heads``
    (the global head count): attention dropout, each P of the PV product
    times the keep factor of its (batch, q-head, row, column), tensor
    indices plus the offsets (``_common.keep_factors``).  The lse is the
    undropped one's.  ``kv_positions`` (int32 ``[B, N_kv]``, needs
    ``causal``, no row fold or dropout): slot ``j`` holds position
    ``kv_positions[b, j]`` (-1: never written, hidden), and the causal mask,
    the window, the sinks and ALiBi's distance act on those positions: row
    ``r`` at ``p = r + q_offset[b]`` sees slot ``j`` when ``0 <= pos <= p``
    (and ``pos > p - window`` or ``pos < sinks``; with segment ids, only a
    slot of the row's id).  Every KV tile is visited: slot order is not
    position order.  With segment ids a call of any ``n_q`` runs the
    segmented position walk (bf16: the ``wgmma`` kernel's, fp32: the
    template's), never the decode grid.
    """
    check_shapes(q, k, v)
    batch, heads, n_q, head_dim = q.shape
    if pos_div < 1 or (pos_div > 1 and not causal):
        raise ValueError(f"pos_div={pos_div} must be >= 1, and > 1 only with causal")
    if pos_div > 1 and segment_ids is not None:
        raise NotImplementedError("pos_div > 1 (the GQA decode fold) does not take segment_ids")
    n_kv = k.shape[2]
    w, n_sinks = window_args(window, sinks, causal)
    seg = check_segment_ids(segment_ids, batch, n_q, n_kv, q.device)
    cap, slopes = check_xf(softcap, alibi_slopes, heads, q.device, pos_div)
    pos = check_positions(kv_positions, batch, n_kv, causal=causal, pos_div=pos_div,
                          dropout_rate=dropout_rate, device=q.device)
    drop = check_dropout(dropout_rate, dropout_seed, dropout_offsets, dropout_heads, q.device,
                         pos_div)
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    off = _offsets(q_offset, batch, n_kv - n_q // pos_div, q.device)
    if off.shape != (batch,):
        raise ValueError(f"q_offset must be an int or a [{batch}] tensor")

    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, off, sm_scale=sm_scale, causal=causal, pos_div=pos_div,
            save_lse=save_lse, window=window if w else None, sinks=n_sinks, segment_ids=seg,
            softcap=softcap, alibi_slopes=slopes, drop=drop, kv_positions=pos,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, off)
    if pos is not None and pos.device != q.device:
        raise ValueError(f"kv_positions is on {pos.device}, q on {q.device}")
    o, lse = _new_outputs(q, save_lse)
    grid, part, tickets, stream = split_args(q, n_kv, split=seg is None and drop is None)
    err = _lib().fam_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(), o.data_ptr(), _ptr(lse),
        batch, heads, k.shape[1], n_q, n_kv, head_dim, sm_scale, int(causal),
        pos_div, _DTYPE_CODES[q.dtype], w, n_sinks, None if seg is None else seg.q.data_ptr(),
        None if seg is None else seg.kv.data_ptr(), cap, _ptr(slopes),
        *(NO_DROPOUT_ARGS if drop is None else drop.c_args(heads)), _ptr(pos), grid.kv_chunk,
        _ptr(part), _ptr(tickets), stream,
    )
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {err}")
    flash_fwd_general.launches += 1
    flash_fwd_general.pos_launches += pos is not None
    flash_fwd_general.grid = grid
    return (o, lse) if save_lse else o


# The longest KV row the lean entry takes (csrc/flash_lean.cu, kMaxKv): the
# JAX package's default ``block_k_major`` (config.py), one block of its lean
# kernel.
LEAN_MAX_KV = 1024


def flash_fwd_lean(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: Optional[int] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    save_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The lean entry (``csrc/flash_lean.cu``): a KV row of ``n_kv <=
    LEAN_MAX_KV`` columns, a static int ``q_offset`` (default ``n_kv -
    n_q``, negative allowed), native GQA.  Returns ``o`` or ``(o, lse)``
    like ``flash_fwd_general``.

    On the card it runs the general forward's kernels with that one offset
    for every batch: bf16 the ``wgmma`` kernel, whose softmax is online
    where the Pallas kernel's is exact in two passes (only the rounding
    differs, within the ladder's 1e-2), fp32 the FMA template (within 1e-5
    of ``flash_fwd_lean_plain``)."""
    check_shapes(q, k, v)
    if torch.is_tensor(q_offset):
        raise TypeError("the lean kernel takes a static int q_offset")
    batch, heads, n_q, head_dim = q.shape
    n_kv = k.shape[2]
    if n_kv > LEAN_MAX_KV:
        raise ValueError(f"the lean kernel takes n_kv <= {LEAN_MAX_KV}, got {n_kv}")
    off = n_kv - n_q if q_offset is None else int(q_offset)
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    if q.device.type == "cpu":
        return flash_fwd_lean_plain(
            q, k, v, off, sm_scale=sm_scale, causal=causal, save_lse=save_lse
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v)
    o, lse = _new_outputs(q, save_lse)
    err = _lib().fam_flash_lean(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        batch, heads, k.shape[1], n_q, n_kv, head_dim, sm_scale, int(causal), off,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_lean kernel launch failed: cudaError_t {err}")
    flash_fwd_lean.launches += 1
    return (o, lse) if save_lse else o


# Launches of each CUDA kernel since import (the CPU route does not count),
# those of the general entry with a position map among them (its kPos
# instances), and the general entry's grid at its last launch (None before
# one).
flash_fwd_general.launches = 0
flash_fwd_general.pos_launches = 0
flash_fwd_general.grid = None
flash_fwd_lean.launches = 0


def is_static_offset(q_offset) -> bool:
    """None or a Python int: known when the call is made, as the JAX
    routers require of the lean and triangular kernels."""
    return q_offset is None or (isinstance(q_offset, int) and not isinstance(q_offset, bool))


def fwd_route(n_kv: int, q_offset, *, causal: bool, pos_div: int = 1,
              featured: bool = False) -> str:
    """The kernel ``flash_attention_fwd`` runs: ``"tri"``, ``"lean"`` or
    ``"general"`` (the JAX router's rules without its Mosaic limits).
    ``featured``: a window, segment ids, a score transform, dropout or a
    position map, which only the general kernel takes (JAX ``flash_fwd.py:829-838,
    932-958``)."""
    if is_static_offset(q_offset) and pos_div == 1 and not featured:
        if causal:
            return "tri"
        if n_kv <= LEAN_MAX_KV:
            return "lean"
    return "general"


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: Union[None, int, torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    save_lse: bool = False,
    pos_div: int = 1,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_offsets=None,
    dropout_heads: Optional[int] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flash-attention forward over ``[B, H, N, D]`` inputs, routed to the
    triangular, lean or general kernel (see the module docstring).

    The contract is ``flash_fwd_general``'s: GQA, causal masking with
    ``q_offset`` (None, an int or a ``[B]`` tensor; default
    ``n_kv - n_q // pos_div``), ``pos_div`` rows per position, the window
    with its sinks, segment ids, the softcap and ALiBi, dropout, a rolling
    cache's ``kv_positions``, ``o`` or ``(o, lse)``.  fp16 inputs compute in
    fp32 and return fp16.
    """
    feats = dict(window=window, sinks=sinks, segment_ids=segment_ids, softcap=softcap,
                 alibi_slopes=alibi_slopes, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                 dropout_offsets=dropout_offsets, dropout_heads=dropout_heads,
                 kv_positions=kv_positions)
    if q.dtype == torch.float16:
        out = flash_attention_fwd(
            q.float(), k.float(), v.float(), q_offset, sm_scale=sm_scale,
            causal=causal, save_lse=save_lse, pos_div=pos_div, **feats,
        )
        return (out[0].half(), out[1]) if save_lse else out.half()
    featured = bool(dropout_rate) or any(
        x is not None for x in (window, segment_ids, softcap, alibi_slopes, kv_positions))
    route = fwd_route(k.shape[-2], q_offset, causal=causal, pos_div=pos_div, featured=featured)
    if route == "tri":
        from .flash_tri import flash_attention_tri

        return flash_attention_tri(q, k, v, sm_scale=sm_scale, q_offset=q_offset, save_lse=save_lse)
    if route == "lean":
        return flash_fwd_lean(
            q, k, v, q_offset, sm_scale=sm_scale, causal=causal, save_lse=save_lse
        )
    return flash_fwd_general(
        q, k, v, q_offset, sm_scale=sm_scale, causal=causal, save_lse=save_lse,
        pos_div=pos_div, **feats,
    )
