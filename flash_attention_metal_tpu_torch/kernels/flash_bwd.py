"""Backward flash attention: the split pair's and the fused kernel's
wrappers, their plain versions and the backward router.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_bwd.py``.  The JAX
package has three backward variants.  ``flash_attention_bwd`` runs the
split pair, ``_dkv_kernel`` and ``_dq_kernel``, which the training step
reaches (traced offsets, GQA group 2): ``csrc/flash_bwd.cu`` computes their
contract with native GQA (no repeated K/V, dK/dV summed over the group in
fp32) and a per-batch device ``q_offset``, bf16 on the Hopper kernels of
``csrc/flash_bwd_sm90.cuh`` (``wgmma`` with P and dS as register operands,
a cp.async ring), fp32 in IEEE FMA; head dim 64 or 128.
``flash_attention_bwd_fused`` runs the 5-matmul ``_fused_bwd_kernel``:
one launch of ``csrc/flash_bwd_fused_sm90.cuh`` (bf16; the split pair's
dK/dV mainloop with a fifth ``wgmma`` product, dS K at head dim 64 and its
transpose at 128) or of the fp32 template of ``csrc/flash_bwd.cu``.  Each KV tile's block adds its dQ
contribution to one fp32 ``[B, H, N_q, D]`` accumulator in KV-tile order,
held by a counter per ``DQ_COUNTER_ROWS`` query rows
(``csrc/dq_ordered.cuh``), and the last KV tile a row sees writes dQ: the
same bits on every run, and an O(B H N D) workspace
(``dq_workspace_shape``).  GQA is native there too: the JAX kernel takes
equal heads only because the JAX op repeats K/V first.  The ``delta = rowsum(dO * O) - dlse`` precompute
stays a torch op, as it is plain jnp in the JAX package.

``flash_attention_bwd_auto`` routes in the JAX dispatcher's order of
precedence (``flash_bwd.py:404-517``): explicit ``block_sizes`` take the
split pair; otherwise the autotuner's saved decision for the shape
(``harness/autotune.py::lookup_bwd``, read from ``autotune_cache_torch.json``
only when that file exists) wins, a ``"tri"`` decision only where the
triangular backward (``flash_tri.flash_attention_bwd_tri``: the fused
kernel given one int offset, dK and dV in fp32) applies: plain causal calls
with equal head counts, a static offset (None or an int), ``pos_div == 1``
and no fp16.  With no decision every call takes the split pair.  That rule
is the H100's race, not JAX's: the JAX dispatcher sends plain causal calls
with a static offset to its triangular backward (with ``tri_bwd_heuristic``'s
v5e limits), but on the card the split pair beat the triangular kernel by
14-16% at the high-occupancy shape ``[16, 8, 2048, D]``, D 64 and 128, and
the fused one at every training shape (``harness/autotune.py --phase train``,
PERF.md §6).

The sliding window with its sinks and segment ids are taken by the split
pair and the fused kernel (JAX ``flash_bwd.py:145-151, 315-321, 566-572``):
each KV tile's dK/dV walk visits the Q tiles that see it, each Q tile's dQ
walk the KV tiles it sees (the sink tiles, then the window's), and the
fused kernel adds each Q tile's dQ contributions in the order of its own
visible KV tiles.  Such calls never take the triangular route, as in JAX.
The score transforms (the tanh softcap, ALiBi) are the split pair's only
(JAX ``flash_bwd.py:180-265, 496-508``): a transformed call takes it
whatever the autotuner's saved decision, and the fused kernel refuses one.
Under ALiBi the backward also returns ``d_slopes`` (fp32 ``[H]``): the
dK/dV kernel writes one partial per (batch, q-head, KV tile, warp), which
the wrapper sums (JAX reduces ``[B, H, n_kv_blocks, 128]`` partials the
same way, ``flash_bwd.py:1108-1161``); a partial per KV head would mix the
slopes of a GQA group.  Attention dropout is the split pair's too (JAX
``flash_bwd.py:222-245, 380-386, 496-508``): each kernel rebuilds the
forward's keep factors K from the seed on the device and each score's
(q-head, row, column) (``csrc/dropout.cuh``); dV takes (P o K)^T dO and
dS = P o (dP o K - delta), with the undropped P.  A dropout call takes the
split pair whatever the saved decision; the fused kernel refuses one.

Route: tensors on the CPU go to the plain versions; CUDA tensors launch the
kernels or raise.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from ..config import BlockSizes, SegmentIds, default_scale
from . import _build
from .flash_fwd import (
    _DTYPE_CODES,
    NO_DROPOUT_ARGS,
    Dropout,
    _check_cuda_inputs,
    _offsets,
    _ptr,
    check_dropout,
    check_segment_ids,
    check_xf,
    is_static_offset,
    plain_visible,
    row_positions,
    window_args,
    xf_exp,
    xf_parts,
)

# Stands in for lse = -inf (a row that sees no column) when P is rebuilt,
# as in the JAX kernels: exp(s - 1e30) is exactly 0, never inf or NaN.
LSE_SENTINEL = 1e30
# Rows of the fused kernel's KV tiles: each dQ partial that the kernel adds
# in KV-tile order covers this many KV rows.
DQ_TILE = 64
# Query rows per ordering counter of the fused kernel's dQ accumulator
# (csrc/dq_ordered.cuh, kRows).
DQ_COUNTER_ROWS = 32
# KV rows per d_slopes partial of the dK/dV kernel, and its warps, each of
# which writes its own partial (csrc/xf.cuh, kXfWarps).
DSLOPE_TILE, DSLOPE_WARPS = 64, 4


def bwd_delta(o: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 ``[B, H, N_q]`` ``rowsum(dO * O) - dlse``, shared by both kernels.

    The lse cotangent folds in here because d(lse_r)/d(s_rc) = P_rc.
    """
    delta = (o.float() * do.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _plain_p_ds(q, k, v, do, lse, delta, off, sm_scale, causal, window=None, sinks=0,
                segment_ids=None, softcap=None, alibi_slopes=None, dslope_abs=False,
                drop: Optional[Dropout] = None):
    """fp32 P (rebuilt from ``lse``) and dS over repeated KV heads, P zero
    outside ``flash_fwd.plain_visible``, and ``d_slopes`` (fp32 ``[H]``, or
    None without ALiBi).  Under the score transforms dS is the cotangent of
    the natural scaled score: ``d_slopes`` sums dS * (c - p) first, then dS
    takes the softcap's chain 1 - u^2.  ``dslope_abs``: sum |dS * (c - p)|
    in its place (``dslope_term_sizes``).  ``drop``: dropout, dS = P (dP K
    - delta) with K the keep factors, and the returned P is the dropped P K
    (dV's)."""
    _, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    u = None if not softcap else torch.tanh(s / softcap)
    lse_safe = torch.where(torch.isneginf(lse), LSE_SENTINEL, lse.float())
    if softcap or alibi_slopes is not None:
        t, bias = xf_parts(s, row_positions(n_q, off, 1, q.device), softcap, alibi_slopes)
        p = xf_exp(t, bias, lse_safe[..., None])
    else:
        p = torch.exp(s.sub_(lse_safe[..., None]))
    if causal or segment_ids is not None:
        visible = plain_visible(n_q, n_kv, off, causal=causal, window=window, sinks=sinks,
                                segment_ids=segment_ids, device=q.device)
        p = p.masked_fill_(~visible, 0.0)
    dp = torch.matmul(do.float(), vf.transpose(-1, -2))
    keep = None if drop is None else drop.keep(p.shape, q.device)
    if keep is not None:
        dp = dp.mul_(keep)
    ds = dp.sub_(delta[..., None]).mul_(p)
    d_slopes = None
    if alibi_slopes is not None:
        # A sum that cancels (dS sums to 0 over a row): taken in float64.
        dist = (torch.arange(n_kv, device=q.device) - row_positions(n_q, off, 1, q.device)).double()
        terms = ds.double() * dist
        d_slopes = (terms.abs_() if dslope_abs else terms).sum(dim=(0, 2, 3)).float()
    if u is not None:
        ds = ds.mul_(1.0 - u * u)
    if keep is not None:
        p = p.mul_(keep)
    return p, ds, kf, d_slopes


def _group_sum(x: torch.Tensor, h_kv: int) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.reshape(b, h_kv, h // h_kv, n, d).sum(dim=2)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, off, *, sm_scale: float, causal: bool,
                        window=None, sinks=0, segment_ids=None, softcap=None,
                        alibi_slopes=None, drop: Optional[Dropout] = None):
    """The dK/dV kernel's contract in fp32 PyTorch: ``(dk, dv)``, summed over
    each KV head's group of q-heads, and under ALiBi ``d_slopes`` too."""
    p, ds, _, d_slopes = _plain_p_ds(q, k, v, do, lse, delta, off, sm_scale, causal, window,
                                     sinks, segment_ids, softcap, alibi_slopes, drop=drop)
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), do.float()), k.shape[1])
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), q.float()), k.shape[1]) * sm_scale
    if d_slopes is not None:
        return dk.to(k.dtype), dv.to(v.dtype), d_slopes
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, off, *, sm_scale: float, causal: bool,
                       window=None, sinks=0, segment_ids=None, softcap=None,
                       alibi_slopes=None, drop: Optional[Dropout] = None):
    """The dQ kernel's contract in fp32 PyTorch."""
    _, ds, kf, _ = _plain_p_ds(q, k, v, do, lse, delta, off, sm_scale, causal, window, sinks,
                               segment_ids, softcap, alibi_slopes, drop=drop)
    return (torch.matmul(ds, kf) * sm_scale).to(q.dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    q_offset: torch.Tensor,
    dlse: Optional[torch.Tensor] = None,
    *,
    sm_scale: float,
    causal: bool,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    drop: Optional[Dropout] = None,
) -> tuple:
    """``flash_attention_bwd``'s contract in fp32 PyTorch (``q_offset``:
    int32 ``[B]``): the delta precompute and the two kernels' plain
    versions; ``(dq, dk, dv)``, and ``d_slopes`` last under ALiBi.
    ``drop``: a checked ``Dropout`` (``check_dropout``) or None."""
    delta = bwd_delta(o, do, dlse)
    kw = dict(sm_scale=sm_scale, causal=causal, window=window, sinks=sinks,
              segment_ids=segment_ids, softcap=softcap, alibi_slopes=alibi_slopes, drop=drop)
    dkv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_offset, **kw)
    return (flash_bwd_dq_plain(q, k, v, do, lse, delta, q_offset, **kw),) + tuple(dkv)


def dslope_term_sizes(q, k, v, o, do, lse, q_offset, dlse=None, *, sm_scale: float,
                      causal: bool, alibi_slopes: torch.Tensor, window=None, sinks=0,
                      segment_ids=None, softcap=None,
                      drop: Optional[Dropout] = None) -> torch.Tensor:
    """fp32 ``[H]``: each q-head's sum of |dS * (c - p)| over its pairs, the
    size of the terms whose sum (which cancels: dS sums to 0 over a row) is
    that head's ``d_slopes``; the scale a head's ``d_slopes`` error is read
    against.  Arguments as ``flash_attention_bwd_plain``'s."""
    delta = bwd_delta(o, do, dlse)
    return _plain_p_ds(q, k, v, do, lse, delta, q_offset, sm_scale, causal, window, sinks,
                       segment_ids, softcap, alibi_slopes, dslope_abs=True, drop=drop)[3]


def flash_attention_bwd_fused_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    q_offset: torch.Tensor,
    dlse: Optional[torch.Tensor] = None,
    *,
    sm_scale: float,
    causal: bool,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_attention_bwd_fused``'s contract in fp32 PyTorch: dK/dV as the
    split pair's, and dQ as one partial ``dS K`` per ``DQ_TILE`` KV rows,
    summed in KV order (the kernel's workspace slots), then scaled."""
    delta = bwd_delta(o, do, dlse)
    p, ds, kf, _ = _plain_p_ds(q, k, v, do, lse, delta, q_offset, sm_scale, causal, window, sinks,
                            segment_ids)
    h_kv = k.shape[1]
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), do.float()), h_kv)
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), q.float()), h_kv) * sm_scale
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[2], DQ_TILE):
        dq += torch.matmul(ds[..., start:start + DQ_TILE], kf[:, :, start:start + DQ_TILE])
    return (dq * sm_scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_offset_bound(q_offset, q_offset_max: Optional[int], n_q: int, n_kv: int,
                       causal: bool, window: bool = False) -> int:
    """The offset the fused kernel's workspace is sized for: a static
    ``q_offset`` (None or an int) itself, else ``q_offset_max``; ``n_kv -
    1`` (every pair visible) when not causal or when neither is known.
    The kernel reads each offset no higher than it.  Without a window an
    offset past ``n_kv - 1`` sees what ``n_kv - 1`` sees, so the bound is
    cut there; with one it moves the window, so it is not cut."""
    if not causal:
        return n_kv - 1
    if is_static_offset(q_offset):
        bound = n_kv - n_q if q_offset is None else int(q_offset)
    else:
        bound = n_kv - 1 if q_offset_max is None else int(q_offset_max)
    return bound if window else min(bound, n_kv - 1)


def dq_counter_count(batch: int, heads: int, n_q: int) -> int:
    """int32 counters of the fused kernel's dQ accumulator: the work
    items' ticket, then one per ``DQ_COUNTER_ROWS`` query rows of each
    (batch, q-head) (``csrc/dq_ordered.cuh``; the kernel refuses any other
    count)."""
    return 1 + batch * heads * -(-n_q // DQ_COUNTER_ROWS)


def dq_workspace_shape(batch: int, heads: int, n_q: int, head_dim: int) -> tuple:
    """The fused kernel's flat fp32 dQ workspace: the ``[B, H, N_q, D]``
    accumulator, then the ``dq_counter_count`` int32 counters in as many
    4-byte words.  It does not depend on the offsets or on ``n_kv``."""
    return (batch * heads * n_q * head_dim + dq_counter_count(batch, heads, n_q),)


def dq_workspace(q: torch.Tensor, workspace: Optional[torch.Tensor] = None) -> tuple:
    """``(workspace, args)``: the dQ workspace for ``q`` (fp32 of
    ``dq_workspace_shape``) and the arguments the fused and the triangular
    backward's C entries take for it (accumulator pointer, counters pointer,
    counter count).  ``workspace`` is allocated here when None (a caller's
    shows which accumulator elements a kernel wrote); its counters are
    zeroed here.  The caller holds it until the launch."""
    batch, heads, n_q, head_dim = q.shape
    shape = dq_workspace_shape(batch, heads, n_q, head_dim)
    if workspace is None:
        workspace = torch.empty(shape, dtype=torch.float32, device=q.device)
    elif (workspace.shape != shape or workspace.dtype != torch.float32
          or workspace.device != q.device or not workspace.is_contiguous()):
        raise ValueError(f"workspace must be a contiguous fp32 {shape} tensor on {q.device}")
    n_acc = batch * heads * n_q * head_dim
    workspace[n_acc:].zero_()  # the counters: int32 zero is fp32 +0.0's bits
    return workspace, (workspace.data_ptr(), workspace.data_ptr() + 4 * n_acc, shape[0] - n_acc)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the backward entry points' C signatures on a library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    common = [
        i32, i32, i32, i32, i32, i32,  # batch, heads, kv heads, n_q, n_kv, head_dim
        ctypes.c_float, i32, i32,  # sm_scale, causal, dtype
        ptr,  # stream
    ]
    # window, sinks, q segment ids, kv segment ids
    feats = [i32, i32, ptr, ptr]
    # softcap (0: none), ALiBi slopes (and dK/dV's d_slopes partials)
    xf = [ctypes.c_float, ptr]
    # q, k, v, dout, lse, delta, q_offset, then the outputs (and the fused
    # kernel's workspace).
    # dropout: packed seed (null: none), threshold, 1 / (1 - rate), heads
    drop = [ptr, i32, ctypes.c_float, i32]
    lib.fam_flash_bwd_dkv.argtypes = [ptr] * 9 + feats + xf + [ptr] + drop + common
    lib.fam_flash_bwd_dkv.restype = ctypes.c_int
    lib.fam_flash_bwd_dq.argtypes = [ptr] * 8 + feats + xf + drop + common
    lib.fam_flash_bwd_dq.restype = ctypes.c_int
    # ..., dq, dq_acc, counters, n_counters, off_bound
    lib.fam_flash_bwd_fused.argtypes = [ptr] * 12 + [i32, i32] + feats + common
    lib.fam_flash_bwd_fused.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load())


def _shape_args(q, k, sm_scale, causal):
    b, h, n_q, d = q.shape
    return (
        b, h, k.shape[1], n_q, k.shape[2], d, sm_scale, int(causal),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )


def _inputs(q, k, v, do, lse, delta, off):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), off.data_ptr())


def _feature_args(window: int, sinks: int, segment_ids: Optional[SegmentIds]) -> tuple:
    """``(window, sinks, q ids, kv ids)`` as the C entries take them
    (``flash_fwd.window_args``' ints; checked ids or None)."""
    if segment_ids is None:
        return window, sinks, None, None
    return window, sinks, segment_ids.q.data_ptr(), segment_ids.kv.data_ptr()


def dslope_partials(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """The dK/dV kernel's zeroed d_slopes partials: fp32 ``[B, H, ceil(n_kv
    / DSLOPE_TILE), DSLOPE_WARPS]``, one per (batch, q-head, KV tile, warp);
    ``d_slopes`` is their sum over all but the head axis."""
    return torch.zeros((q.shape[0], q.shape[1], -(-n_kv // DSLOPE_TILE), DSLOPE_WARPS),
                       dtype=torch.float32, device=q.device)


def _drop_args(drop: Optional[Dropout], q: torch.Tensor) -> tuple:
    return NO_DROPOUT_ARGS if drop is None else drop.c_args(q.shape[1])


def flash_bwd_dkv(q, k, v, do, lse, delta, off, *, sm_scale: float, causal: bool,
                  window: int = 0, sinks: int = 0, segment_ids: Optional[SegmentIds] = None,
                  softcap: float = 0.0, slopes: Optional[torch.Tensor] = None,
                  drop: Optional[Dropout] = None):
    """``(dk, dv)`` from the dK/dV kernel, and ``d_slopes`` (fp32 ``[H]``)
    last with ``slopes`` (CUDA tensors, checked by the caller; ``window``,
    ``sinks`` as ``flash_fwd.window_args`` gives them, ``softcap`` and
    ``slopes`` as ``flash_fwd.check_xf``, ``drop`` as
    ``flash_fwd.check_dropout``)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = None if slopes is None else dslope_partials(q, k.shape[2])
    err = _lib().fam_flash_bwd_dkv(
        *_inputs(q, k, v, do, lse, delta, off), dk.data_ptr(), dv.data_ptr(),
        *_feature_args(window, sinks, segment_ids), softcap, _ptr(slopes), _ptr(part),
        *_drop_args(drop, q), *_shape_args(q, k, sm_scale, causal),
    )
    if err:
        raise RuntimeError(f"flash_bwd dK/dV kernel launch failed: cudaError_t {err}")
    flash_bwd_dkv.launches += 1
    if part is not None:
        return dk, dv, part.double().sum(dim=(0, 2, 3)).float()
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, off, *, sm_scale: float, causal: bool,
                 window: int = 0, sinks: int = 0, segment_ids: Optional[SegmentIds] = None,
                 softcap: float = 0.0, slopes: Optional[torch.Tensor] = None,
                 drop: Optional[Dropout] = None):
    """``dq`` from the dQ kernel (CUDA tensors, checked by the caller)."""
    dq = torch.empty_like(q)
    err = _lib().fam_flash_bwd_dq(
        *_inputs(q, k, v, do, lse, delta, off), dq.data_ptr(),
        *_feature_args(window, sinks, segment_ids), softcap, _ptr(slopes),
        *_drop_args(drop, q), *_shape_args(q, k, sm_scale, causal),
    )
    if err:
        raise RuntimeError(f"flash_bwd dQ kernel launch failed: cudaError_t {err}")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_fused(q, k, v, do, lse, delta, off, *, sm_scale: float, causal: bool,
                    off_bound: int, workspace: Optional[torch.Tensor] = None,
                    window: int = 0, sinks: int = 0,
                    segment_ids: Optional[SegmentIds] = None):
    """``(dq, dk, dv)`` from the fused kernel, one launch (CUDA tensors,
    checked by the caller).  ``off_bound``: ``fused_offset_bound``.
    ``workspace``: see ``dq_workspace``."""
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    workspace, ws_args = dq_workspace(q, workspace)
    err = _lib().fam_flash_bwd_fused(
        *_inputs(q, k, v, do, lse, delta, off), dk.data_ptr(), dv.data_ptr(), dq.data_ptr(),
        *ws_args, off_bound, *_feature_args(window, sinks, segment_ids),
        *_shape_args(q, k, sm_scale, causal),
    )
    if err:
        raise RuntimeError(f"flash_bwd fused kernel launch failed: cudaError_t {err}")
    flash_bwd_fused.launches += 1
    return dq, dk, dv


# Launches of each CUDA kernel since import (the CPU route does not count).
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_fused.launches = 0


def _checked(q, k, v, o, do, lse, q_offset, sm_scale):
    """Shape checks shared by the backward entry points; returns the scale
    and the offsets as an int32 ``[B]`` tensor."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected [B, H, N, D] q, k, v; got {q.shape}, {k.shape}, {v.shape}")
    batch, heads, n_q, head_dim = q.shape
    if k.shape[0] != batch or k.shape[3] != head_dim or heads % k.shape[1]:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q shape {tuple(q.shape)}")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("o and do must be shaped like q, lse like q[..., 0]")
    off = _offsets(q_offset, batch, k.shape[2] - n_q, q.device)
    if off.shape != (batch,):
        raise ValueError(f"q_offset must be an int or a [{batch}] tensor")
    return default_scale(head_dim) if sm_scale is None else sm_scale, off


def _check_cuda(q, k, v, do, lse, off) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, off)
    _check_cuda_inputs(do, k, v, off)
    if do.dtype != q.dtype:
        raise TypeError("do must share q's dtype")
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("lse must be a contiguous fp32 tensor on q's device")


def _in_fp32(backward, q, k, v, o, do, lse, q_offset, dlse, **kw):
    """fp16 inputs, as JAX runs them (``flash_bwd.py:887-915``): the
    backward in fp32 on casts of q, k, v, o and dO, the gradients rounded
    back to fp16.  The CUDA kernels take bf16 and fp32 only."""
    grads = backward(q.float(), k.float(), v.float(), o.float(), do.float(), lse, q_offset,
                     dlse, **kw)
    # d_slopes, last under ALiBi, stays fp32 (as JAX keeps it).
    return tuple(g.half() for g in grads[:3]) + tuple(grads[3:])


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    q_offset: Union[None, int, torch.Tensor] = None,
    dlse: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_offsets=None,
    dropout_heads: Optional[int] = None,
    pos_div: int = 1,
) -> tuple:
    """``(dq, dk, dv)`` of flash attention over ``[B, H, N, D]`` inputs,
    and ``d_slopes`` (fp32 ``[H]``) last with ``alibi_slopes``, as the JAX
    wrapper returns it.

    ``o`` and ``lse`` (fp32 ``[B, H, N_q]``, natural log) are the forward's
    saved outputs, ``do`` the output's cotangent and ``dlse`` the optional
    lse cotangent.  ``k``/``v`` may have fewer heads than ``q`` (GQA); the
    masking rule (window, sinks and segment ids included), the score
    transforms (``softcap``, ``alibi_slopes``), dropout (the forward's
    ``dropout_*`` arguments: the same keep factors) and the ``q_offset``
    default (``n_kv - n_q``) are the forward's.  ``pos_div`` raises
    NotImplementedError if set.
    """
    if pos_div != 1:
        raise NotImplementedError(
            "pos_div (the GQA row-fold backward) is not ported: GQA is native "
            "in the port's kernels (see ROADMAP.md, Queue A item 5)"
        )
    feats = dict(window=window, sinks=sinks, segment_ids=segment_ids, softcap=softcap,
                 alibi_slopes=alibi_slopes, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                 dropout_offsets=dropout_offsets, dropout_heads=dropout_heads)
    if q.dtype == torch.float16:
        return _in_fp32(flash_attention_bwd, q, k, v, o, do, lse, q_offset, dlse,
                        sm_scale=sm_scale, causal=causal, **feats)
    sm_scale, off = _checked(q, k, v, o, do, lse, q_offset, sm_scale)
    w, n_sinks = window_args(window, sinks, causal)
    seg = check_segment_ids(segment_ids, q.shape[0], q.shape[2], k.shape[2], q.device)
    cap, slopes = check_xf(softcap, alibi_slopes, q.shape[1], q.device)
    drop = check_dropout(dropout_rate, dropout_seed, dropout_offsets, dropout_heads, q.device)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, o, do, lse, off, dlse, sm_scale=sm_scale, causal=causal,
            window=window if w else None, sinks=n_sinks, segment_ids=seg, softcap=softcap,
            alibi_slopes=slopes, drop=drop,
        )
    _check_cuda(q, k, v, do, lse, off)
    delta = bwd_delta(o, do, dlse)
    kw = dict(sm_scale=sm_scale, causal=causal, window=w, sinks=n_sinks, segment_ids=seg,
              softcap=cap, slopes=slopes, drop=drop)
    dkv = flash_bwd_dkv(q, k, v, do, lse, delta, off, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, off, **kw)
    return (dq,) + tuple(dkv)


def flash_attention_bwd_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    q_offset: Union[None, int, torch.Tensor] = None,
    dlse: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    q_offset_max: Optional[int] = None,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_offsets=None,
    dropout_heads: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the fused 5-matmul kernel; arguments and
    results as ``flash_attention_bwd`` (``dk``, ``dv`` in ``k``'s dtype, as
    the JAX kernel's; the window, sinks and segment ids included; a softcap,
    ALiBi slopes or dropout raise NotImplementedError, as JAX's fused
    kernel takes none of them).  The kernel's tiles are fixed (``DQ_TILE``).
    ``q_offset_max``: with a tensor ``q_offset``, an int no entry exceeds.
    An offset known on the host (None, an int or a CPU tensor) above it
    raises.  The entries of a CUDA tensor are not read on the host: the
    caller keeps to the contract, and an entry above ``q_offset_max`` is
    read as ``q_offset_max`` (a narrower mask).  fp16 inputs run in fp32
    and return fp16 gradients, as ``flash_attention_bwd``'s."""
    if softcap is not None or alibi_slopes is not None:
        raise NotImplementedError(
            "the fused backward takes no softcap or ALiBi slopes: JAX's fused kernel takes "
            "neither (flash_bwd.py:496-508); the split pair (flash_attention_bwd) takes both"
        )
    if dropout_rate:
        raise NotImplementedError(
            "the fused backward takes no dropout: JAX's dispatcher routes it to the split pair "
            "(flash_bwd.py:496-508, flash_attention_bwd)"
        )
    feats = dict(window=window, sinks=sinks, segment_ids=segment_ids)
    if q.dtype == torch.float16:
        return _in_fp32(flash_attention_bwd_fused, q, k, v, o, do, lse, q_offset, dlse,
                        sm_scale=sm_scale, causal=causal, q_offset_max=q_offset_max, **feats)
    host_max = host_offset_max(q_offset, q.shape[2], k.shape[2])
    if causal and q_offset_max is not None and host_max is not None and host_max > q_offset_max:
        raise ValueError(
            f"q_offset reaches {host_max}, above q_offset_max={q_offset_max}: the fused "
            "backward would compute a narrower mask's gradients"
        )
    sm_scale, off = _checked(q, k, v, o, do, lse, q_offset, sm_scale)
    w, n_sinks = window_args(window, sinks, causal)
    seg = check_segment_ids(segment_ids, q.shape[0], q.shape[2], k.shape[2], q.device)
    bound = fused_offset_bound(q_offset, q_offset_max, q.shape[2], k.shape[2], causal, w > 0)
    if q.device.type == "cpu":
        return flash_attention_bwd_fused_plain(
            q, k, v, o, do, lse, off.clamp(max=bound), dlse, sm_scale=sm_scale, causal=causal,
            window=window if w else None, sinks=n_sinks, segment_ids=seg,
        )
    _check_cuda(q, k, v, do, lse, off)
    return flash_bwd_fused(q, k, v, do, lse, bwd_delta(o, do, dlse), off,
                           sm_scale=sm_scale, causal=causal, off_bound=bound,
                           window=w, sinks=n_sinks, segment_ids=seg)


def host_offset_max(q_offset, n_q: int, n_kv: int) -> Optional[int]:
    """The largest offset when the host knows it without a device sync:
    None (``n_kv - n_q``), an int, or the max of a CPU tensor; None for a
    CUDA tensor."""
    if is_static_offset(q_offset):
        return n_kv - n_q if q_offset is None else int(q_offset)
    if q_offset.device.type == "cpu":
        return int(q_offset.max())
    return None


# The share of the card's free memory a fused backward's dQ workspace may
# take before the router declines a saved "fused" decision.
FUSED_WORKSPACE_SHARE = 0.5


def _free_device_bytes(device: torch.device) -> Optional[int]:
    """Free bytes on a CUDA device; None elsewhere (the CPU route has no
    workspace)."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


def fused_workspace_fits(q: torch.Tensor) -> bool:
    """Whether the fused kernel's dQ workspace for ``q``
    (``fused_workspace_bytes``) stays within ``FUSED_WORKSPACE_SHARE`` of
    the device's free bytes."""
    free = _free_device_bytes(q.device)
    if free is None:
        return True
    return fused_workspace_bytes(q) <= FUSED_WORKSPACE_SHARE * free


def fused_workspace_bytes(q: torch.Tensor) -> int:
    """Bytes of the fused kernel's dQ workspace for ``q`` (``[B, H, N_q,
    D]``; ``dq_workspace_shape``): the fp32 accumulator, one value per
    element of dQ, and the counters.  K, the offsets and the mask do not
    change it."""
    return 4 * dq_workspace_shape(*q.shape)[0]


# The route of a call with no saved decision (module docstring).
UNTUNED_BWD_ROUTE = "split"


def bwd_route(q: torch.Tensor, k: torch.Tensor, q_offset, *, causal: bool, pos_div: int = 1,
              block_sizes: Optional[BlockSizes] = None, featured: bool = False,
              transformed: bool = False) -> str:
    """The kernel(s) ``flash_attention_bwd_auto`` runs: ``"tri"``,
    ``"fused"`` or ``"split"`` (module docstring): a saved decision where it
    applies, else the untuned rule, the split pair.  A saved ``"fused"``
    decision is declined when its dQ workspace would not fit
    (``fused_workspace_fits``); a saved ``"tri"`` one where the triangular
    kernel does not apply.  ``featured`` (a window or segment
    ids) rules the triangular kernel out, as in JAX; ``transformed`` (a
    softcap, ALiBi or dropout) takes the split pair whatever the saved
    decision, as JAX's dispatcher does (``flash_bwd.py:496-508``)."""
    if transformed:
        return "split"
    tri_ok = (
        causal
        and not featured
        and k.shape[1] == q.shape[1]
        and q.dtype != torch.float16
        and is_static_offset(q_offset)
        and pos_div == 1
    )
    if block_sizes is not None or pos_div != 1:
        return "split"
    from ..harness.autotune import lookup_bwd

    hit = lookup_bwd(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                     causal, q.dtype, device=q.device)
    if hit is not None:
        impl = hit[0]
        if impl == "fused" and fused_workspace_fits(q):
            return "fused"
        if impl == "tri" and tri_ok:
            return "tri"
    return UNTUNED_BWD_ROUTE


def flash_attention_bwd_auto(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    q_offset: Union[None, int, torch.Tensor] = None,
    dlse: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    pos_div: int = 1,
    block_sizes: Optional[BlockSizes] = None,
    q_offset_max: Optional[int] = None,
    window: Optional[int] = None,
    sinks: int = 0,
    segment_ids: Optional[SegmentIds] = None,
    softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_offsets=None,
    dropout_heads: Optional[int] = None,
) -> tuple:
    """``(dq, dk, dv)``, routed to the triangular kernel, the fused kernel
    or the split pair (module docstring), and ``d_slopes`` last under ALiBi
    (the split pair's); dropout takes the split pair.  Arguments as
    ``flash_attention_bwd``;
    ``q_offset_max`` as ``flash_attention_bwd_fused`` (only the fused route
    reads it).  The triangular route returns ``dk`` and ``dv`` in fp32, the
    others in ``k``'s dtype, as in JAX.  The split pair's tiles are fixed:
    ``block_sizes`` only skips the tuned lookup."""
    feats = dict(window=window, sinks=sinks, segment_ids=segment_ids)
    featured = window is not None or segment_ids is not None
    transformed = softcap is not None or alibi_slopes is not None or bool(dropout_rate)
    impl = bwd_route(q, k, q_offset, causal=causal, pos_div=pos_div, block_sizes=block_sizes,
                     featured=featured, transformed=transformed)
    if impl == "tri":
        from .flash_tri import flash_attention_bwd_tri

        return flash_attention_bwd_tri(
            q, k, v, o, do, lse, dlse, sm_scale=sm_scale, q_offset=q_offset
        )
    if impl == "fused":
        return flash_attention_bwd_fused(
            q, k, v, o, do, lse, q_offset, dlse, sm_scale=sm_scale, causal=causal,
            q_offset_max=q_offset_max, **feats,
        )
    return flash_attention_bwd(
        q, k, v, o, do, lse, q_offset, dlse, sm_scale=sm_scale, causal=causal,
        pos_div=pos_div, softcap=softcap, alibi_slopes=alibi_slopes, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, dropout_offsets=dropout_offsets, dropout_heads=dropout_heads,
        **feats,
    )
