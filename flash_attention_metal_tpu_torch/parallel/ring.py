"""Ring (sequence-parallel) flash attention over a mesh axis.

Counterpart of ``flash_attention_metal_tpu/parallel/ring.py``.  Each rank
holds one contiguous shard of the sequence, Q and K/V alike; the K/V
shards travel around the ring (``comm.shift``, point to point), and each
step's partial attention, the local forward kernel's ``(o, lse)``, is
folded into the running pair by ``merge_partials``.  The next shard's
transfer is posted before the step's kernel, as the JAX ring issues its
``ppermute`` first, so the copy overlaps the compute.

Causal masking is one offset per step: on step ``s`` rank ``i`` sees the
shard of rank ``src = (i - s) mod n``, and its local row ``r`` sees local
column ``c`` when ``c <= r + (i - src) * n_loc``:

* ``src < i``: offset >= n_loc, every pair visible;
* ``src == i``: offset 0, the diagonal;
* ``src > i``: offset <= -n_loc, nothing visible: o = 0 and lse = -inf,
  which the merge treats as an empty partial.

The offsets are host ints, so a plain causal step takes the forward
router's triangular kernel (``kernels/flash_fwd.py::fwd_route``), which
clamps the offset to ``[-n_q, n_kv - 1]``: a fully masked step visits no
tile.  Under dropout the step takes the general kernel, whose mask is
hashed at the score's global coordinates (rows offset by this rank's
shard, columns by the visiting shard's; ``pack_dropout_seed``), so the
sharded result equals the single-device one exactly.  Every rank issues
the same transfers in the same order, masked steps included.

The backward (``ring_flash_attention_diff``) is JAX's reverse ring: the
K/V shards go around once more with their fp32 dK/dV accumulators, each
step adding the split backward pair's partial for (local Q x visiting K/V)
with the merged ``o`` and ``lse``, and after ``n`` moves every accumulator
is home.  GQA stays native: the split pair sums each group's dK/dV in fp32
in the kernel, where JAX repeats K/V to the q-head count
(``ring.py:277-292``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..config import default_scale
from ..kernels._common import pack_dropout_seed
from ..kernels.flash_bwd import flash_attention_bwd
from ..kernels.flash_fwd import flash_attention_fwd
from ..reference.oracle import attention_reference_with_lse
from .comm import shift
from .mesh import Mesh, shard


def merge_partials(
    o_a: torch.Tensor,
    lse_a: torch.Tensor,
    o_b: torch.Tensor,
    lse_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine two normalised attention partials by their logsumexps.

    ``o_*``: fp32 ``[..., N, D]`` partial outputs; ``lse_*``: fp32
    ``[..., N, 1]`` (``-inf``: an empty partial).  Returns the merged
    ``(o, lse)``; two empty partials give ``o = 0``, ``lse = -inf``."""
    m = torch.maximum(lse_a, lse_b)
    # exp(-inf - -inf) would be NaN: pivot empty pairs at 0.
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w_a = torch.where(torch.isneginf(lse_a), torch.zeros_like(lse_a), torch.exp(lse_a - m_safe))
    w_b = torch.where(torch.isneginf(lse_b), torch.zeros_like(lse_b), torch.exp(lse_b - m_safe))
    denom = w_a + w_b
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (o_a * w_a + o_b * w_b) / denom_safe
    lse = torch.where(denom == 0.0, torch.full_like(denom, float("-inf")),
                      m_safe + torch.log(denom_safe))
    return o, lse


def _step_drop(rate: float, sv: Optional[torch.Tensor], heads: Optional[int], my: int, src: int,
               n_loc: int) -> dict:
    """A ring step's dropout arguments: the packed seed with this rank's
    row origin and the visiting shard's column origin added."""
    if not rate:
        return {}
    delta = torch.tensor([0, my * n_loc, src * n_loc, 0, 0], dtype=torch.int32, device=sv.device)
    return dict(dropout_rate=rate, dropout_seed=sv + delta, dropout_heads=heads)


def _step_offset(my: int, src: int, n_loc: int) -> int:
    """The causal offset of rank ``my``'s rows over the shard of ``src``."""
    return (my - src) * n_loc


def _pass_on(dk: torch.Tensor, dv: torch.Tensor, mesh: Mesh, axis: str):
    """The backward's dK/dV accumulators moved one place along the ring,
    with the shard they belong to."""
    return shift([dk, dv], mesh, axis).wait()


def _check(q: torch.Tensor, k: torch.Tensor) -> int:
    n_loc = q.shape[2]
    if k.shape[2] != n_loc:
        raise ValueError("ring attention expects equal q/kv shard lengths")
    return n_loc


def _ring_forward(q, k, v, mesh, axis, causal, sm_scale, impl, rate, sv, heads):
    """``(o fp32, lse fp32 [B, H, N, 1])`` of the forward ring."""
    n, my = mesh.size(axis), mesh.index(axis)
    n_loc = _check(q, k)
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_acc = torch.full((*q.shape[:3], 1), float("-inf"), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for step in range(n):
        nxt = shift([kb, vb], mesh, axis) if step < n - 1 else None
        src = (my - step) % n
        offset = _step_offset(my, src, n_loc)
        if impl == "reference":
            o_i, lse_i = attention_reference_with_lse(q, kb, vb, causal=causal, sm_scale=sm_scale,
                                                      q_offset=offset)
        else:
            o_i, lse_i = flash_attention_fwd(q, kb, vb, offset, causal=causal, sm_scale=sm_scale,
                                             save_lse=True,
                                             **_step_drop(rate, sv, heads, my, src, n_loc))
        o_acc, lse_acc = merge_partials(o_acc, lse_acc, o_i.float(), lse_i[..., None].float())
        if nxt is not None:
            kb, vb = nxt.wait()
    return o_acc, lse_acc


def _packed(rate: float, seed, device) -> Optional[torch.Tensor]:
    if not rate:
        return None
    if seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    return pack_dropout_seed(seed).to(device=device, dtype=torch.int32)


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "sp",
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    save_lse: bool = False,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_heads: Optional[int] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Ring attention over this rank's ``[B, H, n_loc, D]`` shards (the
    sequence split over ``axis``, equal Q and K/V shard lengths); returns
    the local output shard, and the local lse ``[B, H, n_loc]`` with
    ``save_lse``.  Forward only (``ring_flash_attention_diff`` carries the
    gradient).

    ``impl``: ``"auto"`` runs the forward router's kernels (their plain
    versions for CPU tensors), ``"reference"`` the fp32 oracle (JAX's
    ``impl="xla"``; it takes no dropout).  ``dropout_*``: attention dropout
    at global mask coordinates; ``dropout_seed`` may be packed with the
    caller's batch and head offsets (``pack_dropout_seed``), to which the
    ring adds its row and column origins."""
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if dropout_rate and impl == "reference":
        raise NotImplementedError("ring dropout runs the kernels (impl='auto')")
    sm_scale = default_scale(q.shape[-1]) if sm_scale is None else sm_scale
    sv = _packed(dropout_rate, dropout_seed, q.device)
    o, lse = _ring_forward(q, k, v, mesh, axis, causal, sm_scale, impl, dropout_rate, sv,
                           dropout_heads)
    o = o.to(q.dtype)
    return (o, lse[..., 0]) if save_lse else o


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sv, mesh, axis, causal, sm_scale, rate, heads):
        o, lse = _ring_forward(q, k, v, mesh, axis, causal, sm_scale, "auto", rate, sv, heads)
        o = o.to(q.dtype)
        lse = lse[..., 0].contiguous()
        ctx.save_for_backward(q, k, v, o, lse, sv)
        ctx.args = (mesh, axis, causal, sm_scale, rate, heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, sv = ctx.saved_tensors
        mesh, axis, causal, sm_scale, rate, heads = ctx.args
        n, my = mesh.size(axis), mesh.index(axis)
        n_loc = q.shape[2]
        do = do.contiguous().to(q.dtype)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kb, vb = k, v
        for step in range(n):
            nxt = shift([kb, vb], mesh, axis) if step < n - 1 else None
            src = (my - step) % n
            dq_i, dk_i, dv_i = flash_attention_bwd(
                q, kb, vb, o, do, lse, _step_offset(my, src, n_loc), sm_scale=sm_scale,
                causal=causal, **_step_drop(rate, sv, heads, my, src, n_loc))
            dq += dq_i.float()
            dkb += dk_i.float()
            dvb += dv_i.float()
            # The accumulators travel with their shard: after n moves each
            # is home.
            dkb, dvb = _pass_on(dkb, dvb, mesh, axis)
            if nxt is not None:
                kb, vb = nxt.wait()
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None, None, None, None, None,
                None, None)


def ring_flash_attention_diff(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "sp",
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_heads: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable ring attention (``ring_flash_attention``'s forward,
    JAX's reverse-ring backward: module docstring).  Returns the local
    output shard in ``q``'s dtype; the gradients of ``q``, ``k``, ``v`` are
    this rank's shards of the global ones.  The forward and the backward
    rebuild the same dropout mask from the seed and the global
    coordinates."""
    sm_scale = default_scale(q.shape[-1]) if sm_scale is None else sm_scale
    sv = _packed(dropout_rate, dropout_seed, q.device)
    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), sv, mesh, axis,
                                causal, sm_scale, float(dropout_rate), dropout_heads)


def make_ring_attention(
    mesh: Mesh,
    axis: str = "sp",
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
    differentiable: bool = False,
    dropout_rate: float = 0.0,
):
    """``ring(q, k, v[, seed])`` of global ``[B, H, N, D]`` tensors: each
    rank takes its sequence shard on ``axis`` and returns its output shard
    (the JAX function's ``shard_map`` with the sequence split on
    ``axis``).  With ``differentiable`` the shard carries the reverse-ring
    backward, and the global inputs' gradients hold this rank's part; with
    ``dropout_rate`` the seed is the fourth argument."""
    spec = (None, None, axis, None)

    def ring(q, k, v, seed=None):
        q, k, v = (shard(x, mesh, spec) for x in (q, k, v))
        if differentiable:
            return ring_flash_attention_diff(q, k, v, mesh, axis, causal=causal,
                                             sm_scale=sm_scale, dropout_rate=dropout_rate,
                                             dropout_seed=seed)
        return ring_flash_attention(q, k, v, mesh, axis, causal=causal, sm_scale=sm_scale,
                                    impl=impl, dropout_rate=dropout_rate, dropout_seed=seed)

    return ring

