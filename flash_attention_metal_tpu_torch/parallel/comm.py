"""Collectives over a mesh's axes, and their differentiable forms.

The counterparts of the XLA collectives the JAX package calls inside
``shard_map`` (``psum``, ``pmax``, ``all_gather``, ``psum_scatter``,
``all_to_all``, ``ppermute``), written once against ``torch.distributed``
process groups (``parallel/mesh.py``).  Under ``"gloo"`` a CUDA tensor is
copied to a host buffer before the operation and back after it, for every
operation (gloo's CUDA support differs by operation and by version); under
``"nccl"`` the same code passes the tensor as it is.  A group of one rank
runs no collective.

The differentiable forms are ``torch.autograd.Function``s whose backward is
the transpose the training step needs, so that a sharded gradient equals
the single-device one (the tensor-parallel pair of Megatron-LM):

* ``reduce_from``: sum over the axes forward, identity backward, where
  every rank goes on with the same (replicated) value;
* ``copy_to``: identity forward, sum of the ranks' cotangents backward,
  where a replicated value enters a sharded computation;
* ``gather_from``: all-gather forward, reduce-scatter backward (in fp32);
* ``all_to_all_diff``: all-to-all forward, the inverse all-to-all backward.
"""

from __future__ import annotations

import warnings
from typing import List, Sequence, Union

import torch
import torch.distributed as dist

from .mesh import Mesh

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _staged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A contiguous buffer of ``x`` the backend takes: a host copy of a
    CUDA tensor under gloo, else ``x`` itself (contiguous)."""
    if mesh.backend == "gloo" and x.is_cuda:
        return x.detach().to("cpu").contiguous()
    return x.detach().contiguous()


def _quiet(fn, *args, **kwargs):
    """Call a collective whose name torch 2.13 marks deprecated
    (``all_gather_into_tensor``, ``reduce_scatter_tensor``; the card's
    torch 2.11 has no other name for them) without its warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Sequence[str], op: str = "sum") -> torch.Tensor:
    """``op`` (``"sum"`` or ``"max"``) of ``x`` over the ranks of ``axes``:
    a new tensor on ``x``'s device (``x`` itself over one rank)."""
    axes = tuple(axes)
    if mesh.size(*axes) == 1:
        return x
    buf = _staged(x, mesh)
    buf = buf.clone() if buf.data_ptr() == x.data_ptr() else buf
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group(*axes))
    return buf.to(x.device)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: Union[str, Sequence[str]],
               dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` (a name, or several: row-major over
    them in the mesh's order) concatenated on ``dim``, in coordinate order
    (JAX ``all_gather(..., tiled=True)``)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = mesh.size(*axes)
    if n == 1:
        return x
    buf = _staged(x.movedim(dim, 0), mesh)
    out = torch.empty((n * buf.shape[0], *buf.shape[1:]), dtype=buf.dtype, device=buf.device)
    _quiet(dist.all_gather_into_tensor, out, buf, group=mesh.group(*axes))
    return out.to(x.device).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``axis`` of ``x``, cut in equal blocks on
    ``dim``: this rank's block (JAX ``psum_scatter(..., tiled=True)``)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    buf = _staged(x.movedim(dim, 0), mesh)
    if buf.shape[0] % n:
        raise ValueError(f"dim of {buf.shape[0]} does not split over {n} ranks")
    out = torch.empty((buf.shape[0] // n, *buf.shape[1:]), dtype=buf.dtype, device=buf.device)
    _quiet(dist.reduce_scatter_tensor, out, buf, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return out.to(x.device).movedim(0, dim)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Block ``j`` of ``x`` on ``split_dim`` goes to rank ``j`` of ``axis``;
    the blocks received are concatenated on ``concat_dim`` in the senders'
    order (JAX ``all_to_all(..., tiled=True)``)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim of {x.shape[split_dim]} does not split over {n} ranks")
    send = _staged(torch.stack(x.chunk(n, split_dim), 0), mesh)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group(axis))
    return torch.cat(recv.to(x.device).unbind(0), dim=concat_dim)


class Pending:
    """Tensors on their way from a ring neighbour (``shift``): ``wait()``
    returns them, on the senders' devices."""

    def __init__(self, reqs, bufs: List[torch.Tensor], like: List[torch.Tensor], keep):
        self._reqs, self._bufs, self._like, self._keep = reqs, bufs, like, keep

    def wait(self) -> List[torch.Tensor]:
        for r in self._reqs:
            r.wait()
        self._keep = None
        return [b.to(t.device) for b, t in zip(self._bufs, self._like)]


def shift(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str, step: int = 1) -> Pending:
    """Post the transfer of ``tensors`` to the rank ``step`` places further
    along ``axis`` (a ring), and of the tensors of the rank ``step`` places
    back to this one, without waiting (JAX ``ppermute``); ``.wait()`` on
    the result gives the tensors received.  Every rank of the axis must
    call it, in the same order as its other collectives."""
    tensors = list(tensors)
    if mesh.size(axis) == 1:
        return Pending([], tensors, tensors, None)
    dst, src = mesh.peer(axis, step), mesh.peer(axis, -step)
    group = mesh.group(axis)
    sends = [_staged(t, mesh) for t in tensors]
    bufs = [torch.empty_like(s) for s in sends]
    ops = [dist.P2POp(dist.isend, s, dst, group) for s in sends]
    ops += [dist.P2POp(dist.irecv, b, src, group) for b in bufs]
    return Pending(dist.batch_isend_irecv(ops), bufs, tensors, sends)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # The ranks' partials summed in fp32 (a bf16 sum of eight rounds
        # each term).
        return (reduce_scatter(g.float(), ctx.mesh, ctx.axis, ctx.dim).to(g.dtype), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), *ctx.args), None, None, None, None


def reduce_from(x: torch.Tensor, mesh: Mesh, *axes: str) -> torch.Tensor:
    """Differentiable sum over ``axes`` whose result every rank uses alike:
    the backward passes the cotangent through."""
    if mesh.size(*axes) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axes)


def copy_to(x: torch.Tensor, mesh: Mesh, *axes: str) -> torch.Tensor:
    """Identity whose backward sums the ranks' cotangents over ``axes``:
    where a value replicated over ``axes`` feeds a computation sharded over
    them."""
    if mesh.size(*axes) == 1:
        return x
    return _CopyTo.apply(x, mesh, axes)


def gather_from(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """Differentiable ``all_gather``: the backward reduce-scatters."""
    if mesh.size(axis) == 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim)


def all_to_all_diff(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """Differentiable ``all_to_all``: the backward is the inverse one."""
    if mesh.size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)
