"""FlashAttention V1 (the ladder's rung 2): the two CUDA kernels' wrappers,
their plain version and the route between them.

Counterpart of ``flash_attention_metal_tpu/kernels/flash_v1.py``: tiled
fp32 attention with an online softmax, one KV tile per step, and its folded
variant, which takes a whole short KV row in one pass for several batch
elements at once.  ``csrc/flash_v1.cu`` computes both
(``fam_flash_v1``, ``fam_flash_v1_folded``) in IEEE fp32 on the CUDA cores,
never on the tensor cores: fp32 products there are TF32.

The route is the JAX function's (``flash_v1.py:224-256``): the per-N tile
table ``_V1_BLOCKS`` (512 x 512 elsewhere) sets the logical tiles; when one
KV tile covers the row, one Q tile covers the queries and ``_lean_batch_fold``
packs more than one batch element per step, the folded kernel runs, else
the streaming one.  The v5e table and the 128-lane scratch are Mosaic
facts, so ``block_q`` and ``block_k`` decide only the route and the
divisibility check, as in JAX.  The CUDA kernels walk K and V in 64-row
tiles, and ``v1_tile_rows`` picks their Q tile's height (64, 32 or 16
rows, a warp per 8) from the grid and the shared memory: the folded
kernel's grid covers every (batch element, head, Q tile), so JAX's fold
of batch elements per step only selects the route.

Route: tensors on the CPU go to the plain version; CUDA tensors launch a
kernel or raise.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..config import default_scale
from . import _build
from .flash_fwd import _DTYPE_CODES, _check_cuda_inputs

# The JAX function's per-N (block_q, block_k) defaults (raced on v5e;
# flash_v1.py:187-192): they decide the route only.
_V1_BLOCKS = {1024: (512, 512), 2048: (1024, 1024), 4096: (512, 2048), 8192: (1024, 2048)}
_V1_DEFAULT_BLOCKS = (512, 512)
# KV rows per folded step (flash_fwd.py:523): fold while fold * 2 * N fits.
_FOLD_ROWS = 1024
# The longest row the folded kernel scores in shared memory
# (csrc/flash_v1.cu, kFoldedMaxKv); the route never sends it more.
FOLDED_MAX_KV = 512
# Shared memory a block may take (227 KB, csrc/flash_v1.cu's kMaxSmem), and
# so that two fit on an H100 SM: 228 KB per SM, 1 KB reserved per block.
BLOCK_SMEM_MAX = 232448
_TWO_BLOCKS_SMEM = 233472 // 2 - 1024
# The streaming kernel takes 32-row Q tiles when 64-row ones would give at
# most one block per SM of the H100 (132): measured faster there at every
# sweep point, level at 256 blocks (``harness/onchip.py v1_tiles``).
_STREAM_SMALL_GRID = 132


def _lean_batch_fold(batch: int, n_q: int, n_kv: int) -> int:
    """Batch elements per folded step: the largest power of two dividing
    ``batch`` with ``fold * max(n_q, n_kv) <= _FOLD_ROWS`` (the JAX
    package's ``flash_fwd._lean_batch_fold``)."""
    fold = 1
    while batch % (fold * 2) == 0 and fold * 2 * max(n_q, n_kv) <= _FOLD_ROWS:
        fold *= 2
    return fold


def v1_blocks(n_q: int, n_kv: int, block_q: Optional[int] = None,
              block_k: Optional[int] = None) -> tuple:
    """The JAX function's ``(block_q, block_k)`` for these lengths: the
    table's defaults for the unset ones, clipped to the lengths; raises the
    JAX errors for indivisible lengths."""
    dq, dk = _V1_BLOCKS.get(max(n_q, n_kv), _V1_DEFAULT_BLOCKS)
    block_q = min(dq if block_q is None else block_q, n_q)
    block_k = min(dk if block_k is None else block_k, n_kv)
    if n_q % block_q or n_kv % block_k:
        raise ValueError(
            f"sequence lengths ({n_q}, {n_kv}) must be divisible by blocks "
            f"({block_q}, {block_k})"
        )
    return block_q, block_k


def v1_route(batch: int, n_q: int, n_kv: int, block_q: Optional[int] = None,
             block_k: Optional[int] = None) -> tuple:
    """``("folded", fold)`` or ``("stream", 1)``: the kernel the JAX
    function's branch takes for this shape."""
    block_q, block_k = v1_blocks(n_q, n_kv, block_q, block_k)
    if n_kv // block_k == 1 and block_q == n_q:
        fold = _lean_batch_fold(batch, n_q, n_kv)
        if fold > 1:
            return "folded", fold
    return "stream", 1


def v1_smem_bytes(route: str, rows: int, n_kv: int, head_dim: int) -> int:
    """Shared memory of one block of the ``route`` kernel with ``rows``-row
    Q tiles (``csrc/flash_v1.cu``'s ``smem_bytes``): the fp32 Q tile and two
    64-row K/V tiles at pitch ``head_dim + 4``, and the folded kernel's
    score rows (pitch ``64 ceil(n_kv / 64) + 16``) or the streaming one's
    32-column P half tile (pitch 48)."""
    pitch = head_dim + 4
    tail = -(-n_kv // 64) * 64 + 16 if route == "folded" else 48
    return 4 * (rows * pitch + 2 * 64 * pitch + rows * tail)


def v1_tile_rows(route: str, batch: int, heads: int, n_q: int, n_kv: int,
                 head_dim: int) -> int:
    """Query rows per block of the CUDA kernel ``route`` takes.

    Folded: the tallest of 64, 32 and 16 rows whose block leaves room for
    two on an SM (its score rows grow with ``n_kv``).  Streaming: 64 rows,
    or 32 when 64-row tiles would give at most ``_STREAM_SMALL_GRID`` blocks
    (one an SM or fewer): twice the blocks, each re-reading K and V."""
    if route == "folded":
        for rows in (64, 32, 16):
            if v1_smem_bytes(route, rows, n_kv, head_dim) <= _TWO_BLOCKS_SMEM:
                return rows
        raise ValueError(f"no folded Q tile fits n_kv {n_kv} at head dim {head_dim}")
    return 32 if batch * heads * -(-n_q // 64) <= _STREAM_SMALL_GRID else 64


def flash_attention_v1_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: float, causal: bool
) -> torch.Tensor:
    """Both kernels' contract in fp32 PyTorch: exact softmax attention over
    the whole row (causal: ``c <= r``), a zero row sum divided by 1."""
    n_q, n_kv = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    visible = torch.ones((n_q, n_kv), dtype=torch.bool, device=q.device)
    if causal:
        visible = torch.arange(n_kv, device=q.device)[None, :] <= torch.arange(
            n_q, device=q.device)[:, None]
    s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.to(q.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the two V1 entry points' C signatures on a loaded library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fam_flash_v1, lib.fam_flash_v1_folded):
        fn.argtypes = [
            ptr, ptr, ptr, ptr,  # q, k, v, o
            i32, i32, i32, i32, i32, i32,  # batch, heads, n_q, n_kv, head_dim, rows
            ctypes.c_float, i32, i32,  # sm_scale, causal, dtype
            ptr,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load())


def _stream_args(q):
    return _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream


def flash_v1_stream(q, k, v, *, sm_scale: float, causal: bool,
                    rows: Optional[int] = None) -> torch.Tensor:
    """``o`` from the streaming kernel (CUDA tensors, checked by the caller),
    ``rows`` query rows per block (``v1_tile_rows`` unless given)."""
    batch, heads, n_q, head_dim = q.shape
    if rows is None:
        rows = v1_tile_rows("stream", batch, heads, n_q, k.shape[2], head_dim)
    o = torch.empty_like(q)
    err = _lib().fam_flash_v1(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        batch, heads, n_q, k.shape[2], head_dim, rows, sm_scale, int(causal),
        *_stream_args(q),
    )
    if err:
        raise RuntimeError(f"flash_v1 streaming kernel launch failed: cudaError_t {err}")
    flash_v1_stream.launches += 1
    return o


def flash_v1_folded(q, k, v, fold: int, *, sm_scale: float, causal: bool,
                    rows: Optional[int] = None) -> torch.Tensor:
    """``o`` from the folded kernel (CUDA tensors, checked by the caller;
    ``n_kv <= FOLDED_MAX_KV``), ``rows`` query rows per block
    (``v1_tile_rows`` unless given).  ``fold``, the JAX route's batch
    elements per step, must divide the batch; the grid covers every batch
    element on its own."""
    batch, heads, n_q, head_dim = q.shape
    n_kv = k.shape[2]
    if n_kv > FOLDED_MAX_KV or batch % fold:
        raise ValueError(f"the folded kernel takes n_kv <= {FOLDED_MAX_KV} and a fold "
                         f"dividing the batch; got n_kv {n_kv}, fold {fold}, batch {batch}")
    if rows is None:
        rows = v1_tile_rows("folded", batch, heads, n_q, n_kv, head_dim)
    o = torch.empty_like(q)
    err = _lib().fam_flash_v1_folded(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        batch, heads, n_q, n_kv, head_dim, rows, sm_scale, int(causal), *_stream_args(q),
    )
    if err:
        raise RuntimeError(f"flash_v1 folded kernel launch failed: cudaError_t {err}")
    flash_v1_folded.launches += 1
    return o


# Launches of each CUDA kernel since import (the CPU route does not count).
flash_v1_stream.launches = 0
flash_v1_folded.launches = 0


def flash_attention_v1(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Tiled fp32 flash attention over ``[B, H, N, D]`` inputs with equal
    head counts; ``o`` in ``q``'s dtype.

    ``causal`` requires ``n_q == n_kv`` (row ``r`` sees ``c <= r``), as in
    JAX.  ``block_q``/``block_k`` are the JAX function's logical tiles: they
    pick the route (module docstring) and must divide the lengths.
    """
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"expected [B, H, N, D] q, k, v with equal heads; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    batch, _, n_q, head_dim = q.shape
    n_kv = k.shape[2]
    if sm_scale is None:
        sm_scale = default_scale(head_dim)
    if causal and n_q != n_kv:
        raise ValueError(
            "flash_attention_v1 causal requires n_q == n_kv (this simple "
            "rung has no diagonal offset; use flash_attention_mxu)"
        )
    route, fold = v1_route(batch, n_q, n_kv, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_v1_plain(q, k, v, sm_scale=sm_scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v)
    if route == "folded":
        return flash_v1_folded(q, k, v, fold, sm_scale=sm_scale, causal=causal)
    return flash_v1_stream(q, k, v, sm_scale=sm_scale, causal=causal)
