"""Distribution layer on ``torch.distributed``: meshes of ranks, their
collectives, and ring, all-gather, lse-combine and Ulysses attention
(counterpart of ``flash_attention_metal_tpu/parallel``)."""

from .context import allgather_attention, lse_combine_attention, lse_psum_combine
from .mesh import (
    AXIS_DATA,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
    Mesh,
    Sharding,
    attention_shardings,
    init_group,
    make_mesh,
    shard,
    spawn,
    unshard,
)
from .ring import (
    make_ring_attention,
    merge_partials,
    ring_flash_attention,
    ring_flash_attention_diff,
)
from .ulysses import ulysses_attention

__all__ = [
    "AXIS_DATA",
    "AXIS_SEQUENCE",
    "AXIS_TENSOR",
    "Mesh",
    "Sharding",
    "allgather_attention",
    "attention_shardings",
    "init_group",
    "lse_combine_attention",
    "lse_psum_combine",
    "make_mesh",
    "make_ring_attention",
    "merge_partials",
    "ring_flash_attention",
    "ring_flash_attention_diff",
    "shard",
    "spawn",
    "ulysses_attention",
    "unshard",
]
