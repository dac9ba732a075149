"""Checkpoint / resume of nested dicts and lists of tensors.

Counterpart of ``flash_attention_metal_tpu/utils/checkpoint.py`` (Orbax).
``torch.save`` writes the tensors' bytes as they are, so a restored
training state is bit-identical to the saved one and a resumed run repeats
the uninterrupted one exactly.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save_pytree(path: str, tree: Any) -> None:
    """Save ``tree`` (dicts, lists, tensors, ints, floats) to the file
    ``path``.  The file is written under another name and renamed, so a
    reader never sees half of it."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_pytree(path: str, map_location=None) -> Any:
    """The tree saved by ``save_pytree`` (tensors on their saved devices
    unless ``map_location`` says otherwise).  Loads tensors and plain
    containers only, never arbitrary pickled objects."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
