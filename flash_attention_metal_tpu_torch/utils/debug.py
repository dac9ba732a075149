"""Numerics sanitizer: silent NaN/Inf propagation raises instead.

Counterpart of ``flash_attention_metal_tpu/utils/debug.py``.  JAX's
``checkify`` instruments every float op of a jitted function; PyTorch runs
eagerly, so ``checked`` tests the function's outputs once it returns, and
``assert_all_finite`` tests any tree of tensors (a harness's or a test's
check after a kernel).  Both read the values back to the host, so they
belong at a boundary, not inside a timed loop.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch


def _leaves(tree: Any, path: str = ""):
    """``(path, tensor)`` of every tensor of nested dicts, lists and tuples."""
    if torch.is_tensor(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{path}[{i}]")


def assert_all_finite(tree: Any, name: str = "value") -> None:
    """Raise ``FloatingPointError`` if a floating tensor of ``tree`` holds a
    NaN or an Inf, naming its path, shape and dtype."""
    for path, leaf in _leaves(tree):
        if not leaf.is_floating_point():
            continue
        if not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(
                f"non-finite values in {name}{path} "
                f"(shape {tuple(leaf.shape)}, dtype {leaf.dtype})"
            )


def checked(fn: Callable, *, name: str = "") -> Callable:
    """``fn`` whose outputs raise ``FloatingPointError`` when any of them
    holds a NaN or an Inf, in place of propagating it::

        safe = checked(lambda q, k, v: flash_attention(q, k, v, impl="reference"))
        out = safe(q, k, v)
    """
    label = name or getattr(fn, "__name__", "output")

    @functools.wraps(fn)
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_all_finite(out, label)
        return out

    return run
