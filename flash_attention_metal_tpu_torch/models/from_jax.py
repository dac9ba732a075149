"""Load the JAX package's FlashLM parameters (dense or MoE) into the port.

The caller turns the JAX pytree into numpy arrays first (for example with
``jax.tree_util.tree_map(np.asarray, params)``), so this module never
imports JAX.  Both packages keep weights as ``[in, out]`` matrices under the
same keys, so the conversion is a copy and a cast.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .transformer import ModelConfig, Params

_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")
# An MoE layer's router (models/moe.py): fp32, as the JAX router computes.
_FP32 = _NORMS + ("w_router",)


def params_from_jax(
    tree: Mapping[str, Any],
    cfg: ModelConfig,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """The port's parameters from a JAX FlashLM pytree of numpy arrays.

    The tensors go to ``device``, the card by default (CPU runs pass
    ``device="cpu"``).  Matrices and the embedding become ``dtype``, by
    default ``cfg.dtype``
    (for serving: the JAX model casts its fp32 masters to that dtype at
    every use); training passes ``torch.float32`` to keep fp32 masters.
    Norm gains stay fp32.  A weight-only int8 matrix of
    ``models/wquant.py`` (``{"qw", "scale"}``) comes across as it is: int8
    ``qw`` and fp32 ``scale``.  An MoE layer (``models/moe.py``) brings its
    router ``w_router`` as fp32 and its 3-D expert stacks (``w_gate``,
    ``w_up`` ``[E, d, f]``, ``w_down`` ``[E, f, d]``) in ``dtype``.
    """
    store = cfg.dtype if dtype is None else dtype

    def tensor(a, dtype):
        if isinstance(a, Mapping):
            return {"qw": torch.from_numpy(np.array(a["qw"], dtype=np.int8)).to(device),
                    "scale": tensor(a["scale"], torch.float32)}
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype
        )

    layers = []
    for layer in tree["layers"]:
        out = {name: tensor(layer[name], store) for name in _MATRICES}
        out.update({name: tensor(layer[name], torch.float32) for name in _FP32 if name in layer})
        layers.append(out)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, cfg has {cfg.n_layers}")
    return {
        "embed": tensor(tree["embed"], store),
        "layers": layers,
        "final_norm": tensor(tree["final_norm"], torch.float32),
        "lm_head": tensor(tree["lm_head"], store),
    }
