"""Load the JAX package's FlashLM parameters into the port.

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
    Norm gains stay fp32.  Weight-only int8 and MoE layers are not ported
    and raise.
    """
    store = cfg.dtype if dtype is None else dtype

    def tensor(a, dtype):
        if isinstance(a, Mapping):
            raise NotImplementedError(
                "weight-only int8 parameters are not ported (see ROADMAP.md)"
            )
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype
        )

    layers = []
    for layer in tree["layers"]:
        if "w_router" in layer:
            raise NotImplementedError("MoE layers are not ported (see ROADMAP.md)")
        out = {name: tensor(layer[name], store) for name in _MATRICES}
        out.update({name: tensor(layer[name], torch.float32) for name in _NORMS})
        layers.append(out)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, cfg has {cfg.n_layers}")
    return {
        "embed": tensor(tree["embed"], store),
        "layers": layers,
        "final_norm": tensor(tree["final_norm"], torch.float32),
        "lm_head": tensor(tree["lm_head"], store),
    }
