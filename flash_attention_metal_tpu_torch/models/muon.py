"""Muon: orthogonalized-momentum updates for matrix weights.

Counterpart of ``flash_attention_metal_tpu/models/muon.py``.  Muon (Jordan
et al. 2024) replaces each hidden 2-D weight's momentum update by its
nearest orthogonal matrix, approximated by a quintic Newton-Schulz
iteration: matrix products only (bf16 ones here, as in JAX), no SVD.
Embeddings, norms, the lm_head and MoE expert stacks keep AdamW.

* ``scale_by_muon``: the transform for the matrix partition (momentum,
  Newton-Schulz, a shape-aware scale), with optax's ``init`` / ``update``
  shape, functional as JAX's.
* ``make_muon_optimizer``: Muon on the hidden matrices and AdamW on the
  rest, after one global-norm clip over every gradient (JAX's ``optax.chain``
  of ``clip_by_global_norm`` and ``multi_transform``), as an object with the
  port's ``AdamW.init`` / ``update`` interface, so ``Trainer(optimizer=...)``
  takes it; it updates the parameters in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch

from .trainer import AdamW
from .transformer import Params, param_leaves

# The quintic's coefficients (the published tuning that maximizes the
# slope at zero).
NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz_orthogonalize(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Quintic Newton-Schulz approximation of ``U V^T`` for ``g = U S V^T``:
    after ~5 iterations the singular values lie in about [0.7, 1.2].  The
    iterations run in bf16, fp32 in and out, as in JAX, whose Python-float
    coefficients are weakly typed and so take bf16 values (3.4375,
    -4.78125, 2.03125) beside a bf16 array: the port uses those values, and
    on the CPU its iterates equal JAX's bit for bit."""
    if g.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {tuple(g.shape)}")
    a, b, c = (float(torch.tensor(v, dtype=torch.bfloat16)) for v in NS_COEFFS)
    transpose = g.shape[0] > g.shape[1]
    x = g.t() if transpose else g
    x = (x / (torch.linalg.norm(x) + eps)).to(torch.bfloat16)
    for _ in range(steps):
        gram = x @ x.t()
        quad = b * gram + c * (gram @ gram)
        x = a * x + quad @ x
    x = x.float()
    return x.t() if transpose else x


class MuonState(NamedTuple):
    momentum: Any


class ScaleByMuon:
    """Momentum, then Newton-Schulz, then ``sqrt(max(1, rows / cols))``:
    ``init(params) -> MuonState``, ``update(updates, state, params=None) ->
    (updates, state)`` over a tree (or list) of 2-D matrices."""

    def __init__(self, momentum: float = 0.95, *, nesterov: bool = True, ns_steps: int = 5):
        self.momentum, self.nesterov, self.ns_steps = momentum, nesterov, ns_steps

    def init(self, params) -> MuonState:
        return MuonState(momentum=[torch.zeros_like(p) for p in param_leaves(params)])

    @torch.no_grad()
    def update(self, updates, state: MuonState, params=None):
        del params
        grads = param_leaves(updates)
        bufs = [self.momentum * m + g for m, g in zip(state.momentum, grads)]
        effective = ([g + self.momentum * m for g, m in zip(grads, bufs)] if self.nesterov
                     else bufs)
        out = [newton_schulz_orthogonalize(u, steps=self.ns_steps)
               * math.sqrt(max(1.0, u.shape[0] / u.shape[1])) for u in effective]
        return out, MuonState(momentum=bufs)


def scale_by_muon(momentum: float = 0.95, *, nesterov: bool = True,
                  ns_steps: int = 5) -> ScaleByMuon:
    """The Muon transform (see ``ScaleByMuon``)."""
    return ScaleByMuon(momentum, nesterov=nesterov, ns_steps=ns_steps)


def muon_label_tree(params: Params) -> Params:
    """``"muon"`` for the hidden 2-D layer weights, ``"adamw"`` for the rest
    (the embedding, the lm_head, norms, 3-D expert stacks, int8 weights)."""

    def label_layer(layer):
        return {name: "muon" if torch.is_tensor(w) and w.ndim == 2 else "adamw"
                for name, w in layer.items()}

    out: Dict[str, Any] = {k: "adamw" for k in params if k != "layers"}
    out["layers"] = [label_layer(layer) for layer in params["layers"]]
    return out


class MuonOptimizer:
    """A global-norm clip over every gradient, then Muon (momentum,
    Newton-Schulz, decoupled weight decay, ``-muon_lr``) on the leaves
    labelled ``"muon"`` and AdamW (b1 0.9, b2 0.95, a constant ``adamw_lr``)
    on the rest.  State: ``{"muon": {"momentum": [...]}, "adamw": AdamW's
    state}``, each over its leaves in ``param_leaves`` order (plain
    containers, so ``Trainer.save`` / ``load`` keep it)."""

    def __init__(self, labels: Params, *, muon_lr: float, momentum: float, adamw_lr: float,
                 weight_decay: float, grad_clip: float):
        self.labels = param_leaves(labels)
        self.muon = scale_by_muon(momentum)
        self.adamw = AdamW(lambda count: adamw_lr, b1=0.9, b2=0.95, weight_decay=weight_decay,
                           grad_clip=math.inf)
        self.muon_lr, self.weight_decay, self.grad_clip = muon_lr, weight_decay, grad_clip

    def _split(self, tree) -> tuple:
        leaves = param_leaves(tree)
        if len(leaves) != len(self.labels):
            raise ValueError(f"{len(leaves)} leaves, the labels have {len(self.labels)}")
        muon = [x for x, lab in zip(leaves, self.labels) if lab == "muon"]
        return muon, [x for x, lab in zip(leaves, self.labels) if lab != "muon"]

    def init(self, params: Params) -> Dict[str, Any]:
        muon, rest = self._split(params)
        return {"muon": self.muon.init(muon)._asdict(), "adamw": self.adamw.init(rest)}

    @torch.no_grad()
    def update(self, grads: Params, state: Dict[str, Any], params: Params) -> None:
        """Apply one update to ``params`` and ``state``, in place."""
        leaves = param_leaves(grads)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
        clipped = [torch.where(norm < self.grad_clip, g, (g / norm) * self.grad_clip)
                   for g in leaves]
        g_muon = [g for g, lab in zip(clipped, self.labels) if lab == "muon"]
        g_rest = [g for g, lab in zip(clipped, self.labels) if lab != "muon"]
        p_muon, p_rest = self._split(params)
        updates, new = self.muon.update(g_muon, MuonState(**state["muon"]))
        for p, u, m_old, m_new in zip(p_muon, updates, state["muon"]["momentum"], new.momentum):
            m_old.copy_(m_new)
            p.add_((u + self.weight_decay * p) * -self.muon_lr)
        self.adamw.update(g_rest, state["adamw"], p_rest)


def make_muon_optimizer(params: Params, *, muon_lr: float = 0.02, momentum: float = 0.95,
                        adamw_lr: float = 3e-4, weight_decay: float = 0.01,
                        grad_clip: float = 1.0) -> MuonOptimizer:
    """Muon on the hidden matrices and AdamW on the rest, for a FlashLM (or
    MoE) tree: JAX's ``make_muon_optimizer`` with its defaults."""
    return MuonOptimizer(muon_label_tree(params), muon_lr=muon_lr, momentum=momentum,
                         adamw_lr=adamw_lr, weight_decay=weight_decay, grad_clip=grad_clip)

