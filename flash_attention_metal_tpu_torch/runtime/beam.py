"""Beam-search decoding on the slot-cache primitives.

Counterpart of ``flash_attention_metal_tpu/runtime/beam.py``.  Beams live in
the batch dimension of a dense ``KVCache``: one decode step scores every
beam at once, and reordering the beams is one gather on the cache's slot
axis.  Finished beams (EOS) are frozen: their row proposes one continuation
(token 0) at log-probability 0, so they survive the top-k unchanged and the
shapes never change.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

from ..models.transformer import ModelConfig, Params
from .decode import decode_step, prefill_slot
from .kv_cache import init_cache


def _tensor_fields(state):
    return [(f.name, getattr(state, f.name)) for f in dataclasses.fields(state)
            if torch.is_tensor(getattr(state, f.name))]


def reorder_beam_state(state, parents: torch.Tensor):
    """Gather a dense cache's tensors by parent beam, in place: rank-1
    tensors (lengths) on axis 0, the others (``[L, B, ...]``) on axis 1."""
    for _, leaf in _tensor_fields(state):
        leaf.copy_(leaf[parents] if leaf.ndim == 1 else leaf[:, parents])
    return state


def broadcast_slot0(state):
    """Copy beam 0's state to every beam, in place (after the prefill)."""
    for _, leaf in _tensor_fields(state):
        leaf.copy_((leaf[:1] if leaf.ndim == 1 else leaf[:, :1]).expand_as(leaf))
    return state


def beam_search_loop(
    step_fn: Callable,
    state,
    logits0: torch.Tensor,
    *,
    beam_width: int,
    max_new_tokens: int,
    eos_id: int = -1,
    length_penalty: float = 0.0,
    return_all: bool = False,
    reorder_fn: Callable = reorder_beam_state,
):
    """Beam search over a batched decode step.

    ``step_fn(state, tokens, finished) -> (logits [B, V], state)`` advances
    the live beams only; ``logits0`` is the prompt's next-token logits
    (``[V]``), and ``state`` holds ``beam_width`` identical beams.  Returns
    ``(tokens, score)`` of the best beam, or every ``(tokens, score)``
    sorted best first with ``return_all``; a score is the summed
    log-probability over ``len ** length_penalty`` (0: the raw sum).
    """
    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    logp0 = torch.log_softmax(logits0.float().reshape(-1), dim=-1)
    cum_logp, first = torch.topk(logp0, beam_width)
    first = first.to(torch.int32)
    device = logits0.device
    out_tokens = torch.full((beam_width, max_new_tokens), -1, dtype=torch.int32, device=device)
    out_tokens[:, 0] = first
    finished = first == eos_id
    tokens = first
    for step in range(1, max_new_tokens):
        if bool(torch.all(finished)):
            break
        logits, state = step_fn(state, tokens, finished)
        logp = torch.log_softmax(logits.float(), dim=-1)
        vocab = logp.shape[-1]
        # Finished beams propose one frozen continuation (token 0, logp 0).
        frozen = torch.full_like(logp, float("-inf"))
        frozen[:, 0] = 0.0
        logp = torch.where(finished[:, None], frozen, logp)
        total = cum_logp[:, None] + logp
        cum_logp, idx = torch.topk(total.reshape(-1), beam_width)
        parents = idx // vocab
        tokens = (idx % vocab).to(torch.int32)
        state = reorder_fn(state, parents)
        was_finished = finished[parents]
        # A frozen beam's dummy continuation stays out of its history.
        out_tokens = out_tokens[parents]
        out_tokens[:, step] = torch.where(was_finished, torch.full_like(tokens, -1), tokens)
        finished = was_finished | (tokens == eos_id)

    outs = []
    host_tokens, host_logp = out_tokens.tolist(), cum_logp.tolist()
    for b in range(beam_width):
        seq = [t for t in host_tokens[b] if t >= 0]
        # Trim at EOS (EOS itself is not returned).
        if eos_id >= 0 and eos_id in seq:
            seq = seq[: seq.index(eos_id)]
        n = max(len(seq), 1)
        outs.append((seq, host_logp[b] / (n ** length_penalty if length_penalty else 1.0)))
    outs.sort(key=lambda t: -t[1])
    return outs if return_all else outs[0]


def beam_search_generate(
    params: Params,
    cfg: ModelConfig,
    prompt: List[int],
    *,
    beam_width: int = 4,
    max_new_tokens: int = 32,
    max_len: int = 1024,
    eos_id: int = -1,
    length_penalty: float = 0.0,
    return_all: bool = False,
) -> Tuple[List[int], float]:
    """The highest-probability FlashLM continuation of ``prompt``, on the
    device of ``params``: ``(tokens, score)`` (``beam_search_loop``).  Dense
    KV caches only (reordering gathers the slot axis)."""
    device = params["embed"].device
    cache = init_cache(cfg.n_layers, beam_width, cfg.n_kv_heads, max_len, cfg.head_dim,
                       dtype=cfg.dtype, device=device)
    n_pad = max(-(-len(prompt) // 128) * 128, 128)
    padded = torch.zeros((n_pad,), dtype=torch.int32, device=device)
    padded[: len(prompt)] = torch.tensor(prompt, dtype=torch.int32, device=device)
    logits0, cache = prefill_slot(params, cfg, cache, padded, len(prompt), 0)
    cache = broadcast_slot0(cache)

    def step_fn(cache, tokens, finished):
        # Frozen beams' lengths stay put, so their KV stays their sequence.
        return decode_step(params, cfg, cache, tokens, ~finished)

    return beam_search_loop(step_fn, cache, logits0, beam_width=beam_width,
                            max_new_tokens=max_new_tokens, eos_id=eos_id,
                            length_penalty=length_penalty, return_all=return_all)
