"""Memory-efficient losses: blockwise (chunked-vocab) cross-entropy.

Counterpart of ``flash_attention_metal_tpu/models/losses.py``.  The plain
``transformer.loss_fn`` materialises ``[B, N, V]`` fp32 logits and their
gradient.  Here the vocabulary is processed in chunks with an online
logsumexp (running max and rescaled sum), and each chunk runs under an
activation checkpoint, so the backward recomputes its ``[B, N, chunk]``
logits instead of keeping them: peak logit memory is O(B N chunk).  An
optional z-loss (PaLM) penalises log Z drifting from 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .transformer import ModelConfig, Params, forward_hidden, weight


def _chunk(m, l, tgt, hidden, w_chunk, targets, start: int):
    """One vocab chunk's update of the online (max, sum, target logit)."""
    logits = (hidden @ w_chunk).float()  # [B, T, chunk]
    m_new = torch.maximum(m, logits.amax(dim=-1))
    l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(dim=-1)
    local = targets - start
    in_chunk = (local >= 0) & (local < logits.shape[-1])
    picked = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return m_new, l, torch.where(in_chunk, picked, tgt)


def blockwise_softmax_xent(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    targets: torch.Tensor,
    *,
    vocab_chunk: int = 4096,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Mean cross-entropy of ``softmax(hidden @ lm_head)`` against targets.

    ``hidden``: ``[B, T, d]`` (any float dtype; logits are fp32).
    ``lm_head``: ``[d, V]``; ``hidden`` is cast to its dtype.
    ``targets``: ``[B, T]`` class ids.
    """
    d, v = lm_head.shape
    if v % vocab_chunk:
        raise ValueError(f"vocab {v} not divisible by chunk {vocab_chunk}")
    b, t = targets.shape
    hf = hidden.to(lm_head.dtype)
    targets = targets.long()
    dev = hidden.device
    m = torch.full((b, t), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, t), dtype=torch.float32, device=dev)
    tgt = torch.zeros((b, t), dtype=torch.float32, device=dev)
    for start in range(0, v, vocab_chunk):
        w = lm_head[:, start:start + vocab_chunk]
        if torch.is_grad_enabled():
            m, l, tgt = checkpoint(
                _chunk, m, l, tgt, hf, w, targets, start, use_reentrant=False
            )
        else:
            m, l, tgt = _chunk(m, l, tgt, hf, w, targets, start)
    lse = m + torch.log(l)
    nll = lse - tgt
    if z_loss:
        nll = nll + z_loss * lse**2
    return nll.mean()


def loss_fn_blockwise(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    dropout_seeds: Optional[torch.Tensor] = None,
    *,
    vocab_chunk: int = 4096,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Next-token CE equal to ``transformer.loss_fn`` without ``[B, N, V]``
    logits; ``dropout_seeds`` as ``transformer.forward_hidden``'s."""
    hidden = forward_hidden(params, tokens, cfg, dropout_seeds=dropout_seeds)
    return blockwise_softmax_xent(
        hidden[:, :-1],
        weight(params["lm_head"], cfg.dtype),
        tokens[:, 1:],
        vocab_chunk=min(vocab_chunk, cfg.vocab_size),
        z_loss=z_loss,
    )


@torch.no_grad()
def perplexity(
    params: Params,
    batches,
    cfg: ModelConfig,
    *,
    n_batches: int,
    vocab_chunk: int = 4096,
) -> float:
    """Token-weighted perplexity over ``n_batches`` ``[B, N]`` token batches
    drawn from an iterator (blockwise loss, no gradient)."""
    total_nll, total_tok = 0.0, 0
    for _ in range(n_batches):
        tokens = next(batches)
        n_tok = tokens.shape[0] * (tokens.shape[1] - 1)
        loss = loss_fn_blockwise(params, tokens, cfg, vocab_chunk=vocab_chunk)
        total_nll += float(loss) * n_tok
        total_tok += n_tok
    return math.exp(total_nll / max(total_tok, 1))
