"""Speculative decoding: draft-model proposals, target-model verification.

Counterpart of ``flash_attention_metal_tpu/runtime/speculative.py``.  A
cheap draft model proposes ``gamma`` tokens autoregressively, the target
model scores all of them in one chunked decode (``_forward_chunk``: causal
flash attention with each slot's offset, the cache kernels' own path; a
chunk of ``gamma + 1 <= 16`` rows runs their split-KV decode grid), and an
acceptance rule on the device keeps the longest prefix consistent with the
target distribution.

* Rollback after a rejection is the lengths alone: appends past a slot's
  length are hidden by the causal offset and overwritten by later rounds.
* Greedy (temperature 0) acceptance emits the target's own greedy tokens.
  With temperature > 0 the speculative-sampling rule (accept with
  ``min(1, p/q)``, resample the first rejection from ``max(p - q, 0)``)
  keeps the target distribution, under the same top-k / top-p / min-p
  filter and penalties as ``sample_batch``.
* Random draws come from a ``torch.Generator``: the sampled tokens differ
  from JAX's, the distributions do not.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import ModelConfig, Params, mlp_block
from .decode import (
    _attn_with_cache,
    _categorical,
    _logits,
    decode_step,
    filter_scaled_logits,
    prefill_slot,
    sample,
)
from .kv_cache import KVCache, init_cache


def _forward_chunk(
    params: Params, cfg: ModelConfig, cache: KVCache, tokens: torch.Tensor
) -> Tuple[torch.Tensor, KVCache]:
    """Multi-token decode: ``tokens [B, T]`` -> fp32 logits ``[B, T, V]``;
    does NOT bump lengths.  Row ``t`` of slot ``b`` sits at position
    ``lengths[b] + t``."""
    t_new = tokens.shape[1]
    positions = cache.lengths[:, None] + torch.arange(t_new, device=tokens.device)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        x, cache = _attn_with_cache(layer, x, cfg, cache, i, positions)
        x = mlp_block(layer, x, cfg)
    return _logits(params, x, cfg), cache


def _penalties(counts: torch.Tensor, presences: torch.Tensor,
               frequencies: torch.Tensor) -> torch.Tensor:
    """``presence * (count > 0) + frequency * count`` over the last axis's
    counts; ``presences``/``frequencies`` broadcast over the leading one."""
    shape = (-1,) + (1,) * (counts.ndim - 1)
    return (presences.reshape(shape) * (counts > 0).float()
            + frequencies.reshape(shape) * counts.float())


def acceptance_rule(
    d: torch.Tensor,
    q_logits: torch.Tensor,
    logits_t: torch.Tensor,
    greedy_slot: torch.Tensor,
    tau: torch.Tensor,
    generator: torch.Generator,
    top_ks: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    min_ps: Optional[torch.Tensor] = None,
    pen_counts: Optional[torch.Tensor] = None,
    presences: Optional[torch.Tensor] = None,
    frequencies: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative acceptance on the device (JAX ``acceptance_rule``).

    ``d [B, gamma]`` the draft's proposals, ``q_logits [B, gamma, V]`` the
    draft logits they were drawn from (penalised as drawn), ``logits_t [B,
    gamma + 1, V]`` the target's over ``[tok, d...]``, ``greedy_slot [B]``,
    ``tau [B, 1]`` the clamped temperatures.  Greedy slots accept by exact
    token match; sampling slots by ``u < min(1, p/q)`` under the slot's
    filter, the first rejection resampled from the normalised residual.
    Window row ``t`` of the target is penalised with ``pen_counts`` plus the
    proposals before it.  Returns ``(out [B, gamma + 1], n_acc [B], bonus
    [B])`` with ``out[:, n_acc] == bonus``.
    """
    batch, gamma = d.shape
    vocab = logits_t.shape[-1]
    if pen_counts is not None:
        d_hot = torch.nn.functional.one_hot(d.long(), vocab).to(pen_counts.dtype)
        cum = torch.cumsum(d_hot, dim=1)
        counts_t = pen_counts[:, None, :] + torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
        logits_t = logits_t - _penalties(counts_t, presences, frequencies)

    t_pred = torch.argmax(logits_t, dim=-1).to(torch.int32)  # [B, gamma + 1]
    greedy_match = d == t_pred[:, :gamma]

    def probs(scaled):
        t = scaled.shape[1]
        if top_ks is None and top_ps is None and min_ps is None:
            return torch.softmax(scaled, dim=-1)

        def rep(x):
            return None if x is None else x.repeat_interleave(t, dim=0)

        flat = filter_scaled_logits(scaled.reshape(batch * t, vocab), rep(top_ks), rep(top_ps),
                                    rep(min_ps))
        return torch.softmax(flat, dim=-1).reshape(batch, t, vocab)

    p = probs(logits_t / tau[..., None])
    q = probs(q_logits / tau[..., None])
    p_tok = p[:, :gamma].gather(-1, d.long()[..., None])[..., 0]
    q_tok = q.gather(-1, d.long()[..., None])[..., 0]
    u = torch.rand((batch, gamma), generator=generator, device=d.device)
    samp_accept = u < torch.clamp(p_tok / q_tok.clamp(min=1e-20), max=1.0)
    accept = torch.where(greedy_slot[:, None], greedy_match, samp_accept)
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)  # [B] in [0, gamma]

    # The bonus token at the first rejection: greedy slots the target's
    # argmax, sampling slots a draw from max(p - q, 0) (q = 0 past gamma).
    rows = torch.arange(batch, device=d.device)
    bonus_g = t_pred[rows, n_acc]
    p_n = p[rows, n_acc]
    q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    q_n = q_pad[rows, n_acc]
    resid = (p_n - q_n).clamp(min=0.0)
    norm = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(norm > 0, resid / norm.clamp(min=1e-20), p_n)
    bonus_s = _categorical(torch.log(resid.clamp(min=1e-30)), generator)
    bonus = torch.where(greedy_slot, bonus_g, bonus_s)

    idx = torch.arange(gamma + 1, device=d.device)[None, :]
    d_ext = torch.cat([d, d[:, -1:]], dim=1)
    out = torch.where(idx < n_acc[:, None], d_ext,
                      torch.where(idx == n_acc[:, None], bonus[:, None], torch.zeros_like(d_ext)))
    return out, n_acc, bonus


def speculative_step(
    params_t: Params,
    cfg_t: ModelConfig,
    cache_t,
    params_d: Params,
    cfg_d: ModelConfig,
    cache_d: KVCache,
    tok: torch.Tensor,
    active: torch.Tensor,
    generator: torch.Generator,
    temps: torch.Tensor,
    top_ks: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    min_ps: Optional[torch.Tensor] = None,
    pen_counts: Optional[torch.Tensor] = None,
    presences: Optional[torch.Tensor] = None,
    frequencies: Optional[torch.Tensor] = None,
    *,
    gamma: int,
):
    """One speculative round; emits 1 .. gamma + 1 tokens per active slot.

    Invariant in and out: both caches hold KV for every position below
    ``lengths[b]``, and ``tok[b]`` is the token at ``lengths[b]`` (in no
    cache yet).  The target cache may be dense, 8-bit or paged (its pages
    granted for ``gamma + 1`` more rows); the draft's is dense.  Returns
    ``(out [B, gamma + 1], n_emit [B], new_tok [B], cache_t, cache_d,
    pen_counts')``: ``out[:n_emit]`` are a slot's emitted tokens, ``new_tok
    == out[n_emit - 1]`` seeds the next round, and ``pen_counts'`` counts
    every emitted token (None without ``pen_counts``).
    """
    l0_t, l0_d = cache_t.lengths.clone(), cache_d.lengths.clone()
    greedy_slot = temps <= 0.0
    tau = temps.clamp(min=1e-6)[:, None]

    # The draft: gamma proposals, then one more step so its cache holds its
    # own last proposal (needed when every proposal is accepted).
    draft_toks, draft_logits = [], []
    cur = tok
    counts_run = pen_counts
    for _ in range(gamma):
        logits_d, cache_d = decode_step(params_d, cfg_d, cache_d, cur, active)
        if pen_counts is not None:
            logits_d = logits_d - _penalties(counts_run, presences, frequencies)
        g = torch.argmax(logits_d, dim=-1).to(torch.int32)
        s = _categorical(filter_scaled_logits(logits_d / tau, top_ks, top_ps, min_ps), generator)
        cur = torch.where(greedy_slot, g, s)
        if pen_counts is not None:
            counts_run = counts_run + torch.nn.functional.one_hot(
                cur.long(), counts_run.shape[-1]).to(counts_run.dtype)
        draft_toks.append(cur)
        draft_logits.append(logits_d)
    _, cache_d = decode_step(params_d, cfg_d, cache_d, cur, active)
    d = torch.stack(draft_toks, dim=1)  # [B, gamma]

    # The target verifies [tok, d_0 .. d_{gamma-1}] in one chunk.
    seq = torch.cat([tok[:, None], d], dim=1)
    logits_t, cache_t = _forward_chunk(params_t, cfg_t, cache_t, seq)

    out, n_acc, bonus = acceptance_rule(
        d, torch.stack(draft_logits, dim=1), logits_t, greedy_slot, tau, generator,
        top_ks, top_ps, min_ps, pen_counts, presences, frequencies,
    )
    n_emit = torch.where(active, n_acc + 1, torch.zeros_like(n_acc)).to(torch.int32)
    cache_t.lengths.copy_(l0_t + n_emit)
    cache_d.lengths.copy_(l0_d + n_emit)
    new_counts = pen_counts
    if pen_counts is not None:
        emitted = torch.arange(gamma + 1, device=tok.device)[None, :] < n_emit[:, None]
        out_hot = torch.nn.functional.one_hot(out.long(), pen_counts.shape[-1])
        new_counts = pen_counts + (out_hot * emitted[..., None]).sum(dim=1).to(pen_counts.dtype)
    return out, n_emit, bonus, cache_t, cache_d, new_counts


def speculative_generate(
    params_t: Params,
    cfg_t: ModelConfig,
    params_d: Params,
    cfg_d: ModelConfig,
    prompts: List[List[int]],
    max_new: int,
    *,
    gamma: int = 4,
    temperature: float = 0.0,
    seed: int = 0,
    max_len: Optional[int] = None,
    stats: Optional[dict] = None,
) -> List[List[int]]:
    """``max_new`` tokens per prompt by speculative decoding, on the device
    of ``params_t``.  At temperature 0 the result is the target's own
    greedy decode (the draft changes how many target forwards it takes,
    not the tokens).  ``stats``, when given, receives ``rounds``,
    ``slot_rounds`` (active slots summed over the rounds) and ``emitted``
    (the tokens the rounds emitted)."""
    device = params_t["embed"].device
    batch = len(prompts)
    n_pad = -(-max(len(p) for p in prompts) // 128) * 128
    if max_len is None:
        max_len = -(-(n_pad + max_new + gamma + 9) // 128) * 128
    cache_t = init_cache(cfg_t.n_layers, batch, cfg_t.n_kv_heads, max_len, cfg_t.head_dim,
                         cfg_t.dtype, device=device)
    cache_d = init_cache(cfg_d.n_layers, batch, cfg_d.n_kv_heads, max_len, cfg_d.head_dim,
                         cfg_d.dtype, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    first = []
    for b, prompt in enumerate(prompts):
        toks = torch.tensor(list(prompt) + [0] * (n_pad - len(prompt)), dtype=torch.int32,
                            device=device)
        logits_b, cache_t = prefill_slot(params_t, cfg_t, cache_t, toks, len(prompt), b)
        _, cache_d = prefill_slot(params_d, cfg_d, cache_d, toks, len(prompt), b)
        first.append(int(sample(logits_b, generator, temperature)))

    emitted: List[List[int]] = [[t] for t in first]
    tok = torch.tensor(first, dtype=torch.int32, device=device)
    temps = torch.full((batch,), temperature, dtype=torch.float32, device=device)
    rounds = slot_rounds = n_out = 0
    while True:
        active_h = np.array([len(e) < max_new for e in emitted])
        if not active_h.any():
            break
        out, n_emit, tok, cache_t, cache_d, _ = speculative_step(
            params_t, cfg_t, cache_t, params_d, cfg_d, cache_d, tok,
            torch.from_numpy(active_h).to(device), generator, temps, gamma=gamma,
        )
        out_h, n_h = out.cpu().numpy(), n_emit.cpu().numpy()
        rounds += 1
        slot_rounds += int(active_h.sum())
        n_out += int(n_h.sum())
        for b in range(batch):
            if active_h[b]:
                room = max_new - len(emitted[b])
                emitted[b].extend(out_h[b, : min(int(n_h[b]), room)].tolist())
    if stats is not None:
        stats.update(rounds=rounds, slot_rounds=slot_rounds, emitted=n_out)
    return emitted
