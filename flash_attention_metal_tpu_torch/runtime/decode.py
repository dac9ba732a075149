"""Prefill, single- and multi-step decode against the KV caches, and
sampling.

Counterpart of ``flash_attention_metal_tpu/runtime/decode.py`` on its
dense, 8-bit, paged and paged 8-bit caches and the rolling (wrapped) dense
and 8-bit caches.  A decode step with per-slot valid lengths is causal
flash attention with ``q_offset[b] = length[b]``, so stale cache rows past
each slot's write head are masked like future tokens: one kernel per cache
kind serves prefill and decode.  A rolling cache masks in position space:
its slots carry the positions they hold (``kv_positions``).

Sampling draws from a ``torch.Generator`` on the logits' device.  Its
numbers differ from ``jax.random``'s, so the two packages agree on greedy
tokens, filters and log-probabilities, not on sampled tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..models.transformer import (
    ModelConfig,
    Params,
    _merge_heads,
    attn_transforms,
    mlp_block,
    qkv_projections,
    rms_norm,
    weight,
)
from ..kernels.paged import flash_attention_paged, flash_attention_paged_quant
from ..kernels.quant import QuantizedKV, flash_attention_quant
from ..ops.attention import (
    flash_attention,
    fold_gqa_rows,
    gqa_decode_attention,
    unfold_gqa_rows,
)
from .kv_cache import (
    KVCache,
    QuantKVCache,
    RollingKVCache,
    RollingQuantKVCache,
    append_tokens,
    append_tokens_quant,
    append_tokens_rolling,
    append_tokens_rolling_quant,
    bump_lengths,
    bump_rolling_positions,
    rolling_write_slots,
)

ROLLING_CACHES = (RollingKVCache, RollingQuantKVCache)
from .paged_kv import (
    PagedKVCache,
    PagedQuantKVCache,
    append_tokens_paged,
    append_tokens_paged_quant,
)


def _attend(
    fn: Callable[[torch.Tensor, int], torch.Tensor], q: torch.Tensor, n_kv_heads: int, fold: bool
) -> torch.Tensor:
    """``fn(q, pos_div)``, with the GQA decode fold around it when ``fold``:
    the group q-heads sharing a KV head become rows of one tile
    (``pos_div = group``), so the cache is read once per KV head."""
    if not fold:
        return fn(q, 1)
    heads, t = q.shape[1], q.shape[2]
    o = fn(fold_gqa_rows(q, n_kv_heads).contiguous(), heads // n_kv_heads)
    return unfold_gqa_rows(o, heads, t)


def _effective_positions(cache, t_new: int) -> torch.Tensor:
    """The position map with the tokens being appended this step: the
    cache's own map advances once a step, after all layers, but the
    attention calls inside the step must see the in-flight tokens."""
    rows, pos, slots = rolling_write_slots(cache, t_new)
    eff = cache.positions.clone()
    eff[rows, slots] = pos
    return eff


def _attn_with_cache(
    layer: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: KVCache,
    layer_idx: int,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, KVCache]:
    """One attention block reading and writing the cache (T new tokens),
    within the config's window and sinks and under its softcap and ALiBi on
    every cache kind (JAX ``decode.py:92-270``)."""
    t_new = x.shape[1]
    xf = attn_transforms(cfg, x.device)
    win = dict(window=cfg.attn_window, sinks=cfg.attn_sinks, softcap=xf["softcap"])
    slopes = xf["alibi_slopes"]
    q, k, v = qkv_projections(layer, x, cfg, positions)
    # GQA decode head-fold: the group q-heads sharing a KV head become
    # rows of one tile, so the cache is read once per KV head.  Prefill
    # chunks (t_new * group > 128) keep the native GQA grid, and so does
    # ALiBi, whose slope is a q-head's (a folded row is not one head).
    group = cfg.n_heads // cfg.n_kv_heads
    fold = group > 1 and t_new * group <= 128 and slopes is None
    if slopes is not None:
        win["alibi_slopes"] = slopes
    # The causal offset is the OLD length: new row r sits at length + r.
    i = layer_idx
    if isinstance(cache, ROLLING_CACHES):
        # A rolling cache: O(window) memory, masked in position space (the
        # map with this step's tokens in flight).  Positions take no GQA
        # fold: the calls are unfolded.
        if cfg.attn_window is None:
            raise ValueError(f"{type(cache).__name__} requires cfg.attn_window")
        if isinstance(cache, RollingKVCache):
            cache = append_tokens_rolling(cache, i, k, v)
            o = flash_attention(q, cache.k[i], cache.v[i], q_offset=cache.lengths, causal=True,
                                kv_positions=_effective_positions(cache, t_new), **win)
        else:
            cache = append_tokens_rolling_quant(cache, i, k, v)
            qkv = QuantizedKV(cache.k_q[i], cache.v_q[i], cache.k_scale[i], cache.v_scale[i])
            o = flash_attention_quant(q.contiguous(), qkv, cache.lengths,
                                      _effective_positions(cache, t_new), causal=True, **win)
    elif isinstance(cache, PagedKVCache):
        # Appends scatter through the page table; the kernel reads through
        # it.  The engine's allocator granted the pages of length + t_new.
        cache = append_tokens_paged(cache, i, k, v)
        o = _attend(lambda qq, pos_div: flash_attention_paged(
            qq, cache.pool_k[i], cache.pool_v[i], cache.page_table, cache.lengths,
            pos_div=pos_div, **win), q.contiguous(), cfg.n_kv_heads, fold)
    elif isinstance(cache, PagedQuantKVCache):
        cache = append_tokens_paged_quant(cache, i, k, v)
        o = _attend(lambda qq, pos_div: flash_attention_paged_quant(
            qq, cache.pool_k_q[i], cache.pool_v_q[i], cache.pool_k_scale[i],
            cache.pool_v_scale[i], cache.page_table, cache.lengths, pos_div=pos_div, **win),
            q.contiguous(), cfg.n_kv_heads, fold)
    elif isinstance(cache, QuantKVCache):
        # Tokens are quantized at append; the kernel reads 8-bit KV and
        # per-token scales.
        cache = append_tokens_quant(cache, i, k, v)
        qkv = QuantizedKV(cache.k_q[i], cache.v_q[i], cache.k_scale[i], cache.v_scale[i])
        o = _attend(lambda qq, pos_div: flash_attention_quant(
            qq, qkv, cache.lengths, causal=True, pos_div=pos_div, **win),
            q.contiguous(), cfg.n_kv_heads, fold)
    else:
        cache = append_tokens(cache, i, k, v)
        if fold and cfg.attn_impl != "reference":
            o = gqa_decode_attention(q, cache.k[i], cache.v[i], cache.lengths, **win)
        else:
            o = flash_attention(
                q, cache.k[i], cache.v[i], q_offset=cache.lengths, causal=True,
                impl=cfg.attn_impl, **win,
            )
    return x + _merge_heads(o) @ weight(layer["wo"], cfg.dtype), cache


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return (x @ weight(params["lm_head"], cfg.dtype)).float()


def decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: torch.Tensor,
    active: torch.Tensor,
) -> Tuple[torch.Tensor, KVCache]:
    """One token per slot: ``tokens [B]`` -> fp32 logits ``[B, V]``.

    ``active``: bool ``[B]``.  Inactive slots run too, but their cache
    length does not advance, so what they wrote is overwritten later.
    """
    positions = cache.lengths[:, None]  # [B, 1]
    x = params["embed"][tokens[:, None].long()].to(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        x, cache = _attn_with_cache(layer, x, cfg, cache, i, positions)
        x = mlp_block(layer, x, cfg)
    logits = _logits(params, x, cfg)
    if isinstance(cache, ROLLING_CACHES):
        return logits[:, 0], bump_rolling_positions(cache, 1, active)
    return logits[:, 0], bump_lengths(cache, 1, active)


def prefill_chunk(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: torch.Tensor,
    start_len: int,
    prompt_len: int,
    slot: int,
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill one chunk ``[n_chunk]`` of one slot's prompt.

    ``start_len``: tokens already prefilled (0 for the first chunk).
    ``prompt_len``: the full true prompt length; positions past it inside
    the chunk are padding.  Padded rows' keys and values are written too
    (later decode steps overwrite them), and the slot's length becomes
    ``min(prompt_len, start_len + n_chunk)``.  A rolling cache records the
    positions of the true prompt tokens only (padded rows' slots get -1).
    Returns the logits of the prompt's last true token if it falls in this
    chunk, else of the chunk's last row.
    """
    n_chunk = tokens.shape[0]
    positions = (start_len + torch.arange(n_chunk, device=tokens.device))[None, :]
    x = params["embed"][tokens[None, :].long()].to(cfg.dtype)
    slot_cache = _slot_view(cache, slot, start_len)
    for i, layer in enumerate(params["layers"]):
        x, slot_cache = _attn_with_cache(layer, x, cfg, slot_cache, i, positions)
        x = mlp_block(layer, x, cfg)
    if isinstance(cache, ROLLING_CACHES):
        _, pos, slots = rolling_write_slots(slot_cache, n_chunk)
        slot_cache.positions[0, slots[0]] = torch.where(pos[0] < prompt_len, pos[0], -1)
    cache.lengths[slot] = min(prompt_len, start_len + n_chunk)
    last_idx = min(max(prompt_len - start_len - 1, 0), n_chunk - 1)
    return _logits(params, x[:, last_idx : last_idx + 1], cfg)[0, 0], cache


def _slot_view(cache, slot: int, start_len: int):
    """A one-slot view of ``cache`` whose appends write through to it, with
    length ``start_len``.  A paged cache's pools pass whole (prefill writes
    only the slot's own pages) with the slot's table row."""
    lengths = torch.full((1,), start_len, dtype=torch.int32, device=cache.lengths.device)
    if isinstance(cache, (PagedKVCache, PagedQuantKVCache)):
        return dataclasses.replace(
            cache, page_table=cache.page_table[slot : slot + 1], lengths=lengths
        )
    # Dense and rolling caches: every tensor but lengths and a rolling
    # cache's positions [B, capacity] is [n_layers, B, ...].
    views = {}
    for f in dataclasses.fields(cache):
        val = getattr(cache, f.name)
        if f.name == "positions":
            views[f.name] = val[slot : slot + 1]
        elif torch.is_tensor(val) and f.name != "lengths":
            views[f.name] = val[:, slot : slot + 1]
    return dataclasses.replace(cache, lengths=lengths, **views)


def prefill_slot(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: torch.Tensor,
    prompt_len: int,
    slot: int,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill one slot with a padded prompt ``[N_pad]`` (``N_pad % 128 == 0``).

    ``chunk``: process the prompt in chunks of this many tokens; None means
    one chunk.  The slot must be fresh (length 0).  Returns the next-token
    logits of the prompt's last true token.
    """
    n_pad = tokens.shape[0]
    if isinstance(cache, ROLLING_CACHES):
        # Every chunk row's window (and the sinks) must still be resident
        # when the chunk's attention runs: capacity >= window + sinks +
        # chunk.  A larger chunk would evict in-window KV silently.
        safe = cache.capacity - (cfg.attn_window or 0) - cache.sinks
        eff_chunk = n_pad if (chunk is None or chunk >= n_pad) else chunk
        if eff_chunk > safe:
            raise ValueError(
                f"rolling prefill chunk {eff_chunk} exceeds capacity {cache.capacity} - window "
                f"{cfg.attn_window} - sinks {cache.sinks} = {safe}; pass a smaller chunk="
            )
    if chunk is None or chunk >= n_pad:
        return prefill_chunk(params, cfg, cache, tokens, 0, prompt_len, slot)
    if chunk % 128:
        raise ValueError(f"chunk={chunk} must be a multiple of 128")
    last = None
    for start in range(0, n_pad, chunk):
        logits, cache = prefill_chunk(
            params, cfg, cache, tokens[start : start + chunk], start, prompt_len, slot
        )
        # Keep the chunk that holds the prompt's final true token.
        if last is None or start < prompt_len:
            last = logits
    return last, cache


def _filter_top_kp(
    scaled: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor
) -> torch.Tensor:
    """Mask all but the top-k / nucleus-p candidates to -inf.

    ``top_k [B]`` (<= 0 disables), ``top_p [B]`` (>= 1 disables).  The
    cumulative probability EXCLUDING the candidate itself is compared with
    ``top_p``, so rank 0 always survives.  The sort is stable ascending and
    then reversed, the order ``jnp.argsort(...)[:, ::-1]`` gives ties.
    """
    vocab = scaled.shape[-1]
    s, sort_idx = torch.sort(scaled, dim=-1, stable=True)
    s, sort_idx = s.flip(-1), sort_idx.flip(-1)
    rank = torch.arange(vocab, device=scaled.device)[None, :]
    keep = (top_k[:, None] <= 0) | (rank < top_k[:, None])
    probs = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep &= (top_p[:, None] >= 1.0) | ((cum - probs) < top_p[:, None])
    s = s.masked_fill(~keep, float("-inf"))
    return torch.empty_like(s).scatter_(-1, sort_idx, s)


def filter_scaled_logits(
    scaled: torch.Tensor,
    top_ks: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    min_ps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-slot min-p, then top-k/top-p, on temperature-scaled logits.

    The JAX version skips the vocab-wide sort under ``lax.cond`` when no
    slot filters.  Deciding that on the host would wait for the device
    every step, so the sort always runs: with the filters off it keeps
    every candidate, so the result is the same.
    """
    if min_ps is not None:
        row_max = scaled.amax(dim=-1, keepdim=True)
        thresh = row_max + torch.log(min_ps.clamp(min=1e-30))[:, None]
        keep = (scaled >= thresh) | (min_ps[:, None] <= 0.0)
        scaled = scaled.masked_fill(~keep, float("-inf"))
    if top_ks is not None or top_ps is not None:
        batch = scaled.shape[0]
        if top_ks is None:
            top_ks = torch.zeros((batch,), dtype=torch.int32, device=scaled.device)
        if top_ps is None:
            top_ps = torch.ones((batch,), dtype=torch.float32, device=scaled.device)
        scaled = _filter_top_kp(scaled, top_ks, top_ps)
    return scaled


def _categorical(scaled: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(scaled)`` by the Gumbel-max rule."""
    u = torch.rand(
        scaled.shape, generator=generator, device=scaled.device, dtype=torch.float32
    )
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


def sample(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
) -> torch.Tensor:
    """Greedy (temperature 0, or no generator) / temperature / top-k /
    nucleus / min-p sampling of one token from ``[..., V]`` logits (JAX
    ``decode.py::sample``): min-p first, then top-k/top-p, as
    ``sample_batch``."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = (logits.float() / temperature).reshape(1, -1)

    def one(value, dtype):
        return torch.tensor([value], dtype=dtype, device=scaled.device)

    # A filter at its off value (top_k 0, top_p 1, min_p 0) keeps everything.
    scaled = filter_scaled_logits(scaled, one(top_k, torch.int32), one(top_p, torch.float32),
                                  one(min_p, torch.float32))
    return _categorical(scaled, generator)[0]


def sample_batch(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperatures: torch.Tensor,
    top_ks: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    pen_counts: Optional[torch.Tensor] = None,
    presences: Optional[torch.Tensor] = None,
    frequencies: Optional[torch.Tensor] = None,
    min_ps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-slot greedy/temperature/top-k/top-p/min-p sampling, on the device.

    ``logits [B, V]``, ``temperatures [B]`` (0 = greedy), ``top_ks [B]``
    (<= 0 off), ``top_ps [B]`` (>= 1 off), ``min_ps [B]`` (<= 0 off).
    ``pen_counts [B, V]`` int32 counts of generated tokens enable
    OpenAI-style penalties: ``logits -= presence * (count > 0) +
    frequency * count``; greedy slots are penalised too.
    """
    if pen_counts is not None:
        counts = pen_counts.to(logits.dtype)
        logits = logits - (
            presences[:, None] * (pen_counts > 0).to(logits.dtype)
            + frequencies[:, None] * counts
        )
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = temperatures.clamp(min=1e-6)[:, None]
    scaled = filter_scaled_logits(logits / temps, top_ks, top_ps, min_ps)
    sampled = _categorical(scaled, generator)
    return torch.where(temperatures <= 0.0, greedy, sampled)


def _token_logprobs(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Raw-softmax log-probability of each chosen token (pre-temperature)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, toks.long()[..., None])[..., 0]


def decode_and_sample(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: torch.Tensor,
    active: torch.Tensor,
    generator: torch.Generator,
    temperatures: torch.Tensor,
    top_ks: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    pen_counts: Optional[torch.Tensor] = None,
    presences: Optional[torch.Tensor] = None,
    frequencies: Optional[torch.Tensor] = None,
    min_ps: Optional[torch.Tensor] = None,
):
    """One serving step: decode, sample, and log-probabilities, on the device.

    Returns ``(toks, logprobs, cache[, pen_counts])``.  ``logprobs [B]`` is
    each emitted token's log-probability under the raw softmax
    (pre-temperature, pre-penalty).  Inactive slots emit token 0 and their
    cache does not advance.  ``pen_counts`` is updated in place.
    """
    logits, cache = decode_step(params, cfg, cache, tokens, active)
    toks, logp = _sample_step(logits, active, generator, temperatures, top_ks, top_ps,
                              pen_counts, presences, frequencies, min_ps)
    if pen_counts is None:
        return toks, logp, cache
    return toks, logp, cache, pen_counts


def _sample_step(logits, active, generator, temperatures, top_ks, top_ps, pen_counts,
                 presences, frequencies, min_ps):
    """``decode_and_sample``'s sampling of one step's ``logits``: the tokens
    (0 for inactive slots) and their log-probabilities, ``pen_counts``
    counted in place."""
    toks = sample_batch(
        logits, generator, temperatures, top_ks, top_ps,
        pen_counts, presences, frequencies, min_ps,
    )
    toks = torch.where(active, toks, torch.zeros_like(toks))
    logp = _token_logprobs(logits, toks)
    if pen_counts is not None:
        rows = torch.arange(toks.shape[0], device=toks.device)
        pen_counts.index_put_((rows, toks.long()), active.to(pen_counts.dtype), accumulate=True)
    return toks, logp


def decode_and_sample_multi(
    params: Params,
    cfg: ModelConfig,
    cache: KVCache,
    tokens: torch.Tensor,
    active: torch.Tensor,
    generator: torch.Generator,
    temperatures: torch.Tensor,
    top_ks: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    pen_counts: Optional[torch.Tensor] = None,
    presences: Optional[torch.Tensor] = None,
    frequencies: Optional[torch.Tensor] = None,
    min_ps: Optional[torch.Tensor] = None,
    *,
    n_steps: int,
    with_logits: bool = False,
):
    """``n_steps`` decode + sample steps, each step's tokens fed to the next
    on the device: no host sync between them (JAX's ``lax.scan``).

    Returns ``(toks [n_steps, B], logprobs [n_steps, B], cache[,
    pen_counts])``, and with ``with_logits`` each step's logits ``[n_steps,
    B, V]`` last (the served-path check reads them).  A slot may decode up
    to ``n_steps - 1`` tokens past its stop point; the engine discards them
    at harvest, and the next occupant's lengths mask them.
    """
    all_toks, all_logps, all_logits = [], [], []
    for _ in range(n_steps):
        logits, cache = decode_step(params, cfg, cache, tokens, active)
        tokens, logp = _sample_step(logits, active, generator, temperatures, top_ks, top_ps,
                                    pen_counts, presences, frequencies, min_ps)
        all_toks.append(tokens)
        all_logps.append(logp)
        if with_logits:
            all_logits.append(logits)
    out = (torch.stack(all_toks), torch.stack(all_logps), cache)
    if pen_counts is not None:
        out += (pen_counts,)
    return (*out, torch.stack(all_logits)) if with_logits else out


def admit_update(
    logits: torch.Tensor,
    generator: torch.Generator,
    slot: Optional[int],
    temp: float,
    top_k: int,
    top_p: float,
    min_p: float,
    presence: float,
    frequency: float,
    next_token: torch.Tensor,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
    presences: torch.Tensor,
    frequencies: torch.Tensor,
    min_ps: torch.Tensor,
    pen_counts: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Install a new occupant of ``slot``: sample its first token from the
    prefill ``logits [V]``, take its log-probability, and write every
    per-slot sampling setting and a fresh penalty count in place.

    Penalties are skipped for the first token: the new occupant's counts
    are zero.  Returns ``(tok, logprob)`` as 0-d device tensors.  ``slot``
    None samples alike and installs nothing: a rank of a sharded engine
    whose shard does not hold the slot.
    """
    dev = logits.device

    def one(value, dtype):
        return torch.full((1,), value, dtype=dtype, device=dev)

    tok = sample_batch(
        logits[None], generator, one(temp, torch.float32),
        one(top_k, torch.int32), one(top_p, torch.float32),
        min_ps=one(min_p, torch.float32),
    )[0]
    logp = _token_logprobs(logits, tok)
    if slot is None:
        return tok, logp
    next_token[slot] = tok
    temps[slot] = temp
    top_ks[slot] = top_k
    top_ps[slot] = top_p
    presences[slot] = presence
    frequencies[slot] = frequency
    min_ps[slot] = min_p
    # The admission token is already emitted, so it counts.
    pen_counts[slot].zero_()
    pen_counts[slot].index_fill_(0, tok.long().reshape(1), 1)
    return tok, logp
