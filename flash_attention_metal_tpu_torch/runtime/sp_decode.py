"""Sequence- and tensor-sharded serving: the KV cache's length over ``sp``,
its KV heads and the Megatron weight shards over ``tp``, its slots over
``dp``.

Counterpart of ``flash_attention_metal_tpu/runtime/sp_decode.py``.  The JAX
module is one ``shard_map`` program that one controller lays over every
device; here every rank is a process that runs the same engine
(``runtime/engine.py``) on its shards, and every collective is explicit
(``parallel/comm.py``).

* **Masked shard appends.**  A token at global position ``p`` lives in sp
  shard ``p // maxloc``.  Every shard computes the new K/V (activations are
  replicated over sp), but only the owner's write sticks
  (``_masked_append``): chunk-wise through a clipped index, or row by row
  (``per_row=True``) for a verify window that may straddle a shard
  boundary.
* **Local causal offset.**  The kernel's per-slot offset is ``lengths -
  my_sp * maxloc``: a shard wholly before the write head sees every column
  (offset >= maxloc), the owner the ragged decode mask, a shard after it
  nothing (a negative offset: o = 0 and lse = -inf), and the partials merge
  by their logsumexps (``parallel/context.py::lse_psum_combine``).  The
  offset is a tensor, so the calls run the general kernel and its split-KV
  decode grid (rows 1 and 11 of the kernel table), never the triangular one.
* **8-bit shards.**  Values and per-token scales split on the same axis, in
  the port's ``QuantizedKV`` layout (scales ``[B, H, N]``).
* **Tensor parallelism.**  ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` by
  column, ``wo`` and ``w_down`` by row with a sum over tp after each; the
  norms, the embedding and ``lm_head`` replicated, so the logits, and hence
  sampling, are the same on every tp and sp rank of a dp group.

Supported caches: the dense ``KVCache`` and the 8-bit ``QuantKVCache``.
Rolling caches stay dp-only (a wrapped position map has no contiguous
shard ownership), and a paged pool stays on one device.

``SpStepFns`` takes this rank's shards: a cache of ``[L, B / dp, H_kv /
tp, max_len / sp, D]`` and parameters sharded by ``param_pspecs``
(``shard_params``).  Its prefill takes a global slot: the ranks of the dp
group that holds it compute, and the logits reach every rank of the mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.flash_fwd import flash_attention_fwd
from ..kernels.quant import QuantizedKV, flash_attention_quant, quantize_tokens
from ..models.transformer import (
    ModelConfig,
    Params,
    _maybe_rope,
    _merge_heads,
    _split_heads,
    alibi_slopes,
    map_params,
    mlp_block,
    rms_norm,
    weight,
)
from ..parallel.comm import all_reduce
from ..parallel.context import lse_psum_combine
from ..parallel.mesh import Mesh, shard
from .decode import _logits, _sample_step, _slot_view, decode_step, filter_scaled_logits
from .kv_cache import KVCache, QuantKVCache, as_bytes, bump_lengths

# The rows of JAX's verify window are padded to its kernel's 8-row tiling.
VERIFY_ROWS = 8


def _tp_mlp(layer: Params, x: torch.Tensor, cfg: ModelConfig, mesh: Optional[Mesh],
            head_axis: Optional[str]) -> torch.Tensor:
    """Megatron MLP: column-parallel gate/up, row-parallel down, summed over
    ``head_axis`` (the one-device ``mlp_block`` without one)."""
    if head_axis is None:
        return mlp_block(layer, x, cfg)
    dt = cfg.dtype
    h = rms_norm(x, layer["mlp_norm"])
    gate = F.silu(h @ weight(layer["w_gate"], dt))
    up = h @ weight(layer["w_up"], dt)
    return x + all_reduce((gate * up) @ weight(layer["w_down"], dt), mesh, (head_axis,))


def cache_pspec(leaf: torch.Tensor, batch_axis: str, seq_axis: Optional[str] = None,
                head_axis: Optional[str] = None) -> tuple:
    """The spec of a KV-cache leaf: slots on ``batch_axis``, the length on
    ``seq_axis``, the KV heads on ``head_axis``.  Ranks: 5 = values ``[L, B,
    H, len, D]``; 4 = 8-bit scales ``[L, B, H, len]``; 1 = lengths ``[B]``."""
    if leaf.ndim == 5:
        return (None, batch_axis, head_axis, seq_axis, None)
    if leaf.ndim == 4:
        return (None, batch_axis, head_axis, seq_axis)
    if leaf.ndim == 1:
        return (batch_axis,)
    raise ValueError(f"unsupported cache leaf rank {leaf.ndim} for sequence sharding "
                     "(rolling caches are dp-only)")


def param_pspecs(params: Params, head_axis: Optional[str]) -> Params:
    """Megatron tensor-parallel specs of the serving parameters: ``wq``,
    ``wk``, ``wv``, ``w_gate``, ``w_up`` by column and ``wo``, ``w_down`` by
    row; the norms, ``embed`` and ``lm_head`` replicated (``()``)."""
    if head_axis is None:
        return map_params(lambda _: (), params)
    col, row = (None, head_axis), (head_axis, None)
    layer = {"attn_norm": (), "wq": col, "wk": col, "wv": col, "wo": row, "mlp_norm": (),
             "w_gate": col, "w_up": col, "w_down": row}
    return {"embed": (), "layers": [dict(layer) for _ in params["layers"]], "final_norm": (),
            "lm_head": ()}


def shard_params(params: Params, mesh: Mesh, head_axis: Optional[str]) -> Params:
    """This rank's shards of a whole serving tree (e.g. one from
    ``models/from_jax.py``), on ``mesh.device``."""
    return map_params(lambda p, s: shard(p, mesh, s), params, param_pspecs(params, head_axis))


def _put(buf: torch.Tensor, new: torch.Tensor, start: torch.Tensor, owned: torch.Tensor,
         per_row: bool) -> torch.Tensor:
    """``_masked_append``'s body for values ``[B, H, maxloc, D]`` and scales
    ``[B, H, maxloc]`` alike: ``new`` ``[B, H, T(, D)]``, in place."""
    batch, t_new, maxloc = new.shape[0], new.shape[2], buf.shape[2]
    dst, src = as_bytes(buf), as_bytes(new.to(buf.dtype))
    tail = (1,) * (src.ndim - 2)
    slots = torch.arange(batch, device=buf.device)
    if per_row:
        # Row by row in window order, as JAX unrolls it: a row writes only
        # where its position lies in this shard.
        for t in range(t_new):
            pos = start + t
            ow = (pos >= 0) & (pos < maxloc)
            idx = pos.clamp(0, maxloc - 1).long()
            old = dst[slots, :, idx]
            dst[slots, :, idx] = torch.where(ow.view(-1, *tail), src[:, :, t], old)
        return buf
    rows = (start.clamp(0, maxloc - t_new)[:, None]
            + torch.arange(t_new, device=buf.device)).long()
    # Advanced indices around a slice: the indexed view is [B, T, H(, D)].
    old = dst[slots[:, None], :, rows]
    dst[slots[:, None], :, rows] = torch.where(owned.view(-1, 1, *tail), src.movedim(2, 1), old)
    return buf


def _masked_append(buf: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
                   owned: torch.Tensor, per_row: bool = False) -> torch.Tensor:
    """Write ``new`` ``[B, H, T, D]`` into the local shard ``buf`` ``[B, H,
    maxloc, D]`` at per-slot offsets ``start`` (int32 ``[B]``, may be
    negative) where ``owned`` (bool ``[B]``), in place; a slot not owned
    keeps its rows.  The start is clipped to ``[0, maxloc - T]``, as JAX's
    ``dynamic_update_slice``.  ``per_row=True`` ignores ``owned`` and writes
    row ``t`` iff ``0 <= start + t < maxloc``: a small multi-row window (the
    speculative verify) may straddle a shard boundary."""
    return _put(buf, new, start, owned, per_row)


def _masked_append_scale(buf: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
                         owned: torch.Tensor, per_row: bool = False) -> torch.Tensor:
    """``_masked_append`` for per-token scales: ``buf`` ``[B, H, maxloc]``,
    ``new`` ``[B, H, T]``."""
    return _put(buf, new, start, owned, per_row)


def local_offsets(lengths: torch.Tensor, my_sp: int, maxloc: int) -> torch.Tensor:
    """The kernel's per-slot causal offset on sp shard ``my_sp``:
    ``lengths - my_sp * maxloc`` (negative: the shard lies wholly in the
    future; ``>= maxloc``: wholly in the past)."""
    return (lengths - my_sp * maxloc).to(torch.int32)


def _sp_attn_with_cache(layer: Params, x: torch.Tensor, cfg: ModelConfig, cache,
                        layer_idx: int, positions: torch.Tensor, mesh: Mesh, *,
                        seq_axis: Optional[str], head_axis: Optional[str] = None,
                        row_owned: bool = False):
    """One attention block against this rank's KV shard (JAX ``:216``):
    column-parallel projections with this tp shard's head counts, RoPE at
    the global ``positions``, the masked append, the kernel with its lse at
    the local offset, the lse combine over ``seq_axis`` and the row-parallel
    ``wo`` summed over ``head_axis``.  ALiBi's slopes are this tp shard's
    heads; the shard term of the offset cancels in its distance, so it is
    global on every sp shard.  Returns ``(x + out, cache)``."""
    if cfg.attn_window is not None:
        raise ValueError("sequence-sharded decode does not compose with sliding-window caches "
                         "(window masking is slot-local); use dp sharding")
    dt = cfg.dtype
    t_new = x.shape[1]
    tp = mesh.size(head_axis) if head_axis else 1
    h_loc, hk_loc = cfg.n_heads // tp, cfg.n_kv_heads // tp
    slopes = None
    if cfg.attn_alibi:
        my_tp = mesh.index(head_axis) if head_axis else 0
        slopes = alibi_slopes(cfg.n_heads, x.device)[my_tp * h_loc:(my_tp + 1) * h_loc]
        slopes = slopes.contiguous()
    xf = dict(softcap=cfg.attn_softcap, alibi_slopes=slopes)
    h = rms_norm(x, layer["attn_norm"])
    q = _maybe_rope(_split_heads(h @ weight(layer["wq"], dt), h_loc, cfg.head_dim), positions, cfg)
    k = _maybe_rope(_split_heads(h @ weight(layer["wk"], dt), hk_loc, cfg.head_dim), positions,
                    cfg)
    v = _split_heads(h @ weight(layer["wv"], dt), hk_loc, cfg.head_dim)
    my_sp = mesh.index(seq_axis) if seq_axis else 0
    start = local_offsets(cache.lengths, my_sp, cache.max_len)
    owned = (start >= 0) & (start + t_new <= cache.max_len)
    i = layer_idx
    if isinstance(cache, QuantKVCache):
        xq, scale = quantize_tokens(torch.stack((k, v)), cache.k_q.dtype)
        for j, (buf, sbuf) in enumerate(((cache.k_q, cache.k_scale), (cache.v_q, cache.v_scale))):
            _masked_append(buf[i], xq[j], start, owned, per_row=row_owned)
            _masked_append_scale(sbuf[i], scale[j], start, owned, per_row=row_owned)
        qkv = QuantizedKV(cache.k_q[i], cache.v_q[i], cache.k_scale[i], cache.v_scale[i])
        o, lse = flash_attention_quant(q.contiguous(), qkv, start, causal=True, save_lse=True,
                                       **xf)
    elif isinstance(cache, KVCache):
        _masked_append(cache.k[i], k, start, owned, per_row=row_owned)
        _masked_append(cache.v[i], v, start, owned, per_row=row_owned)
        o, lse = flash_attention_fwd(q.contiguous(), cache.k[i], cache.v[i], start, causal=True,
                                     save_lse=True, **xf)
    else:
        raise TypeError(f"sharded serving takes a KVCache or QuantKVCache, not "
                        f"{type(cache).__name__}")
    if seq_axis is not None:
        o = lse_psum_combine(o, lse, mesh, seq_axis).to(dt)
    out = _merge_heads(o) @ weight(layer["wo"], dt)
    if head_axis is not None:
        out = all_reduce(out, mesh, (head_axis,))
    return x + out, cache


class SpStepFns:
    """Prefill, decode and speculative steps of a ``(dp x tp x sp)``-sharded
    engine on this rank's shards (JAX ``SpStepFns``).  ``seq_axis`` shards
    the KV length (lse combine), ``head_axis`` the KV heads and the Megatron
    weights (a sum over it after each row-parallel product); either may be
    None.  Every rank of a dp group runs the same steps on the same inputs
    and draws from a generator seeded alike (the engine's), so the sampled
    tokens agree across its tp and sp ranks."""

    def __init__(self, mesh: Mesh, cfg: ModelConfig, *, batch_axis: str = "dp",
                 seq_axis: Optional[str] = "sp", head_axis: Optional[str] = None):
        self.mesh = mesh
        self.cfg = cfg
        self.batch_axis = batch_axis
        self.seq_axis = seq_axis
        self.head_axis = head_axis
        self.tp_size = mesh.size(head_axis) if head_axis else 1
        if self.tp_size > 1 and (cfg.n_heads % self.tp_size or cfg.n_kv_heads % self.tp_size):
            raise ValueError(f"n_heads={cfg.n_heads}/n_kv_heads={cfg.n_kv_heads} must divide "
                             f"over {head_axis}={self.tp_size}")

    # ------------------------------------------------------------------
    def _forward(self, params: Params, cache, tokens: torch.Tensor, positions: torch.Tensor,
                 row_owned: bool = False):
        """``tokens`` ``[B, T]`` at global ``positions`` -> fp32 logits
        ``[B, T, V]`` (the cache's lengths not bumped)."""
        cfg = self.cfg
        x = params["embed"][tokens.long()].to(cfg.dtype)
        for i, layer in enumerate(params["layers"]):
            x, cache = _sp_attn_with_cache(layer, x, cfg, cache, i, positions, self.mesh,
                                           seq_axis=self.seq_axis, head_axis=self.head_axis,
                                           row_owned=row_owned)
            x = _tp_mlp(layer, x, cfg, self.mesh, self.head_axis)
        return _logits(params, x, cfg), cache

    def _one_step(self, params, cache, tok, active, generator, temps, top_ks, top_ps,
                  pen_counts, presences, frequencies, min_ps):
        logits, cache = self._forward(params, cache, tok[:, None], cache.lengths[:, None])
        logits = logits[:, 0]
        cache = bump_lengths(cache, 1, active)
        toks, logp = _sample_step(logits, active, generator, temps, top_ks, top_ps, pen_counts,
                                  presences, frequencies, min_ps)
        return toks, logp, cache, logits

    def decode_and_sample(self, params, cache, tokens, active, generator, temps, top_ks=None,
                          top_ps=None, pen_counts=None, presences=None, frequencies=None,
                          min_ps=None):
        """One sharded decode + sample step on this rank's slots (JAX
        ``:502``): ``(toks [B], logprobs [B], cache, pen_counts)``,
        ``pen_counts`` counted in place."""
        toks, logp, cache, _ = self._one_step(params, cache, tokens, active, generator, temps,
                                              top_ks, top_ps, pen_counts, presences, frequencies,
                                              min_ps)
        return toks, logp, cache, pen_counts

    def decode_and_sample_multi(self, params, cache, tokens, active, generator, temps,
                                top_ks=None, top_ps=None, pen_counts=None, presences=None,
                                frequencies=None, min_ps=None, *, n_steps: int,
                                with_logits: bool = False):
        """``n_steps`` sharded steps in one call, each step's tokens fed to
        the next on the device, the lse combine and the tp sums inside the
        loop (JAX ``:580``): ``(toks [n_steps, B], logprobs [n_steps, B],
        cache, pen_counts)``, and with ``with_logits`` each step's logits
        ``[n_steps, B, V]`` last."""
        all_toks, all_logps, all_logits = [], [], []
        for _ in range(n_steps):
            tokens, logp, cache, logits = self._one_step(
                params, cache, tokens, active, generator, temps, top_ks, top_ps, pen_counts,
                presences, frequencies, min_ps)
            all_toks.append(tokens)
            all_logps.append(logp)
            if with_logits:
                all_logits.append(logits)
        out = (torch.stack(all_toks), torch.stack(all_logps), cache, pen_counts)
        return (*out, torch.stack(all_logits)) if with_logits else out

    # ------------------------------------------------------------------
    def local_slot(self, slot: int, b_loc: int) -> Optional[int]:
        """``slot``'s index in this rank's shard of ``b_loc`` slots, or None
        when another dp group holds it."""
        lo = self.mesh.index(self.batch_axis) * b_loc
        return slot - lo if lo <= slot < lo + b_loc else None

    def _prefill_local(self, params, cache, tokens, start_len: int, prompt_len: int,
                       local: int) -> torch.Tensor:
        n_chunk = tokens.shape[0]
        slot_cache = _slot_view(cache, local, start_len)
        positions = (start_len + torch.arange(n_chunk, device=tokens.device))[None, :]
        logits, _ = self._forward(params, slot_cache, tokens[None, :], positions)
        cache.lengths[local] = min(prompt_len, start_len + n_chunk)
        last_idx = min(max(prompt_len - start_len - 1, 0), n_chunk - 1)
        return logits[0, last_idx]

    def prefill_chunk(self, params, cache, tokens, start_len: int, prompt_len: int, slot: int):
        """Prefill one chunk ``[n]`` of global ``slot``'s prompt (JAX
        ``:697``); the chunk must lie in one sp shard.  Returns the logits of
        its last true token, the same on every rank of the mesh
        (``share_logits``), and the cache."""
        b_loc = cache.lengths.shape[0]
        local = self.local_slot(slot, b_loc)
        logits = None
        if local is not None:
            logits = self._prefill_local(params, cache, tokens, start_len, prompt_len, local)
        return share_logits(self.mesh, self.batch_axis, logits, slot // b_loc,
                            self.cfg.vocab_size, cache.lengths.device), cache

    def prefill_slot(self, params, cache, tokens, prompt_len: int, slot: int, chunk: int):
        """Chunked prefill of global ``slot`` with a padded prompt (JAX
        ``:707``): every chunk lands in one sp shard (``chunk`` divides the
        shard's length, prompts are padded to 128).  Only the ranks of the
        dp group that holds the slot compute; the logits of the prompt's
        last true token reach every rank in one collective at the end."""
        b_loc = cache.lengths.shape[0]
        local = self.local_slot(slot, b_loc)
        maxloc = cache.max_len
        if chunk % 128 or maxloc % chunk:
            raise ValueError(f"chunk={chunk} must be a multiple of 128 dividing the shard's "
                             f"{maxloc} positions")
        last = None
        if local is not None:
            for start in range(0, tokens.shape[0], chunk):
                logits = self._prefill_local(params, cache, tokens[start:start + chunk], start,
                                             prompt_len, local)
                if last is None or start < prompt_len:
                    last = logits
        return share_logits(self.mesh, self.batch_axis, last, slot // b_loc,
                            self.cfg.vocab_size, cache.lengths.device), cache

    # ------------------------------------------------------------------
    def speculative_step(self, params_t, cache_t, params_d, cache_d, tok, active, generator,
                         temps, top_ks=None, top_ps=None, min_ps=None, pen_counts=None,
                         presences=None, frequencies=None, *, cfg_d: ModelConfig, gamma: int):
        """One speculative round on the sharded target cache (JAX
        ``:724-902``).  The draft's parameters are replicated and its dense
        cache dp-local: every rank of a dp group runs the same ``gamma``
        proposals and one ingest step.  The target verifies ``[tok, d_0 ..
        d_{gamma-1}]``, padded to ``VERIFY_ROWS`` rows, in one multi-row
        sharded decode whose appends own rows one by one (the window may
        straddle a shard boundary).  Acceptance is
        ``speculative.acceptance_rule``.  Returns ``(out [B, gamma + 1],
        n_emit [B], new_tok [B], cache_t, cache_d, pen_counts)``."""
        from .speculative import _penalties, acceptance_rule
        from .decode import _categorical

        l0_t, l0_d = cache_t.lengths.clone(), cache_d.lengths.clone()
        greedy_slot = temps <= 0.0
        tau = temps.clamp(min=1e-6)[:, None]
        draft_toks, draft_logits = [], []
        cur = tok
        counts_run = pen_counts
        for _ in range(gamma):
            logits_d, cache_d = decode_step(params_d, cfg_d, cache_d, cur, active)
            if pen_counts is not None:
                logits_d = logits_d - _penalties(counts_run, presences, frequencies)
            g = torch.argmax(logits_d, dim=-1).to(torch.int32)
            s = _categorical(filter_scaled_logits(logits_d / tau, top_ks, top_ps, min_ps),
                             generator)
            cur = torch.where(greedy_slot, g, s)
            if pen_counts is not None:
                counts_run = counts_run + F.one_hot(cur.long(), counts_run.shape[-1]).to(
                    counts_run.dtype)
            draft_toks.append(cur)
            draft_logits.append(logits_d)
        _, cache_d = decode_step(params_d, cfg_d, cache_d, cur, active)
        d = torch.stack(draft_toks, dim=1)  # [B, gamma]
        t_rows = gamma + 1
        t_pad = -(-t_rows // VERIFY_ROWS) * VERIFY_ROWS
        seq = F.pad(torch.cat([tok[:, None], d], dim=1), (0, t_pad - t_rows))
        positions = cache_t.lengths[:, None] + torch.arange(t_pad, device=tok.device)
        logits_t, cache_t = self._forward(params_t, cache_t, seq, positions, row_owned=True)
        out, n_acc, bonus = acceptance_rule(
            d, torch.stack(draft_logits, dim=1), logits_t[:, :t_rows], greedy_slot, tau,
            generator, top_ks, top_ps, min_ps, pen_counts, presences, frequencies)
        n_emit = torch.where(active, n_acc + 1, torch.zeros_like(n_acc)).to(torch.int32)
        cache_t.lengths.copy_(l0_t + n_emit)
        cache_d.lengths.copy_(l0_d + n_emit)
        if pen_counts is not None:
            emitted = torch.arange(t_rows, device=tok.device)[None, :] < n_emit[:, None]
            out_hot = F.one_hot(out.long(), pen_counts.shape[-1])
            pen_counts = pen_counts + (out_hot * emitted[..., None]).sum(dim=1).to(
                pen_counts.dtype)
        return out, n_emit, bonus, cache_t, cache_d, pen_counts


def lead_ranks(mesh: Mesh, batch_axis: str):
    """For each coordinate along ``batch_axis``, the position in the mesh's
    row-major rank order of that dp group's first rank (every other axis at
    0): the rank whose results stand for its group."""
    shape = mesh.shape
    axis = mesh.axis_names.index(batch_axis)
    out = []
    for i in range(shape[axis]):
        coords = [0] * len(shape)
        coords[axis] = i
        out.append(int(np.ravel_multi_index(coords, shape)))
    return out


def share_logits(mesh: Mesh, batch_axis: str, logits: Optional[torch.Tensor], owner: int,
                 vocab: int, device) -> torch.Tensor:
    """The logits ``[V]`` of dp group ``owner``'s first rank on every rank of
    the mesh: one sum over all its axes, the other ranks adding zeros (JAX's
    ``psum`` of the owner's logits over dp).  Every rank then holds the
    same bits, whatever its own group computed."""
    lead = lead_ranks(mesh, batch_axis)[owner] == mesh.rank
    buf = logits.float() if (lead and logits is not None) else torch.zeros(
        (vocab,), dtype=torch.float32, device=device)
    if lead and logits is None:
        raise RuntimeError("the lead rank of the owning dp group computed no logits")
    return all_reduce(buf, mesh, mesh.axis_names)
