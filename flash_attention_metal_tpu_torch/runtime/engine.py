"""Continuous-batching decode engine on one device.

Counterpart of ``flash_attention_metal_tpu/runtime/engine.py`` on one
device, over a dense, 8-bit (``kv_quant``), paged (``paged``, with
``prefix_share``) or rolling (``rolling``: O(window) slots for a
sliding-window model, dense or 8-bit) KV cache: a fixed pool of batch
slots, a FIFO admission queue, per-step retirement, and bookkeeping that
runs ``harvest_lag`` steps behind the device through non-blocking
device-to-host copies, so the host never waits for a step it has just
queued.  Admission and retirement only change per-slot state; the shapes
the device sees never change.

A step queues ``multi_step`` decode + sample steps with no host sync
between them (the tokens stay on the device), or with ``draft=`` one
speculative round (``runtime/speculative.py``).  Tokens decoded past a
request's end (EOS, ``max_new_tokens``, a stop sequence) are discarded at
harvest.  ``snapshot`` / ``restore`` carry the serving state, the
allocator's and the prefix registry's included, through
``utils/checkpoint.py``.

The paged cache's pages are granted and released by a host allocator
(``runtime/paged_kv.py``), with admission control by worst-case page
reservation.  Its bookkeeping reads the host's own count of each slot's
tokens (``_host_len``), never the device's lengths, which would wait for
the device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import ModelConfig, Params, map_params
from . import kv_cache, paged_kv
from .decode import (
    admit_update,
    decode_and_sample,
    decode_and_sample_multi,
    prefill_chunk,
    prefill_slot,
)
from .kv_cache import (
    init_cache,
    init_quant_cache,
    init_rolling_cache,
    init_rolling_quant_cache,
    reset_slot,
)
from .paged_kv import PageAllocator, init_paged_cache, init_paged_quant_cache
from .speculative import speculative_step

# The 8-bit formats of ``kv_quant``: "fp8" is e4m3, as in the JAX engine.
KV_QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0  # <= 0: disabled
    top_p: float = 1.0  # >= 1: disabled
    # OpenAI-style repetition control over GENERATED tokens (prompt
    # tokens are not counted): logits -= presence*(count>0) + freq*count.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    min_p: float = 0.0  # <= 0: disabled (post-temperature min-p filter)
    # Stop sequences: finish (and truncate) when the generation ends with
    # any of these token lists; checked on the host at harvest.
    stop: List[List[int]] = dataclasses.field(default_factory=list)
    # Filled by the engine:
    generated: List[int] = dataclasses.field(default_factory=list)
    # Log-probability of each generated token under the raw softmax.
    logprobs: List[float] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False


def _pad_to(x: List[int], multiple: int) -> np.ndarray:
    n = len(x)
    pad = (-n) % multiple
    return np.asarray(x + [0] * pad, np.int32)


def _prefix_chain_keys(prompt: List[int], page_size: int) -> List[str]:
    """Chained content keys of each full prompt page.

    Key ``i`` digests every token up to the end of page ``i``, not only the
    page's own: a page's KV depends on its whole prefix, so equal keys mean
    the same KV from the same prefill.
    """
    h = hashlib.sha256()
    keys = []
    for i in range(len(prompt) // page_size):
        h.update(np.asarray(prompt[i * page_size : (i + 1) * page_size], np.int64).tobytes())
        keys.append(h.hexdigest())
    return keys


def _fetch_async(*tensors: torch.Tensor):
    """Start copies of device tensors to the host.

    Returns the host tensors and a CUDA event to wait on before reading
    them (None for CPU tensors, which are copied at once).
    """
    if tensors[0].device.type != "cuda":
        return tuple(t.clone() for t in tensors), None
    hosts = tuple(
        torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors
    )
    for host, t in zip(hosts, tensors):
        host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return hosts, done


class DecodeEngine:
    """Continuous batching over a fixed slot pool.

    Usage::

        eng = DecodeEngine(params, cfg, max_batch=8, max_len=2048, eos_id=2)
        eng.submit(Request(uid=1, prompt=[...]))
        while eng.pending():
            finished = eng.step()

    The device is that of ``params``.  ``multi_step``: decode steps a
    ``step()`` queues.  ``draft``: a ``(params, cfg)`` draft model for
    speculative serving, ``spec_gamma`` proposals a round (its cache is
    dense whatever the target's).  ``rolling``: a wrapped cache of
    ``ceil((window + sinks) / 128) * 128 + 128`` slots for a model with
    ``cfg.attn_window``, prefilled in chunks of 128.

    ``mesh`` (a ``parallel.mesh.Mesh``): sharded serving.  Every rank of
    the mesh builds the engine with the same arguments and whole parameter
    tree, submits the same requests in the same order and steps with the
    others; each holds its shards.  The slots split over ``batch_axis``
    (``max_batch`` divides over it); ``seq_axis`` shards the cache's length
    (``max_len`` into 128-aligned shards) and ``head_axis`` the KV heads and
    the Megatron weights (``runtime/sp_decode.py``); with neither, each dp
    rank runs the one-device steps on its slots, in every cache mode but
    ``paged``.  The host scheduler runs on every rank and must decide alike,
    so every rank must see every slot's tokens: a step's tokens are gathered
    over the whole mesh after its dispatch (rather than running the step on
    global slots, which would need every rank to hold every slot's cache),
    and each dp group's are read from its first rank; at harvest the ranks
    of each group are checked to agree, and a disagreement raises.  A
    prefill runs on the dp group that holds the slot, and its logits reach
    every rank in one collective.  Sampling draws from one generator per dp
    group, seeded from ``seed`` and the group's coordinate, so the tp and sp
    ranks of a group draw alike; an admission's first token from a
    generator seeded from ``seed`` alone, the same on every rank.
    ``snapshot``/``restore`` carry each rank's shards and the generators
    (JAX's snapshot holds its global sharded arrays; here a rank restores
    its own, on a mesh of the same shape).
    """

    def __init__(
        self,
        params: Params,
        cfg: ModelConfig,
        *,
        max_batch: int,
        max_len: int,
        eos_id: int = -1,
        seed: int = 0,
        harvest_lag: int = 16,
        multi_step: int = 1,
        draft: Optional[Tuple[Params, ModelConfig]] = None,
        spec_gamma: int = 4,
        kv_quant: Optional[str] = None,
        rolling: bool = False,
        paged: bool = False,
        page_size: int = 128,
        n_pages: Optional[int] = None,
        prefix_share: bool = False,
        mesh=None,
        batch_axis: str = "dp",
        seq_axis: Optional[str] = None,
        head_axis: Optional[str] = None,
    ):
        # The JAX engine's refusals, in its order.
        if multi_step < 1:
            raise ValueError(f"multi_step={multi_step} must be >= 1")
        if draft is not None:
            if multi_step > 1 or rolling:
                raise ValueError(
                    "draft= (speculative serving) composes with the dense, quantized and paged "
                    "caches; rolling caches have no sound O(1) rollback (wrapped slots are "
                    "overwritten) and multi_step is the same dispatch-amortization axis"
                )
            if paged and prefix_share:
                raise NotImplementedError(
                    "draft= with prefix_share=True is not wired (a verify window may not "
                    "overwrite an adopted shared page)"
                )
        # Sequence- and tensor-sharded serving (runtime/sp_decode.py): an
        # axis of size 1 shards nothing.
        sp_size = mesh.size(seq_axis) if (mesh is not None and seq_axis is not None) else 1
        tp_size = mesh.size(head_axis) if (mesh is not None and head_axis is not None) else 1
        self._seq_axis = seq_axis if sp_size > 1 else None
        self._head_axis = head_axis if tp_size > 1 else None
        if (self._seq_axis is not None or self._head_axis is not None) and rolling:
            raise ValueError(
                "rolling caches are dp-only (no contiguous shard ownership under a wrapped "
                "position map)"
            )
        if self._head_axis is not None and cfg.n_kv_heads % tp_size:
            raise ValueError(f"n_kv_heads={cfg.n_kv_heads} must divide over {head_axis}={tp_size}")
        if self._seq_axis is not None and (max_len % sp_size or (max_len // sp_size) % 128):
            raise ValueError(
                f"max_len={max_len} must split into 128-aligned shards over {seq_axis}={sp_size}"
            )
        if paged and rolling:
            raise ValueError(
                "paged=True does not compose with rolling (a wrapped position "
                "map has no stable page ownership)"
            )
        if paged and mesh is not None:
            raise ValueError(
                "paged=True is single-device (a shared physical pool has no "
                "batch dim to shard)"
            )
        dp_size = mesh.size(batch_axis) if mesh is not None else 1
        if max_batch % dp_size:
            raise ValueError(f"max_batch={max_batch} must divide over {batch_axis}={dp_size}")
        if rolling and cfg.attn_window is None:
            raise ValueError("rolling=True requires cfg.attn_window")
        if prefix_share and not paged:
            raise ValueError("prefix_share=True requires paged=True")
        if kv_quant is not None and kv_quant not in KV_QUANT_DTYPES:
            raise ValueError(f"kv_quant={kv_quant!r} must be one of {sorted(KV_QUANT_DTYPES)}")
        self.cfg = cfg
        self.eos_id = eos_id
        self.max_len = max_len
        self._mesh = mesh
        self._batch_axis = batch_axis
        # This rank's slots: [_lo, _lo + _b_loc) of the global pool.
        self._b_loc = max_batch // dp_size
        self._lo = mesh.index(batch_axis) * self._b_loc if mesh is not None else 0
        self._sp = None
        if mesh is not None:
            from .sp_decode import SpStepFns, shard_params

            self.device = mesh.device
            if self._head_axis is not None:
                params = shard_params(params, mesh, self._head_axis)
            else:
                params = map_params(
                    lambda p: p.to(self.device) if torch.is_tensor(p) else p, params)
            if draft is not None:
                draft = (map_params(lambda p: p.to(self.device), draft[0]), draft[1])
            if self._seq_axis is not None or self._head_axis is not None:
                self._sp = SpStepFns(mesh, cfg, batch_axis=batch_axis, seq_axis=self._seq_axis,
                                     head_axis=self._head_axis)
        else:
            self.device = params["embed"].device
        self.params = params
        self._multi_step = multi_step
        self._draft = draft
        self._spec_gamma = spec_gamma
        # Rows a speculative round may write past a slot's length (JAX pads
        # the verify chunk to 8 rows; the page grant and margin keep that).
        self._spec_pad = -(-(spec_gamma + 1) // 8) * 8 if draft is not None else 0
        # Tokens a retired slot may still decode before its retirement
        # lands: harvest runs harvest_lag dispatches behind, and each
        # dispatch emits up to multi_step tokens, or writes up to the
        # padded verify window.
        window = max(multi_step, self._spec_pad if draft is not None else 1)
        self._zombie_margin = harvest_lag * window + window
        shape = (cfg.n_layers, self._b_loc, cfg.n_kv_heads // tp_size, max_len // sp_size,
                 cfg.head_dim)
        qdt = KV_QUANT_DTYPES.get(kv_quant)
        self.kv_quant = kv_quant
        self._paged = paged
        self._allocator: Optional[PageAllocator] = None
        # Tokens each slot will hold once the queued steps land: the host's
        # count, read by the page bookkeeping instead of the device lengths.
        self._host_len = [0] * max_batch
        # Prefill chunk (None: the whole padded prompt at once).
        self._prefill_chunk: Optional[int] = None
        if paged:
            if n_pages is None:
                # No oversubscription (the dense cache's capacity) plus the
                # reserved page 0.
                n_pages = max_batch * (max_len // page_size) + 1
            init = init_paged_quant_cache if qdt else init_paged_cache
            self.cache = init(
                *shape, n_pages=n_pages, page_size=page_size, dtype=qdt or cfg.dtype,
                device=self.device,
            )
            self._allocator = PageAllocator(n_pages, max_batch)
        elif rolling:
            # O(window) slots; prefill in chunks of 128, so every chunk
            # row's window is still resident when the chunk attends.
            cap = -(-(cfg.attn_window + cfg.attn_sinks) // 128) * 128 + 128
            init = init_rolling_quant_cache if qdt else init_rolling_cache
            self.cache = init(*shape[:3], cap, cfg.head_dim, dtype=qdt or cfg.dtype,
                              sinks=cfg.attn_sinks, device=self.device)
            self._prefill_chunk = 128
        elif qdt:
            self.cache = init_quant_cache(*shape, dtype=qdt, device=self.device)
        else:
            self.cache = init_cache(*shape, dtype=cfg.dtype, device=self.device)
        if self._sp is not None:
            # Each prefill chunk lands in one sp shard.
            self._prefill_chunk = min(128, max_len // sp_size)
        self.draft_cache = None
        if draft is not None:
            # The draft's cache is dense and dp-local (whole length and heads).
            dcfg = draft[1]
            self.draft_cache = init_cache(dcfg.n_layers, self._b_loc, dcfg.n_kv_heads, max_len,
                                          dcfg.head_dim, dtype=dcfg.dtype, device=self.device)
        self._prefix_share = prefix_share
        # Retained prefix registry: chain key -> physical page, LRU order.
        # Each entry pins its page so shared prefixes outlive their slots;
        # entries are evicted when admission needs the pages.
        self._prefix_registry: "OrderedDict[str, int]" = OrderedDict()
        self._pages_reserved = 0
        self._pages_adopted = 0
        self.slots: List[Optional[Request]] = [None] * max_batch

        # Device-resident per-slot state: the decode chain never
        # round-trips tokens through the host.
        # Device-resident per-slot state covers this rank's slots only.
        def zeros(dtype):
            return torch.zeros((self._b_loc,), dtype=dtype, device=self.device)

        self.next_token = zeros(torch.int32)
        self.temps = zeros(torch.float32)
        self.top_ks = zeros(torch.int32)
        self.top_ps = torch.ones((self._b_loc,), dtype=torch.float32, device=self.device)
        self.presences = zeros(torch.float32)
        self.frequencies = zeros(torch.float32)
        self.min_ps = zeros(torch.float32)
        self.pen_counts = torch.zeros(
            (self._b_loc, cfg.vocab_size), dtype=torch.int32, device=self.device
        )
        self.queue: deque = deque()
        self.generator = torch.Generator(device=self.device)
        self._admit_generator = self.generator
        if mesh is None:
            self.generator.manual_seed(seed)
        else:
            # One stream per dp group for the steps, and one shared by every
            # rank for the admissions.
            dp_seed = np.random.SeedSequence([seed, mesh.index(batch_axis)])
            self.generator.manual_seed(int(dp_seed.generate_state(1, np.uint64)[0]))
            self._admit_generator = torch.Generator(device=self.device)
            self._admit_generator.manual_seed(seed)
        self.steps = 0
        # Throughput accounting (host wall clock around step()).
        self._step_seconds = 0.0
        self._tokens_emitted = 0
        self.finished: Dict[int, Request] = {}
        # Fetch-behind pipeline: bookkeeping for a step runs harvest_lag
        # steps after it was queued; tokens decoded for a slot whose
        # occupant already retired are discarded.
        self.harvest_lag = max(harvest_lag, 0)
        self._inflight: deque = deque()
        self._active_dev = zeros(torch.bool)
        self._occupancy_dirty = True

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        if len(request.prompt) >= self.max_len:
            raise ValueError("prompt longer than cache capacity")
        self.queue.append(request)

    def pending(self) -> bool:
        return (
            bool(self.queue)
            or any(r is not None for r in self.slots)
            or bool(self._inflight)
        )

    # ------------------------------------------------------------------
    def _reserve_pages(self, slot: int, req: Request, n_padded: int):
        """Admission control of the paged cache, and the pages of ``req``'s
        prompt: reserve its worst-case page footprint (the padded prompt,
        or prompt + generation + the zombie steps' margin), evicting
        registered prefixes (LRU) before refusing; adopt the registered
        pages of its prompt's prefix; grow the slot to the padded prompt.

        Returns the prompt's chain keys ([] without prefix sharing) and the
        tokens of the adopted pages, or None when the pool cannot take the
        request yet.
        """
        alloc, ps = self._allocator, self.cache.page_size
        worst = max(n_padded, len(req.prompt) + req.max_new_tokens + self._zombie_margin + 1)
        need = -(-min(worst, self.max_len) // ps)
        while not alloc.can_reserve(need) and self._prefix_registry:
            _, phys = self._prefix_registry.popitem(last=False)
            alloc.unpin(phys)
        if not alloc.can_reserve(need):
            return None
        alloc.reserve(slot, need)
        self._pages_reserved += need
        keys: List[str] = []
        shared = 0
        if self._prefix_share:
            keys = _prefix_chain_keys(req.prompt, ps)
            # Adopt strictly below the prompt's last token, so the tail
            # prefill always runs (it gives the first token's logits) and
            # decode never writes a shared page.
            for key in keys[: (len(req.prompt) - 1) // ps]:
                phys = self._prefix_registry.get(key)
                if phys is None:
                    break
                self.cache = alloc.adopt(self.cache, slot, phys)
                self._prefix_registry.move_to_end(key)
                shared += ps
            self._pages_adopted += shared // ps
        self.cache = alloc.grow(self.cache, slot, n_padded)
        self._host_len[slot] = len(req.prompt)
        return keys, shared

    def prefill_request(self, slot: int, req: Request) -> Optional[torch.Tensor]:
        """Prefill ``req``'s prompt into the free ``slot`` and return the
        logits of its last token, or None when the page pool cannot take
        the request yet.

        The paged cache first reserves the request's pages and adopts the
        registered pages of its prefix (``_reserve_pages``); adopted pages
        are not prefilled again, and the prompt's full pages are registered
        for later requests.  A speculative engine prefills the draft's cache
        too.  The slot's sampling state is ``_admit``'s.
        """
        padded = _pad_to(req.prompt, 128)
        keys, shared = [], 0
        if self._paged:
            reserved = self._reserve_pages(slot, req, len(padded))
            if reserved is None:
                return None
            keys, shared = reserved
        tokens = torch.from_numpy(padded).to(self.device)
        if self._mesh is not None:
            return self._prefill_sharded(slot, req, tokens)
        if shared:
            # The adopted pages already hold the prefix's KV: prefill only
            # the tail.
            logits, self.cache = prefill_chunk(
                self.params, self.cfg, self.cache, tokens[shared:], shared,
                len(req.prompt), slot,
            )
        else:
            logits, self.cache = prefill_slot(
                self.params, self.cfg, self.cache, tokens, len(req.prompt), slot,
                chunk=self._prefill_chunk,
            )
        if self._draft is not None:
            # The draft must hold the same prompt before it can propose.
            _, self.draft_cache = prefill_slot(
                self._draft[0], self._draft[1], self.draft_cache, tokens, len(req.prompt), slot
            )
        if self._prefix_share:
            # Register the prompt's full pages (adopted ones already are).
            owned = self._allocator._owned[slot]
            for i, key in enumerate(keys[: len(req.prompt) // self.cache.page_size]):
                if key not in self._prefix_registry:
                    self._allocator.pin(owned[i])
                    self._prefix_registry[key] = owned[i]
        return logits

    def _local(self, slot: int) -> Optional[int]:
        """``slot``'s index among this rank's slots, or None when another
        dp group holds it (always the slot itself without a mesh)."""
        local = slot - self._lo
        return local if 0 <= local < self._b_loc else None

    def _prefill_sharded(self, slot: int, req: Request, tokens: torch.Tensor) -> torch.Tensor:
        """A mesh's prefill of global ``slot``: the ranks of the dp group
        holding it prefill (``SpStepFns.prefill_slot`` under sp or tp, the
        one-device ``prefill_slot`` on a dp-only mesh), the draft's cache
        too; every rank receives the logits."""
        from .sp_decode import share_logits

        local = self._local(slot)
        if self._sp is not None:
            logits, self.cache = self._sp.prefill_slot(
                self.params, self.cache, tokens, len(req.prompt), slot, chunk=self._prefill_chunk)
        else:
            logits = None
            if local is not None:
                logits, self.cache = prefill_slot(
                    self.params, self.cfg, self.cache, tokens, len(req.prompt), local,
                    chunk=self._prefill_chunk)
            logits = share_logits(self._mesh, self._batch_axis, logits, slot // self._b_loc,
                                  self.cfg.vocab_size, self.device)
        if self._draft is not None and local is not None:
            _, self.draft_cache = prefill_slot(
                self._draft[0], self._draft[1], self.draft_cache, tokens, len(req.prompt), local)
        return logits

    def grow_for_decode(self, slots, n: int = 1) -> None:
        """Grant each of ``slots`` the pages of the ``n`` tokens its next
        dispatch appends (paged cache), from the host's count of its
        tokens.  A speculative round's count runs ahead of the true length
        by up to its padded verify window a round; harvest sets it back to
        the true length plus a window for each round still in flight."""
        if not self._paged:
            return
        for slot in slots:
            self.cache = self._allocator.grow(
                self.cache, slot, min(self._host_len[slot] + n, self.max_len)
            )
            self._host_len[slot] += n

    def _admit(self) -> None:
        """Prefill queued requests into free slots."""
        for slot, occupant in enumerate(self.slots):
            if occupant is not None or not self.queue:
                continue
            req = self.queue.popleft()
            logits = self.prefill_request(slot, req)
            if logits is None:
                # The pool is full: wait for retirements.
                self.queue.appendleft(req)
                break
            tok, logp = admit_update(
                logits, self._admit_generator, self._local(slot), req.temperature, req.top_k,
                req.top_p, req.min_p, req.presence_penalty,
                req.frequency_penalty, self.next_token, self.temps,
                self.top_ks, self.top_ps, self.presences, self.frequencies,
                self.min_ps, self.pen_counts,
            )
            # The first token reaches the host through the same lagged
            # pipeline as decode tokens, in queue order.
            hosts, done = _fetch_async(tok, logp)
            self._inflight.append(("admit", hosts, done, req))
            req.slot = slot
            self.slots[slot] = req
            self._occupancy_dirty = True

    def _maybe_finish(self, req: Request) -> None:
        hit_stop = False
        for seq in req.stop:
            n = len(seq)
            if n and len(req.generated) >= n and req.generated[-n:] == list(seq):
                # Truncate the stop sequence itself (vLLM convention);
                # logprobs stay aligned with the surviving tokens.
                del req.generated[-n:]
                del req.logprobs[len(req.generated):]
                hit_stop = True
                break
        hit_eos = req.generated and req.generated[-1] == self.eos_id
        # The margin covers the zombie steps that may still advance this
        # slot's write head before its retirement lands.
        full = (
            len(req.prompt) + len(req.generated)
            >= self.max_len - 1 - self._zombie_margin
        )
        if hit_stop or hit_eos or len(req.generated) >= req.max_new_tokens or full:
            req.done = True
            self.slots[req.slot] = None
            self._occupancy_dirty = True
            if self._paged:
                # The zeroed table row sends the zombie steps' writes to
                # page 0, so the freed pages are safe to grant at once.
                self.cache = self._allocator.release(self.cache, req.slot)
                self._host_len[req.slot] = 0
            elif self._local(req.slot) is not None:
                self.cache = reset_slot(self.cache, self._local(req.slot))
            if self.draft_cache is not None and self._local(req.slot) is not None:
                self.draft_cache = reset_slot(self.draft_cache, self._local(req.slot))
            self.finished[req.uid] = req

    # ------------------------------------------------------------------
    def _harvest_one(self) -> List[Request]:
        """Apply bookkeeping for the oldest in-flight step."""
        entry = self._inflight.popleft()
        finished: List[Request] = []
        if entry[0] == "admit":
            _, (tok, logp), done, req = entry
            if done is not None:
                done.synchronize()
            req.generated.append(int(tok))
            if self._draft is None:  # the speculative path keeps no logprobs
                req.logprobs.append(float(logp))
            self._maybe_finish(req)
            if req.done:
                finished.append(req)
            return finished
        kind, (toks, lps), done, uids = entry
        if done is not None:
            done.synchronize()
        if self._mesh is not None:
            dim = 0 if kind == "spec" else 1
            # A spec entry's second tensor is n_emit: the host reads both.
            toks = self._lockstep(toks, dim, check=True)
            lps = self._lockstep(lps, dim, check=kind == "spec")
        toks, lps = toks.tolist(), lps.tolist()
        if kind == "spec":  # one round: out [B, gamma + 1], n_emit [B]
            for slot, uid in enumerate(uids):
                req = self.slots[slot]
                if uid is None or req is None or req.uid != uid or req.done:
                    continue
                for tok in toks[slot][: lps[slot]]:
                    req.generated.append(tok)
                    self._maybe_finish(req)
                    if req.done:
                        break
                if self._paged and not req.done:
                    # Back to the true length, plus a whole verify window
                    # for each of this slot's rounds still in flight: the
                    # device is up to that far ahead of the harvested round.
                    ahead = sum(e[0] == "spec" and e[3][slot] == uid for e in self._inflight)
                    self._host_len[slot] = (len(req.prompt) + len(req.generated)
                                            + ahead * self._spec_pad)
                if req.done:
                    finished.append(req)
            return finished
        # multi_step rows [S, B] (one row for a single step).
        for row, lrow in zip(toks, lps):
            for slot, uid in enumerate(uids):
                req = self.slots[slot]
                if uid is None or req is None or req.uid != uid or req.done:
                    continue  # retired, reused, or stopped earlier in the window
                req.generated.append(row[slot])
                req.logprobs.append(lrow[slot])
                self._maybe_finish(req)
                if req.done:
                    finished.append(req)
        return finished

    def step(self) -> List[Request]:
        """Admit, queue ``multi_step`` decode steps (or one speculative
        round), and harvest lagged bookkeeping."""
        t0 = time.perf_counter()
        self._admit()
        active_reqs = [r for r in self.slots if r is not None]
        if active_reqs:
            if self._occupancy_dirty:
                # Host-to-device occupancy copy only when it changed.
                mine = self.slots[self._lo:self._lo + self._b_loc]
                self._active_dev = torch.tensor(
                    [r is not None for r in mine], dtype=torch.bool
                ).to(self.device)
                self._occupancy_dirty = False
            self.grow_for_decode((s for s, r in enumerate(self.slots) if r is not None),
                                 self._spec_pad if self._draft is not None else self._multi_step)
            sampling = (self.generator, self.temps, self.top_ks, self.top_ps)
            penalties = (self.pen_counts, self.presences, self.frequencies)
            if self._sp is not None and self._draft is not None:
                out, n_emit, self.next_token, self.cache, self.draft_cache, self.pen_counts = (
                    self._sp.speculative_step(
                        self.params, self.cache, self._draft[0], self.draft_cache,
                        self.next_token, self._active_dev, *sampling, self.min_ps, *penalties,
                        cfg_d=self._draft[1], gamma=self._spec_gamma,
                    ))
                kind, fetched = "spec", (out, n_emit)
            elif self._sp is not None and self._multi_step > 1:
                toks, lps, self.cache, self.pen_counts = self._sp.decode_and_sample_multi(
                    self.params, self.cache, self.next_token, self._active_dev, *sampling,
                    *penalties, self.min_ps, n_steps=self._multi_step,
                )
                self.next_token = toks[-1]
                kind, fetched = "decode", (toks, lps)
            elif self._sp is not None:
                toks, lps, self.cache, self.pen_counts = self._sp.decode_and_sample(
                    self.params, self.cache, self.next_token, self._active_dev, *sampling,
                    *penalties, self.min_ps,
                )
                self.next_token = toks
                kind, fetched = "decode", (toks[None], lps[None])
            elif self._draft is not None:
                out, n_emit, self.next_token, self.cache, self.draft_cache, self.pen_counts = (
                    speculative_step(
                        self.params, self.cfg, self.cache, self._draft[0], self._draft[1],
                        self.draft_cache, self.next_token, self._active_dev, *sampling,
                        self.min_ps, *penalties, gamma=self._spec_gamma,
                    ))
                kind, fetched = "spec", (out, n_emit)
            elif self._multi_step > 1:
                toks, lps, self.cache, self.pen_counts = decode_and_sample_multi(
                    self.params, self.cfg, self.cache, self.next_token, self._active_dev,
                    *sampling, *penalties, self.min_ps, n_steps=self._multi_step,
                )
                self.next_token = toks[-1]
                kind, fetched = "decode", (toks, lps)
            else:
                toks, lps, self.cache, self.pen_counts = decode_and_sample(
                    self.params, self.cfg, self.cache, self.next_token, self._active_dev,
                    *sampling, *penalties, self.min_ps,
                )
                self.next_token = toks
                kind, fetched = "decode", (toks[None], lps[None])
            if self._mesh is not None:
                # Every rank's host needs every slot's tokens.
                fetched = tuple(self._gather_slots(x, 0 if kind == "spec" else 1)
                                for x in fetched)
            hosts, done = _fetch_async(*fetched)
            self._inflight.append(
                (kind, hosts, done, [r.uid if r else None for r in self.slots])
            )
            self.steps += 1 if self._draft is not None else self._multi_step

        finished: List[Request] = []
        while self._inflight and (
            len(self._inflight) > self.harvest_lag or not active_reqs
        ):
            finished.extend(self._harvest_one())
        self._step_seconds += time.perf_counter() - t0
        self._tokens_emitted = sum(
            len(r.generated) for r in self.finished.values()
        ) + sum(len(r.generated) for r in self.slots if r is not None)
        return finished

    def _gather_slots(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of ``x`` (this rank's slots on ``dim``),
        concatenated on ``dim`` in the mesh's rank order (``_lockstep``
        reads it)."""
        from ..parallel.comm import all_gather

        return all_gather(x.contiguous(), self._mesh, self._mesh.axis_names, dim)

    def _lockstep(self, x: torch.Tensor, dim: int, check: bool = False) -> torch.Tensor:
        """The global slots of a gathered step output (``_gather_slots``):
        each dp group's block from its first rank.  With ``check``, every
        rank of a group must have the same block; a disagreement would set
        the ranks' schedulers apart, so it raises."""
        mesh = self._mesh
        blocks = x.chunk(int(np.prod(mesh.shape)), dim)
        grid = np.arange(len(blocks)).reshape(mesh.shape)
        axis = mesh.axis_names.index(self._batch_axis)
        out = []
        for i in range(mesh.shape[axis]):
            group = np.take(grid, i, axis=axis).ravel()
            lead = blocks[int(group[0])]
            if check and not all(torch.equal(lead, blocks[int(r)]) for r in group[1:]):
                raise RuntimeError(f"the ranks of {self._batch_axis} group {i} sampled different "
                                   "tokens: the mesh's ranks are out of step")
            out.append(lead)
        return torch.cat(out, dim)

    def stats(self) -> Dict[str, float]:
        """Serving throughput counters (host wall clock).

        ``tokens``: emitted so far (finished + in flight);
        ``tokens_per_s``: tokens / cumulative step() seconds;
        ``ms_per_step``: mean step cadence;
        ``pages_reserved``, ``pages_adopted``: pages of the paged cache
        reserved at admission (each request's worst case) and adopted from
        the prefix registry, summed over admissions (0 without paging).
        """
        steps = max(self.steps, 1)
        secs = max(self._step_seconds, 1e-9)
        return {
            "steps": float(self.steps),
            "seconds": self._step_seconds,
            "tokens": float(self._tokens_emitted),
            "tokens_per_s": self._tokens_emitted / secs,
            "ms_per_step": 1e3 * self._step_seconds / steps,
            "pages_reserved": float(self._pages_reserved),
            "pages_adopted": float(self._pages_adopted),
        }

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns {uid: generated tokens}."""
        while self.pending():
            self.step()
        return {uid: r.generated for uid, r in self.finished.items()}

    # ------------------------------------------------------------------
    # Crash/restart recovery: the serving state as tensors and plain
    # metadata, which round-trip through utils/checkpoint.py.
    _STATE = ("next_token", "temps", "top_ks", "top_ps", "presences", "frequencies",
              "min_ps", "pen_counts")
    _REQUEST_FIELDS = ("uid", "prompt", "max_new_tokens", "temperature", "top_k", "top_p",
                       "presence_penalty", "frequency_penalty", "min_p", "stop")

    def snapshot(self) -> dict:
        """A consistent copy of the serving state that leaves the run as it
        was: the lagged bookkeeping still in flight is copied once its
        tokens reach the host, not applied (the JAX engine applies it
        first, which retires slots and admits queued requests earlier than
        an uninterrupted run would), and every device tensor is copied (the
        engine keeps updating its own in place).  So the engine that goes
        on and one restored from the copy both run exactly as an
        uninterrupted engine.  The generator's state stands in for the JAX
        engine's key; the paged allocator's state and the prefix registry
        are included.  The dict holds tensors, numbers, strings and lists
        only, so ``utils.checkpoint.save_pytree`` writes it."""
        inflight = []
        for kind, hosts, done, who in self._inflight:
            if done is not None:
                done.synchronize()
            entry = {"kind": kind, "values": [h.clone() for h in hosts]}
            if kind == "admit":
                # Its request holds the slot until this entry is harvested.
                entry["slot"] = who.slot
            else:
                entry["uids"] = list(who)
            inflight.append(entry)
        paged_state = None
        if self._paged:
            alloc = self._allocator
            paged_state = {
                "owned": [list(x) for x in alloc._owned],
                "reserved": list(alloc._reserved),
                "refs": list(alloc._refs),
                "free": list(alloc._free),
                "registry": [[k, v] for k, v in self._prefix_registry.items()],
                "host_len": list(self._host_len),
            }

        def request(r: Request, live: bool) -> dict:
            meta = {name: getattr(r, name) for name in self._REQUEST_FIELDS}
            meta["prompt"] = list(r.prompt)
            meta["stop"] = [list(x) for x in r.stop]
            if live:
                meta.update(generated=list(r.generated), logprobs=list(r.logprobs), slot=r.slot)
            return meta

        return {
            "paged": paged_state,
            "cache": _cache_state(self.cache),
            "draft_cache": None if self.draft_cache is None else _cache_state(self.draft_cache),
            **{name: getattr(self, name).clone() for name in self._STATE},
            "generator": self.generator.get_state(),
            "admit_generator": (None if self._admit_generator is self.generator
                                else self._admit_generator.get_state()),
            "steps": self.steps,
            "slots": [None if r is None else request(r, True) for r in self.slots],
            "queue": [request(r, False) for r in self.queue],
            "inflight": inflight,
        }

    def restore(self, snap: dict) -> None:
        """Resume from a ``snapshot()`` (after a crash or a restart), in an
        engine built with the same options."""
        self.cache = _cache_from_state(snap["cache"], self.device)
        if self.draft_cache is not None and snap.get("draft_cache") is not None:
            self.draft_cache = _cache_from_state(snap["draft_cache"], self.device)
        for name in self._STATE:
            setattr(self, name, snap[name].to(self.device).clone())
        self.generator.set_state(snap["generator"].cpu())
        if snap.get("admit_generator") is not None:
            self._admit_generator.set_state(snap["admit_generator"].cpu())
        self.steps = int(snap["steps"])

        def request(meta: dict) -> Request:
            req = Request(**{name: meta[name] for name in self._REQUEST_FIELDS})
            req.prompt = list(req.prompt)
            req.stop = [list(x) for x in req.stop]
            if "generated" in meta:
                req.generated = list(meta["generated"])
                req.logprobs = list(meta["logprobs"])
                req.slot = meta["slot"]
            return req

        self.slots = [None if meta is None else request(meta) for meta in snap["slots"]]
        self.queue = deque(request(meta) for meta in snap["queue"])
        self._inflight = deque(
            (e["kind"], tuple(v.cpu() for v in e["values"]), None,
             self.slots[e["slot"]] if e["kind"] == "admit" else list(e["uids"]))
            for e in snap["inflight"])
        self._occupancy_dirty = True
        if self._paged and snap.get("paged") is not None:
            meta = snap["paged"]
            alloc = self._allocator
            alloc._owned = [list(x) for x in meta["owned"]]
            alloc._reserved = list(meta["reserved"])
            alloc._refs = list(meta["refs"])
            alloc._free = list(meta["free"])
            alloc._committed = sum(alloc._reserved)
            alloc._pinned = len(meta["registry"])
            self._prefix_registry = OrderedDict((k, int(v)) for k, v in meta["registry"])
            self._host_len = list(meta["host_len"])


# The cache classes a snapshot names.
_CACHE_TYPES = {cls.__name__: cls for cls in (
    kv_cache.KVCache, kv_cache.QuantKVCache, kv_cache.RollingKVCache,
    kv_cache.RollingQuantKVCache, paged_kv.PagedKVCache, paged_kv.PagedQuantKVCache)}


def _cache_state(cache) -> dict:
    """A cache as a dict of copied tensors (and a rolling cache's sinks)."""
    fields = {}
    for f in dataclasses.fields(cache):
        val = getattr(cache, f.name)
        fields[f.name] = val.clone() if torch.is_tensor(val) else val
    return {"type": type(cache).__name__, "fields": fields}


def _cache_from_state(state: dict, device):
    fields = {name: val.to(device).clone() if torch.is_tensor(val) else val
              for name, val in state["fields"].items()}
    return _CACHE_TYPES[state["type"]](**fields)
