"""Continuous-batching decode engine on one device.

Counterpart of ``flash_attention_metal_tpu/runtime/engine.py`` on its dense
single-device path: a fixed pool of batch slots, a FIFO admission queue,
per-step retirement, and bookkeeping that runs ``harvest_lag`` steps
behind the device through non-blocking device-to-host copies, so the host
never waits for a step it has just queued.  Admission and retirement only
change per-slot state; the shapes the device sees never change.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.transformer import ModelConfig, Params
from .decode import admit_update, decode_and_sample, prefill_slot
from .kv_cache import init_cache, reset_slot


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

    The device is that of ``params``.
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
        draft=None,
        kv_quant: Optional[str] = None,
        rolling: bool = False,
        paged: bool = False,
        mesh=None,
    ):
        unported = {
            "multi_step > 1": multi_step > 1,
            "draft (speculative serving)": draft is not None,
            "kv_quant": kv_quant is not None,
            "rolling": rolling,
            "paged": paged,
            "mesh": mesh is not None,
        }
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"DecodeEngine options {asked} are not ported to the PyTorch "
                "package yet (see ROADMAP.md, Queue A item 6)"
            )
        if multi_step < 1:
            raise ValueError(f"multi_step={multi_step} must be >= 1")
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.max_len = max_len
        self.device = params["embed"].device
        # Tokens a retired slot may still decode before its retirement
        # lands (harvest runs harvest_lag steps behind the device).
        self._zombie_margin = harvest_lag + 1
        self.cache = init_cache(
            cfg.n_layers, max_batch, cfg.n_kv_heads, max_len, cfg.head_dim,
            dtype=cfg.dtype, device=self.device,
        )
        self.slots: List[Optional[Request]] = [None] * max_batch

        # Device-resident per-slot state: the decode chain never
        # round-trips tokens through the host.
        def zeros(dtype):
            return torch.zeros((max_batch,), dtype=dtype, device=self.device)

        self.next_token = zeros(torch.int32)
        self.temps = zeros(torch.float32)
        self.top_ks = zeros(torch.int32)
        self.top_ps = torch.ones((max_batch,), dtype=torch.float32, device=self.device)
        self.presences = zeros(torch.float32)
        self.frequencies = zeros(torch.float32)
        self.min_ps = zeros(torch.float32)
        self.pen_counts = torch.zeros(
            (max_batch, cfg.vocab_size), dtype=torch.int32, device=self.device
        )
        self.queue: deque = deque()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
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
    def _admit(self) -> None:
        """Prefill queued requests into free slots."""
        for slot, occupant in enumerate(self.slots):
            if occupant is not None or not self.queue:
                continue
            req = self.queue.popleft()
            tokens = torch.from_numpy(_pad_to(req.prompt, 128)).to(self.device)
            logits, self.cache = prefill_slot(
                self.params, self.cfg, self.cache, tokens, len(req.prompt), slot
            )
            tok, logp = admit_update(
                logits, self.generator, slot, req.temperature, req.top_k,
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
            self.cache = reset_slot(self.cache, req.slot)
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
            req.logprobs.append(float(logp))
            self._maybe_finish(req)
            if req.done:
                finished.append(req)
            return finished
        (toks, lps), done, uids = entry
        if done is not None:
            done.synchronize()
        toks, lps = toks.tolist(), lps.tolist()
        for slot, uid in enumerate(uids):
            req = self.slots[slot]
            if uid is None or req is None or req.uid != uid or req.done:
                continue  # retired or reused since this step was queued
            req.generated.append(toks[slot])
            req.logprobs.append(lps[slot])
            self._maybe_finish(req)
            if req.done:
                finished.append(req)
        return finished

    def step(self) -> List[Request]:
        """Admit, queue one decode step, and harvest lagged bookkeeping."""
        t0 = time.perf_counter()
        self._admit()
        active_reqs = [r for r in self.slots if r is not None]
        if active_reqs:
            if self._occupancy_dirty:
                # Host-to-device occupancy copy only when it changed.
                self._active_dev = torch.tensor(
                    [r is not None for r in self.slots], dtype=torch.bool
                ).to(self.device)
                self._occupancy_dirty = False
            toks, lps, self.cache, self.pen_counts = decode_and_sample(
                self.params, self.cfg, self.cache, self.next_token,
                self._active_dev, self.generator, self.temps, self.top_ks,
                self.top_ps, self.pen_counts, self.presences,
                self.frequencies, self.min_ps,
            )
            self.next_token = toks
            hosts, done = _fetch_async(toks, lps)
            self._inflight.append(
                (hosts, done, [r.uid if r else None for r in self.slots])
            )
            self.steps += 1

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

    def stats(self) -> Dict[str, float]:
        """Serving throughput counters (host wall clock).

        ``tokens``: emitted so far (finished + in flight);
        ``tokens_per_s``: tokens / cumulative step() seconds;
        ``ms_per_step``: mean step cadence.
        """
        steps = max(self.steps, 1)
        secs = max(self._step_seconds, 1e-9)
        return {
            "steps": float(self.steps),
            "seconds": self._step_seconds,
            "tokens": float(self._tokens_emitted),
            "tokens_per_s": self._tokens_emitted / secs,
            "ms_per_step": 1e3 * self._step_seconds / steps,
        }

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns {uid: generated tokens}."""
        while self.pending():
            self.step()
        return {uid: r.generated for uid, r in self.finished.items()}
