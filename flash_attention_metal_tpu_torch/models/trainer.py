"""Training loop: AdamW, LR schedule, gradient accumulation, checkpoint/resume.

Counterpart of ``flash_attention_metal_tpu/models/trainer.py``.  The JAX
trainer chains optax's ``clip_by_global_norm`` and ``adamw`` over a
warmup-cosine schedule; ``AdamW`` here writes the same arithmetic out, so
the two agree step by step (``tests/test_torch_train.py``):

* the schedule's count starts at 0, so with ``init_value`` 0 the first
  update has lr 0; Adam's bias correction counts from 1;
* the clip scales by ``max / norm`` only when ``norm >= max`` (no epsilon);
* weight decay applies to every leaf, norms and embedding included;
* ``eps`` is added outside the square root.

Parameters, moments and the EMA are updated in place (PyTorch tensors are
mutable; JAX builds new arrays), which keeps one copy of each in memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from ..utils.checkpoint import restore_pytree, save_pytree
from .transformer import (
    ModelConfig,
    Params,
    init_params,
    loss_fn,
    map_params,
    param_leaves,
    value_and_grad,
)


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float,
) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine down to
    ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return (init_value - peak_value) * (1.0 - count / warmup_steps) + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


# Adam's epsilon, added outside the square root (optax's default).
EPS = 1e-8


class AdamW:
    """Global-norm clipping, then AdamW with a scheduled learning rate.

    State: ``{"count": updates so far, "mu": first moments, "nu": second
    moments}``, moments shaped like the parameters.
    """

    def __init__(
        self,
        schedule: Callable[[int], float],
        *,
        b1: float,
        b2: float,
        weight_decay: float,
        grad_clip: float,
    ):
        self.schedule = schedule
        self.b1, self.b2 = b1, b2
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        return {"count": 0, "mu": map_params(zeros, params), "nu": map_params(zeros, params)}

    @torch.no_grad()
    def update(self, grads: Params, state: Dict[str, Any], params: Params,
               norm: Optional[torch.Tensor] = None) -> None:
        """Apply one update to ``params`` and ``state``, in place.  ``norm``:
        the gradient's global norm for the clip, when ``grads`` holds only a
        shard of it (``parallel_train.global_grad_norm``); by default the
        norm of ``grads``."""
        leaves = param_leaves(grads)
        if norm is None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
        lr = self.schedule(state["count"])
        count = state["count"] + 1
        c1 = 1.0 - self.b1**count
        c2 = 1.0 - self.b2**count
        for p, g, mu, nu in zip(
            param_leaves(params), leaves, param_leaves(state["mu"]), param_leaves(state["nu"])
        ):
            g = torch.where(norm < self.grad_clip, g, (g / norm) * self.grad_clip)
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + EPS) + self.weight_decay * p
            p.add_(u * -lr)
        state["count"] = count


def make_optimizer(
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> AdamW:
    """AdamW + linear warmup + cosine decay + global-norm clipping."""
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=peak_lr,
        warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1),
        end_value=peak_lr * 0.1,
    )
    return AdamW(schedule, b1=b1, b2=b2, weight_decay=weight_decay, grad_clip=grad_clip)


def constant_adamw(lr: float, *, b1: float = 0.9, b2: float = 0.999, weight_decay: float = 1e-4,
                   grad_clip: float = math.inf) -> AdamW:
    """optax's ``adamw(lr)`` with its defaults (b1 0.9, b2 0.999, weight
    decay 1e-4), a constant learning rate and, unless ``grad_clip`` is
    given, no clip (``clip_by_global_norm(grad_clip)`` before it)."""
    return AdamW(lambda count: lr, b1=b1, b2=b2, weight_decay=weight_decay, grad_clip=grad_clip)


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: Dict[str, Any]
    step: int
    generator: torch.Generator


class Trainer:
    """Single-device trainer over the FlashLM loss, with durable
    checkpoint/resume.  The sharded steps are functions of a mesh: dp x tp
    x sp in ``models/parallel_train.py``, the pipeline axis in
    ``models/pipeline.py`` and expert parallelism in ``models/moe.py``."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        optimizer: Optional[AdamW] = None,
        seed: int = 0,
        grad_accum: int = 1,
        loss: Optional[Callable] = None,
        ema_decay: float = 0.0,
        device="cuda",
    ):
        """``grad_accum > 1`` splits each ``step()`` batch into that many
        microbatches and sums their gradients: one optimizer step per call
        at the activation memory of one microbatch.

        ``loss``: a loss with ``loss_fn``'s signature ``(params, tokens,
        cfg)``, e.g. ``functools.partial(losses.loss_fn_blockwise, ...)``;
        with ``cfg.attn_dropout > 0`` it also takes ``dropout_seeds`` fourth.

        With ``cfg.attn_dropout > 0`` every step draws fresh per-layer
        dropout seeds from the trainer's generator, on its device (no host
        sync), one row per microbatch (JAX ``trainer.py:99-125`` draws a
        key per step and splits it per microbatch): the generator's state
        is saved with the checkpoint, so a resumed run draws the same.

        ``ema_decay > 0`` keeps an exponential moving average of the
        parameters (``ema = d*ema + (1-d)*p``, ``d_t = min(d, (1+t)/(10+t))``)
        in ``self.ema_params``.

        The fp32 master parameters are drawn from ``seed`` on ``device``
        (the card by default; CPU runs pass ``device="cpu"``).
        """
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if ema_decay and not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        self.cfg = cfg
        self.opt = optimizer if optimizer is not None else make_optimizer()
        self.grad_accum = grad_accum
        self.loss = loss if loss is not None else loss_fn
        self.ema_decay = ema_decay
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        params = init_params(cfg, generator, master_dtype=torch.float32)
        self.state = TrainState(
            params=params, opt_state=self.opt.init(params), step=0, generator=generator
        )
        self.ema_params = (
            map_params(torch.clone, params) if ema_decay else None
        )

    def dropout_seeds(self, n: int) -> Optional[torch.Tensor]:
        """Fresh int32 ``[n, n_layers]`` dropout seeds in ``[0, 2^31 - 1)``
        (JAX's ``randint`` range) from the trainer's generator on its device,
        a row per microbatch; None without ``cfg.attn_dropout``."""
        if not self.cfg.attn_dropout > 0.0:
            return None
        gen = self.state.generator
        return torch.randint(0, 2**31 - 1, (n, self.cfg.n_layers), generator=gen,
                             device=gen.device, dtype=torch.int32)

    def _grads(self, tokens: torch.Tensor):
        params, cfg = self.state.params, self.cfg
        seeds = self.dropout_seeds(self.grad_accum)

        def extra(i):  # the loss's dropout seeds, only when dropout is on
            return () if seeds is None else (seeds[i],)

        if self.grad_accum == 1:
            return value_and_grad(self.loss, params, tokens, cfg, *extra(0))
        b = tokens.shape[0]
        if b % self.grad_accum:
            raise ValueError(f"batch {b} not divisible by grad_accum {self.grad_accum}")
        g_sum, l_sum = None, torch.zeros((), device=tokens.device)
        for i, micro in enumerate(tokens.reshape(self.grad_accum, b // self.grad_accum, -1)):
            loss, g = value_and_grad(self.loss, params, micro, cfg, *extra(i))
            g_sum = g if g_sum is None else map_params(torch.add, g_sum, g)
            l_sum = l_sum + loss
        inv = 1.0 / self.grad_accum
        return l_sum * inv, map_params(lambda g: g * inv, g_sum)

    def step(self, tokens: torch.Tensor) -> float:
        """One optimizer step on a ``[B, N]`` token batch; returns the loss."""
        loss, grads = self._grads(tokens)
        self.opt.update(grads, self.state.opt_state, self.state.params)
        self.state.step += 1
        if self.ema_params is not None:
            t = self.state.step
            d = min(self.ema_decay, (1.0 + t) / (10.0 + t))
            with torch.no_grad():
                for e, p in zip(param_leaves(self.ema_params), param_leaves(self.state.params)):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        return float(loss)

    def train(
        self,
        batches: Iterator[torch.Tensor],
        *,
        steps: int,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        log_every: int = 0,
        log: Callable[[str], None] = print,
    ) -> Dict[str, Any]:
        """Drive ``steps`` optimizer steps; optionally checkpoint and log."""
        losses = []
        for _ in range(steps):
            loss = self.step(next(batches))
            losses.append(loss)
            n = self.state.step
            if log_every and n % log_every == 0:
                log(f"step {n}: loss {loss:.4f}")
            if checkpoint_path and checkpoint_every and n % checkpoint_every == 0:
                self.save(checkpoint_path)
        return {"losses": losses, "final_step": self.state.step}

    def save(self, path: str) -> None:
        """Params, optimizer state, step, generator state (and EMA) to the
        file ``path``."""
        snap = {
            "params": self.state.params,
            "opt_state": self.state.opt_state,
            "step": self.state.step,
            "generator": self.state.generator.get_state(),
        }
        if self.ema_params is not None:
            snap["ema_params"] = self.ema_params
        save_pytree(path, snap)

    def load(self, path: str) -> None:
        """Restore what ``save`` wrote: the run continues bit-exactly."""
        snap = restore_pytree(path)
        if (self.ema_params is None) != ("ema_params" not in snap):
            raise ValueError("the checkpoint's EMA does not match this trainer's ema_decay")
        self.state.generator.set_state(snap["generator"])
        self.state = TrainState(
            params=snap["params"], opt_state=snap["opt_state"], step=int(snap["step"]),
            generator=self.state.generator,
        )
        self.ema_params = snap.get("ema_params")


def synthetic_batches(
    cfg: ModelConfig, batch: int, seq: int, seed: int = 0, device="cuda"
) -> Iterator[torch.Tensor]:
    """Deterministic synthetic token stream (for tests and benchmarks), on
    ``device`` (the card by default)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    while True:
        yield torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device)
