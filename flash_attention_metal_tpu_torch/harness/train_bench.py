"""Training-step benchmark: FlashLM step time, tokens/s and MFU on one card.

Counterpart of ``flash_attention_metal_tpu/harness/train_bench.py``.  It
times the whole training path the kernels serve (forward with remat, the
backward kernels, the optimizer update) and reports model FLOPs utilisation
against the card's dense bf16 peak (``utils/roofline.py``).  Its defaults
are the width ``train_bench.json`` records: L8, d_model 2048, 16/8 heads,
d_ff 4096, vocab 32768, batch 4, seq 2048.

    python -m flash_attention_metal_tpu_torch.harness.train_bench [--sgd]

prints one JSON line.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models.trainer import Trainer, make_optimizer
from ..models.transformer import ModelConfig, init_params, sgd_train_step
from ..utils.roofline import detect_chip
from .serving import nvidia_smi_line

SEED = 0


def model_flops_per_token(cfg: ModelConfig, seq: int) -> float:
    """Standard 6N + attention FLOPs-per-token model (training = fwd+bwd).

    6 FLOPs per matmul weight per token (2 fwd + 4 bwd), plus causal
    attention score/value matmuls: 4*H*hd*seq/2 per token forward and
    2.5x that backward -> 7*H*hd*seq per layer per token.  Remat's second
    forward is not counted (model FLOPs, not hardware FLOPs).
    """
    d, v = cfg.d_model, cfg.vocab_size
    hd = cfg.head_dim
    per_layer_params = (
        d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)  # q, k, v projections
        + cfg.n_heads * hd * d  # out projection
        + 3 * d * cfg.d_ff  # swiglu mlp (w1, w3, w2)
    )
    matmul_params = cfg.n_layers * per_layer_params + v * d  # + lm_head
    dense = 6 * matmul_params
    attn = 7 * cfg.n_layers * cfg.n_heads * hd * seq
    return dense + attn


def flashlm_config(
    *,
    n_layers: int = 8,
    d_model: int = 2048,
    n_heads: int = 16,
    n_kv_heads: int = 8,
    d_ff: int = 4096,
    vocab: int = 32768,
    seq: int = 2048,
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi: bool = False,
    attn_dropout: float = 0.0,
) -> ModelConfig:
    """The trained FlashLM: bf16 compute, head_dim 64; defaults are the
    ``train_bench.json`` width.  ``window``, ``sinks``: the sliding window
    of every attention call (``ModelConfig.attn_window``, ``attn_sinks``);
    ``softcap``, ``alibi``: its score transforms (``attn_softcap``,
    ``attn_alibi``); ``attn_dropout``: its attention dropout rate."""
    return ModelConfig(
        vocab_size=vocab, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv_heads, head_dim=64, d_ff=d_ff, max_seq_len=seq,
        dtype=torch.bfloat16, attn_window=window, attn_sinks=sinks, attn_softcap=softcap,
        attn_alibi=alibi, attn_dropout=attn_dropout,
    )


def fixed_batch(cfg: ModelConfig, batch: int, seq: int, seed: int) -> torch.Tensor:
    """One seeded ``[batch, seq]`` token batch on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device="cuda")


def run_train_bench(
    *,
    n_layers: int = 8,
    d_model: int = 2048,
    n_heads: int = 16,
    n_kv_heads: int = 8,
    d_ff: int = 4096,
    vocab: int = 32768,
    batch: int = 4,
    seq: int = 2048,
    steps: int = 7,
    optimizer: str = "adamw",
    window: Optional[int] = None,
    sinks: int = 0,
    softcap: Optional[float] = None,
    alibi: bool = False,
    attn_dropout: float = 0.0,
    log=print,
) -> Dict[str, object]:
    """Run ``steps`` training steps on one fixed seeded batch and time them.

    ``optimizer``: ``"adamw"`` drives ``Trainer.step`` (fp32 masters, bf16
    compute, ``make_optimizer(warmup_steps=2)``); ``"sgd"`` drives
    ``sgd_train_step`` (lr 1e-3), as the JAX bench does.  Each step runs
    between ``torch.cuda.synchronize()`` fences; the first is the warm-up
    and the reported step time is the median of the rest.  ``window``,
    ``sinks``: a FlashLM with sliding-window attention; ``softcap``,
    ``alibi``: one with the score transforms; ``attn_dropout``: one with
    attention dropout (the Trainer draws each step's seeds; ``"sgd"``
    draws none and refuses it).
    """
    if not torch.cuda.is_available():
        raise RuntimeError("run_train_bench needs a CUDA card")
    if steps < 2:
        raise ValueError("steps must be >= 2: the first is the warm-up")
    spec = detect_chip()
    cfg = flashlm_config(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
        d_ff=d_ff, vocab=vocab, seq=seq, window=window, sinks=sinks, softcap=softcap,
        alibi=alibi, attn_dropout=attn_dropout,
    )
    if attn_dropout and optimizer != "adamw":
        raise ValueError("attn_dropout trains through the Trainer (optimizer 'adamw'), "
                         "which draws each step's dropout seeds")
    tokens = fixed_batch(cfg, batch, seq, SEED + 1)
    if optimizer == "adamw":
        trainer = Trainer(
            cfg, optimizer=make_optimizer(warmup_steps=2, total_steps=1000),
            seed=SEED, device="cuda",
        )
        step = lambda: trainer.step(tokens)  # noqa: E731
    elif optimizer == "sgd":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        state = {"params": init_params(cfg, gen, master_dtype=torch.float32)}

        def step():
            state["params"], loss = sgd_train_step(state["params"], tokens, cfg, lr=1e-3)
            return float(loss)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")

    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = float(np.median(times[1:]))
    toks = batch * seq
    flops = model_flops_per_token(cfg, seq) * toks
    result = {
        "model": {
            "n_layers": n_layers, "d_model": d_model, "n_heads": n_heads,
            "n_kv_heads": n_kv_heads, "d_ff": d_ff, "vocab": vocab,
            "attn_window": window, "attn_sinks": sinks, "attn_softcap": softcap,
            "attn_alibi": alibi, "attn_dropout": attn_dropout,
        },
        "batch": batch,
        "seq": seq,
        "optimizer": optimizer,
        "losses": losses,
        "step_ms": t * 1e3,
        "step_ms_all": [x * 1e3 for x in times],
        "tokens_per_s": toks / t,
        "model_tflops": flops / t / 1e12,
        "mfu": flops / t / spec.peak_bf16_flops,
        "peak": spec.name,
        "card": nvidia_smi_line(),
    }
    log(
        f"train step (L{n_layers} d{d_model} b{batch} s{seq}, {optimizer}): "
        f"{t * 1e3:.1f} ms, {toks / t:,.0f} tok/s, {result['model_tflops']:.1f} TF/s "
        f"model flops = {result['mfu']:.1%} MFU of {spec.name} ({result['card']})"
    )
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--sgd", action="store_true", help="time sgd_train_step, not Trainer.step")
    ap.add_argument("--attn-dropout", type=float, default=0.0,
                    help="attention dropout rate (GPT-2's attn_pdrop is 0.1)")
    ap.add_argument("--softcap", type=float, default=None,
                    help="tanh logit softcap (Gemma-2 style): the transformed kernels' training "
                    "path, forward and backward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    result = run_train_bench(
        n_layers=args.layers, d_model=args.d_model, batch=args.batch, seq=args.seq,
        optimizer="sgd" if args.sgd else "adamw", attn_dropout=args.attn_dropout,
        softcap=args.softcap,
    )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
