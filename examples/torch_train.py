"""Minimal training example on the PyTorch port: the AdamW trainer with
checkpoint/resume (counterpart of ``examples/train.py``).

    python examples/torch_train.py [--steps 30] [--ckpt /tmp/flashlm]
                 [--grad-accum 2] [--blockwise-ce] [--dropout 0.1]
                 [--device cuda|cpu] [--batch 8] [--seq 1024]

``--batch`` and ``--seq`` (the JAX script's fixed 8 x 1024 by default) let a
CPU run stay small.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import torch

from flash_attention_metal_tpu_torch.models import ModelConfig
from flash_attention_metal_tpu_torch.models.trainer import (
    Trainer,
    make_optimizer,
    synthetic_batches,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--blockwise-ce", action="store_true",
                    help="chunked-vocab cross entropy (no [B,N,V] logit tensor)")
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args()

    cfg = ModelConfig(vocab_size=8192, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
                      head_dim=64, d_ff=2048, max_seq_len=1024, dtype=torch.bfloat16,
                      attn_dropout=args.dropout)
    loss = None
    if args.blockwise_ce:
        from flash_attention_metal_tpu_torch.models import loss_fn_blockwise

        loss = loss_fn_blockwise
    tr = Trainer(cfg, optimizer=make_optimizer(peak_lr=3e-4, warmup_steps=10,
                                               total_steps=args.steps),
                 grad_accum=args.grad_accum, loss=loss, device=args.device)
    out = tr.train(synthetic_batches(cfg, batch=args.batch, seq=args.seq, device=args.device),
                   steps=args.steps, checkpoint_path=args.ckpt,
                   checkpoint_every=10 if args.ckpt else 0, log_every=5)
    print(f"final loss {out['losses'][-1]:.4f} at step {out['final_step']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
