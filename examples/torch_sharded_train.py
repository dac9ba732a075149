"""Multi-rank training example on the PyTorch port: sharded AdamW over a
(dp, tp, sp) mesh (counterpart of ``examples/sharded_train.py``).

    python examples/torch_sharded_train.py [--ranks 8] [--backend nccl|gloo]
                                           [--device cuda|cpu]

Each rank is a process (``parallel.spawn``): 8 ranks form mesh (2, 2, 2),
fewer a 1-D sp mesh.  NCCL takes one card a rank; ranks that share a card,
or run on the CPU, take gloo.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import torch

from flash_attention_metal_tpu_torch.models import ModelConfig, init_params
from flash_attention_metal_tpu_torch.models.parallel_train import (
    batch_sharding,
    make_adamw_train_step,
    shard_params,
)
from flash_attention_metal_tpu_torch.models.trainer import constant_adamw
from flash_attention_metal_tpu_torch.parallel import make_mesh, spawn


def rank_main(rank: int, ranks: int, device: str) -> list:
    shape = (2, 2, 2) if ranks >= 8 else (1, 1, ranks)
    mesh = make_mesh(shape, device=device)
    cfg = ModelConfig(vocab_size=2048, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      head_dim=64, d_ff=512, max_seq_len=512, dtype=torch.float32)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(0)
    params = shard_params(init_params(cfg, gen, master_dtype=torch.float32), cfg, mesh)
    gen.manual_seed(1)
    tokens = torch.randint(0, 2048, (4, 256), generator=gen, device=mesh.device)
    tokens = batch_sharding(mesh).shard(tokens)
    opt = constant_adamw(1e-3, grad_clip=1.0)
    opt_state = opt.init(params)
    step = make_adamw_train_step(mesh, cfg, opt, sp_attn="ring")
    losses = []
    for i in range(5):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
        if rank == 0:
            print(f"step {i}: loss {losses[-1]:.4f} (mesh {dict(zip(mesh.axis_names, shape))})",
                  flush=True)
    return losses


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    spawn(rank_main, args.ranks, (args.ranks, args.device), backend=args.backend,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
