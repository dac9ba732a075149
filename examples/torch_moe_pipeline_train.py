"""Pipeline-parallel and expert-parallel training on the PyTorch port
(4-axis meshes; counterpart of ``examples/moe_pipeline_train.py``).

    python examples/torch_moe_pipeline_train.py [--ranks 8] [--backend nccl|gloo]
                                                [--device cuda|cpu]

Each rank is a process (``parallel.spawn``).  With 8 ranks the pipeline
runs on (dp, pp, tp, sp) = (1, 2, 2, 2) and the MoE on (dp, ep, tp, sp) =
(1, 4, 2, 1); with fewer, both on a 1-D sp mesh.  NCCL takes one card a
rank; ranks that share a card, or run on the CPU, take gloo.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import torch

from flash_attention_metal_tpu_torch.models import ModelConfig, init_params
from flash_attention_metal_tpu_torch.models import moe, pipeline
from flash_attention_metal_tpu_torch.models.trainer import constant_adamw
from flash_attention_metal_tpu_torch.parallel import make_mesh, spawn
from flash_attention_metal_tpu_torch.parallel.mesh import shard


def _run(rank, tag, mesh, params, opt, step, tokens) -> list:
    opt_state = opt.init(params)
    losses = []
    for i in range(5):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
        if rank == 0:
            print(f"[{tag}] step {i}: loss {losses[-1]:.4f}", flush=True)
    return losses


def pipeline_demo(rank: int, ranks: int, device: str) -> list:
    """GPipe pipeline over (dp, pp, tp, sp) = (1, 2, 2, 2)."""
    mesh = make_mesh((1, 2, 2, 2) if ranks >= 8 else (1, 1, 1, ranks), pipeline.AXES,
                     device=device)
    cfg = ModelConfig(vocab_size=1024, d_model=128, n_layers=4, n_heads=4, n_kv_heads=2,
                      head_dim=64, d_ff=256, max_seq_len=512, dtype=torch.float32)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(0)
    params = pipeline.shard_pp_params(
        pipeline.stack_layer_params(init_params(cfg, gen, master_dtype=torch.float32)), cfg,
        mesh)
    gen.manual_seed(1)
    tokens = shard(torch.randint(0, 1024, (8, 256), generator=gen, device=mesh.device), mesh,
                   ("dp", "sp"))
    opt = constant_adamw(3e-3)
    return _run(rank, "pipeline", mesh, params, opt,
                pipeline.make_pp_optax_step(mesh, cfg, opt, n_micro=4), tokens)


def moe_demo(rank: int, ranks: int, device: str) -> list:
    """MoE over (dp, ep, tp, sp) = (1, 4, 2, 1): 8 experts, top-2."""
    mesh = make_mesh((1, 4, 2, 1) if ranks >= 8 else (1, 1, 1, ranks), moe.AXES, device=device)
    cfg = moe.MoEConfig(vocab_size=1024, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=256, max_seq_len=512, dtype=torch.float32,
                        n_experts=8, top_k=2, capacity_factor=1.5)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(0)
    params = moe.shard_moe_params(moe.init_moe_params(cfg, gen), cfg, mesh)
    gen.manual_seed(1)
    tokens = shard(torch.randint(0, 1024, (8, 256), generator=gen, device=mesh.device), mesh,
                   moe.BATCH_SPEC)
    opt = constant_adamw(3e-3)
    return _run(rank, "moe", mesh, params, opt, moe.make_moe_optax_step(mesh, cfg, opt), tokens)


def rank_main(rank: int, ranks: int, device: str) -> dict:
    return {"pipeline": pipeline_demo(rank, ranks, device), "moe": moe_demo(rank, ranks, device)}


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
