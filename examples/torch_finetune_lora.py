"""LoRA fine-tuning on the PyTorch port: adapter-only training over a frozen
FlashLM base (counterpart of ``examples/finetune_lora.py``).

    python examples/torch_finetune_lora.py --steps 20 --rank 8 [--device cuda|cpu]

The base model stays frozen (bit-identical), the AdamW state is
adapter-sized, and the merged tree drops straight into the serving engine.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import torch

from flash_attention_metal_tpu_torch.models import ModelConfig, init_params
from flash_attention_metal_tpu_torch.models.lora import (
    LoRAConfig,
    init_lora,
    lora_num_params,
    make_lora_train_step,
    merge_lora,
)
from flash_attention_metal_tpu_torch.models.trainer import synthetic_batches
from flash_attention_metal_tpu_torch.models.transformer import param_leaves
from flash_attention_metal_tpu_torch.runtime import DecodeEngine, Request


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    cfg = ModelConfig(vocab_size=1024, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      head_dim=64, d_ff=512, max_seq_len=512)
    lcfg = LoRAConfig(rank=args.rank)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    params = init_params(cfg, gen)  # stand-in for a pretrained checkpoint
    gen.manual_seed(1)
    adapters = init_lora(params, lcfg, gen)
    n_base = sum(t.numel() for t in param_leaves(params))
    n_lora = lora_num_params(adapters)
    print(f"base params: {n_base / 1e6:.1f}M, trainable (LoRA r={args.rank}): "
          f"{n_lora / 1e3:.1f}K ({100 * n_lora / n_base:.2f}%)")
    step, opt_init = make_lora_train_step(cfg, lcfg)
    opt_state = opt_init(adapters)
    batches = synthetic_batches(cfg, args.batch, args.seq, device=args.device)
    for i in range(args.steps):
        adapters, opt_state, loss = step(adapters, opt_state, params, next(batches))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.4f}")
    # Merge and serve.
    merged = merge_lora(params, adapters, lcfg)
    eng = DecodeEngine(merged, cfg, max_batch=2, max_len=512)
    eng.submit(Request(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=16))
    out = eng.run()
    print("merged-model generation:", out[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
