"""Minimal serving example on the PyTorch port: continuous batching on a
FlashLM model (counterpart of ``examples/generate.py``).

    python examples/torch_generate.py [--kv-quant int8] [--rolling]
                                      [--paged] [--multi-step 8] [--device cuda|cpu]

Uses randomly initialized weights (the framework ships no checkpoints),
so outputs are structurally valid token ids, not language.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import numpy as np
import torch

from flash_attention_metal_tpu_torch.models import ModelConfig, init_params
from flash_attention_metal_tpu_torch.runtime.engine import DecodeEngine, Request


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv-quant", choices=["int8", "fp8"], default=None)
    ap.add_argument("--rolling", action="store_true",
                    help="O(window) rolling cache (uses attn_window)")
    ap.add_argument("--paged", action="store_true",
                    help="vLLM-style paged pool + prompt prefix sharing")
    ap.add_argument("--multi-step", type=int, default=1,
                    help="decode K tokens per device dispatch")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--weight-quant", action="store_true",
                    help="weight-only int8 params (models/wquant.py)")
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--presence-penalty", type=float, default=0.0)
    ap.add_argument("--frequency-penalty", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    cfg = ModelConfig(vocab_size=32768, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
                      head_dim=64, d_ff=2048, max_seq_len=2048, dtype=torch.bfloat16,
                      attn_window=256 if args.rolling else None)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    if args.weight_quant:
        from flash_attention_metal_tpu_torch.models import quantize_weights

        params = quantize_weights(params)
    eng = DecodeEngine(params, cfg, max_batch=4, max_len=2048, kv_quant=args.kv_quant,
                       rolling=args.rolling, paged=args.paged, prefix_share=args.paged,
                       multi_step=args.multi_step)
    rng = np.random.default_rng(0)
    for uid in range(6):
        eng.submit(Request(
            uid=uid, prompt=rng.integers(1, cfg.vocab_size, 64).tolist(),
            max_new_tokens=args.max_new, temperature=0.8 if uid % 2 else 0.0,
            top_k=50 if uid % 2 else 0, min_p=args.min_p if uid % 2 else 0.0,
            presence_penalty=args.presence_penalty, frequency_penalty=args.frequency_penalty))
    out = eng.run()
    for uid in sorted(out):
        print(f"request {uid}: {len(out[uid])} tokens, first 8: {out[uid][:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
