"""Speculative decoding example on the PyTorch port: a small draft
accelerates a larger target (counterpart of ``examples/speculate.py``).

    python examples/torch_speculate.py [--gamma 4] [--temperature 0] [--device cuda|cpu]

With randomly initialized weights the draft rarely agrees with the target,
so most rounds emit 1-2 tokens: the point of the example is the guarantee
that at temperature 0 the output is token for token the target model's own
greedy decode, whatever the draft proposes.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import numpy as np
import torch

from flash_attention_metal_tpu_torch.models import ModelConfig, init_params
from flash_attention_metal_tpu_torch.runtime import speculative_generate


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    kw = dict(vocab_size=32768, head_dim=64, max_seq_len=2048, dtype=torch.bfloat16)
    cfg_t = ModelConfig(d_model=512, n_layers=4, n_heads=8, n_kv_heads=4, d_ff=2048, **kw)
    cfg_d = ModelConfig(d_model=128, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=256, **kw)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    params_t = init_params(cfg_t, gen)
    gen.manual_seed(1)
    params_d = init_params(cfg_d, gen)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 32768, n).tolist() for n in (64, 17, 100)]
    out = speculative_generate(params_t, cfg_t, params_d, cfg_d, prompts, args.max_new,
                               gamma=args.gamma, temperature=args.temperature)
    for i, toks in enumerate(out):
        print(f"prompt {i}: {len(toks)} tokens, first 8: {toks[:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
