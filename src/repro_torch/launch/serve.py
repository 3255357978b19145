"""Serving launcher CLI, as ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch mamba2-1.3b \\
        --batch 4 --prompt-len 4096 --new-tokens 32 --temperature 0
    python -m repro_torch.launch.serve --arch stablelm-3b \\
        --batch 4 --prompt-len 4096 --new-tokens 32 --temperature 0

``--arch`` takes the ported archs: the dense ``stablelm-3b``,
``yi-6b``, ``phi3-medium-14b`` and ``deepseek-67b``, ``mamba2-1.3b``
(ssm), ``zamba2-1.2b`` (hybrid), and the MoE ``qwen3-moe-30b-a3b`` and
``moonshot-v1-16b-a3b``.  Runs on the card by default (``--device
cuda``; raises where CUDA is missing); ``--device cpu --reduced`` serves
the reduced config on the host.  At full width phi3-medium-14b, the two
MoE archs and deepseek-67b need more than one 80 GB card (fp32 weights
and their bf16 casts, ≈ 6 bytes a parameter).  Weights are random, drawn from ``--seed``.  Prints the tokens per
second of the whole ``generate`` call (prefill included).  The
reference's ``--mesh`` waits for the multi-device step.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = T.init_params(cfg, generator=gen, device=dev)
    eng = ServeEngine(cfg, model, max_len=args.prompt_len + args.new_tokens,
                      device=dev)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=args.new_tokens,
                       temperature=args.temperature, seed=args.seed)
    dt = time.perf_counter() - t0      # generate returns host arrays
    n = args.batch * args.new_tokens
    print(f"arch={cfg.name} device={dev} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.new_tokens}: {n} tokens in "
          f"{dt:.2f}s ({n/dt:.0f} tok/s)")
    for b in range(min(2, args.batch)):
        print(f"  seq[{b}]: {res.tokens[b][:16].tolist()}")


if __name__ == "__main__":
    main()
