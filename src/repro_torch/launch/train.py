"""Training launcher CLI, as ``repro.launch.train``.

    python -m repro_torch.launch.train --arch stablelm-3b \\
        --steps 4 --batch 2 --seq 4096 --optimizer flexa \\
        [--reduced] [--ckpt-dir ckpts/run1] [--l1 1e-5] [--compress topk]

Runs on the card by default (``--device cuda``; raises where CUDA is
missing); ``--reduced --device cpu`` trains the reduced config on the
host.  Weights are random, drawn from ``--seed``; data is the synthetic
``TokenPipeline``.  The reference's ``--mesh`` waits for the
multi-device step.
"""
from __future__ import annotations

import argparse

from repro_torch.config.base import TrainConfig
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.train.loop import TrainLoop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-scale) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="flexa",
                    choices=("flexa", "adamw"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--l1", type=float, default=0.0,
                    help="FLEXA ℓ1 weight (sparsity-promoting training)")
    ap.add_argument("--rho", type=float, default=0.5)
    ap.add_argument("--tau0", type=float, default=1.0)
    ap.add_argument("--gamma0", type=float, default=0.9)
    ap.add_argument("--diag-q", action="store_true")
    ap.add_argument("--select", default="greedy", choices=("greedy", "all"))
    ap.add_argument("--compress", default="none",
                    choices=("none", "topk", "int8"))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainConfig(
        optimizer=args.optimizer, lr=args.lr, flexa_l1=args.l1,
        flexa_rho=args.rho, flexa_tau0=args.tau0, flexa_gamma0=args.gamma0,
        flexa_diag_q=args.diag_q, flexa_select=args.select,
        grad_compression=args.compress, steps=args.steps,
        log_every=args.log_every, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, seed=args.seed)

    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"optimizer={args.optimizer} steps={args.steps} device={dev}",
          flush=True)
    loop = TrainLoop(cfg, tcfg, batch=args.batch, seq_len=args.seq,
                     device=dev)
    loop.run()
    print(f"done; slow steps: {loop.monitor.slow_steps}")


if __name__ == "__main__":
    main()
