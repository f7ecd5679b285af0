"""Training launcher::

    python -m repro_torch.launch.train --arch llama-paper-200m --steps 5 \\
        --batch 32 --seq 512 --microbatch 2

Port of ``repro.launch.train`` for one card.  Trains ``--arch`` (a member
of the paper's Llama family, or ``--reduced`` for its CPU-scale stand-in)
from random weights drawn from ``--seed`` on synthetic C4-like data (or a
memmap token file, ``--data``), with AdamW on a cosine schedule with 10%
warmup at the paper's learning rate.  On ``cuda`` (the default) the
Quartet linears run on the Hopper kernels; without a GPU it exits non-zero
unless ``--device cpu`` is given, which runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.llama_paper import LEARNING_RATES
from repro_torch.data.pipeline import TokenBatcher, make_dataset
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.loop import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-paper-200m")
    ap.add_argument("--reduced", action="store_true", help="the CPU-scale config")
    ap.add_argument("--method", default="quartet", choices=["quartet", "bf16"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.device == "cuda":
        cfg = kernel_config(cfg)
    model = build_model(cfg)
    lr = args.lr or LEARNING_RATES.get(args.arch, 3e-4)
    opt = adamw(cosine_warmup(lr, args.steps))
    batcher = TokenBatcher(make_dataset(args.data, cfg.vocab_size), args.batch, args.seq)
    t0 = time.perf_counter()
    _, history = train(model, opt, batcher, args.steps, method=args.method,
                       microbatch=args.microbatch, seed=args.seed, device=args.device,
                       log_every=1)
    wall = time.perf_counter() - t0
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    tokens = args.steps * args.batch * args.seq
    print(f"\n{cfg.name}: {args.steps} steps x {args.batch} x {args.seq} tokens on {where}, "
          f"{wall:.2f} s wall (init included) -> {tokens / wall:.1f} tok/s; "
          f"final loss {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
