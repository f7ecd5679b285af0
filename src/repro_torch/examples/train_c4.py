"""End-to-end training driver: pre-train a Llama on the C4 stand-in with
Quartet, the paper's recipe (AdamW, cosine schedule with 10% warmup, clip
1.0, sequence 512, f32 optimizer state).

The twin of ``examples/train_c4.py`` over the port's ``data.pipeline``,
``train.loop`` and checkpointer, with the same flags.  It trains the
paper's 30M config by default; ``--tiny`` takes a 3-layer d-96 Llama for a
run of minutes.  With ``--checkpoint-dir`` a restart resumes from the
latest checkpoint there, bit for bit.  It runs on the card (the Quartet
linears on the kernels) unless ``--device cpu`` is given, which runs the
kernels' plain versions; without a GPU and without ``--device cpu`` it
exits non-zero.

  PYTHONPATH=src python -m repro_torch.examples.train_c4 --tiny --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_c4 --arch llama-paper-30m \\
      --steps 500 --method quartet --checkpoint-dir ckpts/30m
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.llama_paper import LEARNING_RATES, tiny_llama
from repro_torch.data.pipeline import TokenBatcher, make_dataset
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.loop import evaluate, train


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-paper-30m")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--method", default="quartet")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--data", default="synthetic",
                    help='"synthetic" or a path to packed uint16 tokens (C4)')
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="steps between checkpoints (default: max(steps // 4, 50))")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    """Train, evaluate, print the result line → (final state, per-step
    history, validation loss)."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    if args.tiny:
        cfg = tiny_llama(d=96, layers=3, vocab=1024)
        lr = 2e-3
    else:
        cfg = get_config(args.arch)
        lr = LEARNING_RATES.get(args.arch, 6e-4)
    if args.device == "cuda":
        cfg = kernel_config(cfg)
    seq = args.seq or (64 if args.tiny else 512)  # the paper's sequence: 512

    model = build_model(cfg)
    ds = make_dataset(args.data, cfg.vocab_size)
    batcher = TokenBatcher(ds, args.batch, seq)
    opt = adamw(cosine_warmup(lr, args.steps), weight_decay=0.1)
    every = args.checkpoint_every or max(args.steps // 4, 50)

    state, hist = train(
        model, opt, batcher, args.steps, method=args.method,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=every,
        microbatch=args.microbatch, log_every=10, device=args.device)

    ev = TokenBatcher(ds, args.batch, seq, seed=123)
    val = evaluate(model, state, ev, 8, method=args.method, device=args.device)
    print(f"\n{cfg.name} [{args.method}] {args.steps} steps "
          f"({args.steps * args.batch * seq:,} tokens): val loss {val:.4f}")
    return state, hist, val


if __name__ == "__main__":
    main()
