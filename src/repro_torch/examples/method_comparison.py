"""Table-3-style method shoot-out on the port: train the same tiny Llama
with every fully-quantized training method and print the loss table.

The twin of ``examples/method_comparison.py``, on the card unless
``--device cpu``::

    PYTHONPATH=src python -m repro_torch.examples.method_comparison --steps 200
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.llama_paper import tiny_llama
from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.loop import train

METHODS = ["bf16", "quartet", "luq_int4", "luq_fp4", "jetfire_fp4", "halo_fp4", "lss_int4"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    cfg = tiny_llama(d=args.d, layers=2, vocab=512)
    model = build_model(cfg)
    ds = SyntheticC4Dataset(vocab_size=cfg.vocab_size, seed=7)

    print(f"{'method':14s} {'final loss':>10s}   (tiny Llama, {args.steps} steps, "
          f"{args.device})")
    results = {}
    for method in METHODS:
        batcher = TokenBatcher(ds, global_batch=8, seq_len=64, seed=1)
        opt = adamw(cosine_warmup(2e-3, args.steps), weight_decay=0.0)
        _, hist = train(model, opt, batcher, args.steps, method=method, log_every=0,
                        device=args.device)
        results[method] = float(np.mean([h["loss"] for h in hist[-8:]]))
        print(f"{method:14s} {results[method]:10.4f}")

    prior = min(v for k, v in results.items() if k not in ("bf16", "quartet"))
    print(f"\nquartet vs best 4-bit prior: {results['quartet']:.4f} vs {prior:.4f} "
          f"({'WINS' if results['quartet'] < prior else 'LOSES'}) — paper Table 3")
    return results


if __name__ == "__main__":
    main()
