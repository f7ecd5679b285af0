"""Table 3 on the port (scaled down): fully-quantized training methods.

The twin of ``benchmarks/table3_method_comparison.py``: identical tiny
Llamas (d 64, 2 layers, vocab 512) on the synthetic C4 stand-in, one per
method, at two token budgets, on the card (``--device cpu`` for the
plain versions on the CPU); the claim under test is the ordering — Quartet
lowest loss among the 4-bit methods — not the absolute values.  ``FULL=1``
extends the budgets toward real D/N ratios.  The weights are drawn by the
port's generator (the original draws them with ``jax.random``).

    PYTHONPATH=src python -m repro_torch.benchmarks.table3_method_comparison [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs.llama_paper import tiny_llama
from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.loop import train

METHODS = ["bf16", "quartet", "luq_int4", "luq_fp4", "jetfire_fp4", "halo_fp4", "lss_int4"]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(device="cuda", steps_grid=None) -> list[tuple]:
    """The original's rows: (name, microseconds a step, final loss), then
    the ordering checks at the largest budget."""
    full = bool(int(os.environ.get("FULL", "0")))
    steps_grid = steps_grid or ([150, 300] if not full else [300, 1200, 4800])
    cfg = tiny_llama(d=64, layers=2, vocab=512)
    model = build_model(cfg)
    ds = SyntheticC4Dataset(vocab_size=cfg.vocab_size, seed=7)

    rows = []
    finals: dict[str, list[float]] = {}
    for method in METHODS:
        finals[method] = []
        for steps in steps_grid:
            batcher = TokenBatcher(ds, global_batch=8, seq_len=64, seed=1)
            opt = adamw(cosine_warmup(2e-3, steps), weight_decay=0.0)
            sync(device)
            t0 = time.perf_counter()
            _, hist = train(model, opt, batcher, steps, method=method, log_every=0,
                            device=device)
            sync(device)
            us = (time.perf_counter() - t0) * 1e6 / max(steps, 1)
            final = float(np.mean([h["loss"] for h in hist[-10:]]))
            final = final if np.isfinite(final) else float("nan")
            finals[method].append(final)
            rows.append((f"table3/{method}/steps{steps}", us, f"loss={final:.4f}"))

    # ordering checks at the largest budget (the paper's qualitative claims)
    last = {m: finals[m][-1] for m in METHODS}
    q, bf = last["quartet"], last["bf16"]
    prior_best = np.nanmin([last[m] for m in METHODS if m not in ("quartet", "bf16")])
    rows.append(("table3/quartet_beats_all_4bit_priors", 0.0,
                 "PASS" if q < prior_best else f"FAIL q={q:.3f} prior={prior_best:.3f}"))
    rows.append(("table3/quartet_near_bf16", 0.0,
                 f"gap={q - bf:+.4f} (paper: near-lossless at high D/N)"))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"device: {where}")
    for row in run(args.device):
        print(*row, sep="\t")
