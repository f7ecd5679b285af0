"""Figure 2 on the port: backward quantization against gradient quality.

The twin of ``benchmarks/fig2_gradient_alignment.py``: (a) cosine
similarity and (b) magnitude alignment (the PMA quantity) of inter-layer
activation gradients by back-propagation depth, for RTN and SR backward
quantization, against the unquantized backward, on a stack of 6 dense
blocks (d 96, f32); (c) the training consequence at two token budgets.
The claims under test: RTN keeps the higher cosine similarity, SR keeps the
magnitude alignment near 1 (unbiased).  The weights and inputs are drawn
by the port's generator (the original's by ``jax.random``).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig2_gradient_alignment [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.llama_paper import tiny_llama
from repro_torch.core.quartet import QuartetConfig
from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
from repro_torch.models import build_model
from repro_torch.models.transformer import dense_block, init_dense_block
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.loop import train

DEPTH = 6


def _per_depth_alignment(device) -> list[tuple]:
    """Inter-layer activation gradients at every depth from one backward a
    scheme, through ε-taps: x ← layer(x + ε_d), so ∂L/∂ε_d is the gradient
    at layer d's input (``torch.autograd.grad`` with respect to the taps)."""
    cfg = dataclasses.replace(tiny_llama(d=96, layers=DEPTH, vocab=512), remat=False,
                              dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    layers = [init_dense_block(cfg, torch.float32, gen, device) for _ in range(DEPTH)]
    B, S = 2, 64
    x0 = torch.randn((B, S, cfg.d_model), generator=gen, device=device)
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)

    def grads_for(qcfg):
        c = dataclasses.replace(cfg, quartet=qcfg)
        eps = [torch.zeros_like(x0, requires_grad=True) for _ in range(DEPTH)]
        x = x0
        for d, lp in enumerate(layers):
            x, _ = dense_block(lp, x + eps[d], pos, 7, c, None, "quartet")
        return torch.autograd.grad((x.to(torch.float32) ** 2).sum(), eps)

    grads = {
        "reference": grads_for(QuartetConfig(bwd_rounding="none", bwd_hadamard="none")),
        "rtn": grads_for(QuartetConfig(bwd_rounding="rtn", bwd_hadamard="random")),
        "sr": grads_for(QuartetConfig()),
    }
    rows, stats = [], {}
    for name in ("rtn", "sr"):
        cos, mag = [], []
        for d in range(DEPTH):
            g, r = grads[name][d].reshape(-1), grads["reference"][d].reshape(-1)
            cos.append(float(torch.dot(g, r) / (torch.linalg.norm(g) * torch.linalg.norm(r))))
            mag.append(float(torch.dot(g, r) / torch.dot(r, r)))
        stats[name] = (cos, mag)
        # index 0 = the first layer: the most back-propagation steps accumulated
        rows.append((f"fig2a/{name}/cosine_by_depth", 0.0, " ".join(f"{c:.3f}" for c in cos)))
        rows.append((f"fig2b/{name}/magnitude_by_depth", 0.0,
                     " ".join(f"{m:.3f}" for m in mag)))
    rtn_cos, sr_cos = stats["rtn"][0][0], stats["sr"][0][0]
    sr_mag = stats["sr"][1][0]
    rows.append(("fig2/rtn_cosine>=sr_cosine_at_depth", 0.0,
                 f"rtn={rtn_cos:.3f} sr={sr_cos:.3f} "
                 f"{'PASS' if rtn_cos >= sr_cos - 0.02 else 'FAIL'}"))
    rows.append(("fig2/sr_magnitude_near_1_at_depth", 0.0,
                 f"{sr_mag:.3f} {'PASS' if abs(sr_mag - 1) < 0.15 else 'FAIL'}"))
    return rows


def _training_consequence(device, budgets=(120, 360)) -> list[tuple]:
    """Fig. 2(c): the loss of RTN- and SR-backward training at two budgets."""
    rows = []
    cfg = tiny_llama(d=64, layers=2, vocab=512)
    ds = SyntheticC4Dataset(vocab_size=512, seed=3)
    finals = {}
    for name, qc in [("sr", QuartetConfig()), ("rtn", QuartetConfig(bwd_rounding="rtn"))]:
        model = build_model(dataclasses.replace(cfg, quartet=qc))
        for steps in budgets:
            b = TokenBatcher(ds, 8, 64, seed=1)
            opt = adamw(cosine_warmup(2e-3, steps), weight_decay=0.0)
            t0 = time.perf_counter()
            _, hist = train(model, opt, b, steps, log_every=0, device=device)
            us = (time.perf_counter() - t0) * 1e6 / steps
            finals[(name, steps)] = float(np.mean([h["loss"] for h in hist[-8:]]))
            rows.append((f"fig2c/{name}_bwd/steps{steps}", us,
                         f"loss={finals[(name, steps)]:.4f}"))
    lo, hi = budgets
    gap_short = finals[("sr", lo)] - finals[("rtn", lo)]
    gap_long = finals[("sr", hi)] - finals[("rtn", hi)]
    rows.append(("fig2c/sr_gains_with_budget", 0.0,
                 f"gap(sr-rtn) {gap_short:+.4f} @{lo} -> {gap_long:+.4f} @{hi} "
                 f"(paper: SR overtakes at large D/N)"))
    return rows


def run(device="cuda", budgets=(120, 360)) -> list[tuple]:
    return _per_depth_alignment(device) + _training_consequence(device, budgets)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    for row in run(args.device):
        print(*row, sep="\t")
