"""Format ablation on the port: Quartet with NVFP4 (E2M1, block 16, E4M3
scales) and MXFP8 (E4M3, block 32, E8M0 scales) beside the paper's MXFP4.

The twin of ``benchmarks/ablation_formats.py``: the forward quantization
MSE (QuEST) per format on Gaussian data, and a fixed-budget tiny-train loss
per format.  Expected: MSE mxfp8 ≪ the 4-bit formats.  NVFP4 trains as the
reference computes it, block scales without a per-tensor scale (ROADMAP
C7: its small backward blocks underflow to 0).  The data are a numpy
Gaussian from seed 0 (the original draws it with ``jax.random``).

    PYTHONPATH=src python -m repro_torch.benchmarks.ablation_formats [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.llama_paper import tiny_llama
from repro_torch.core import quantizers as Q
from repro_torch.core.quartet import QuartetConfig
from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.loop import train

VARIANTS = {
    "mxfp4": QuartetConfig(),  # the paper
    "nvfp4": QuartetConfig(fwd_format="nvfp4", bwd_format="nvfp4", group=16),
    "mxfp8": QuartetConfig(fwd_format="mxfp8", bwd_format="mxfp8"),
}


def run(device="cuda", steps: int = 150) -> list[tuple]:
    rows = []
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2048, 64))
                         .astype(np.float32)).to(device)
    mses = {}
    for name, qc in VARIANTS.items():
        r = Q.quest(x, qc.fwd_fmt)
        mses[name] = float(torch.mean((r.values - x) ** 2) / torch.mean(x**2))
        rows.append((f"ablation/{name}/fwd_mse", 0.0, f"{mses[name]:.3e}"))
    rows.append(("ablation/mse_ordering_fp8<fp4", 0.0,
                 "PASS" if mses["mxfp8"] < min(mses["mxfp4"], mses["nvfp4"]) else "FAIL"))

    cfg0 = tiny_llama(d=64, layers=2, vocab=512)
    ds = SyntheticC4Dataset(vocab_size=512, seed=5)
    finals = {}
    for name, qc in VARIANTS.items():
        model = build_model(dataclasses.replace(cfg0, quartet=qc))
        b = TokenBatcher(ds, 8, 64, seed=1)
        opt = adamw(cosine_warmup(2e-3, steps), weight_decay=0.0)
        t0 = time.perf_counter()
        _, hist = train(model, opt, b, steps, log_every=0, device=device)
        us = (time.perf_counter() - t0) * 1e6 / steps
        finals[name] = float(np.mean([h["loss"] for h in hist[-8:]]))
        rows.append((f"ablation/{name}/train_loss", us, f"{finals[name]:.4f}"))
    rows.append(("ablation/mxfp4_close_to_mxfp8", 0.0,
                 f"gap={finals['mxfp4'] - finals['mxfp8']:+.4f} "
                 f"(paper: 4-bit ≈ 8-bit with Quartet)"))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    for row in run(args.device):
        print(*row, sep="\t")
