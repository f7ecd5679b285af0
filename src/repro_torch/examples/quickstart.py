"""Quickstart: Quartet's Algorithm 1 on one linear layer, on the port.

The port's twin of ``examples/quickstart.py``, at the same three levels:
  1. ``quartet_linear``, the quantized linear with its Algorithm-1 backward,
  2. the quantizers and metrics of §4.3 (Table 2's error-bias trade-off),
  3. a 20-step training run of a tiny Llama with every linear in MXFP4,
     through ``train.loop.train``.

Run on the GPU (the Quartet linears of part 3 on the kernels):
    PYTHONPATH=src python -m repro_torch.examples.quickstart
or on the CPU (the plain path):
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import metrics as M
from repro_torch.core import quantizers as Q
from repro_torch.core import threefry
from repro_torch.core.quartet import QUARTET_CONFIG, quartet_linear


def main(device: str = "cuda", steps: int = 20) -> dict:
    rng = np.random.default_rng(0)

    # -- 1. the Quartet linear layer -----------------------------------------
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32)).to(device)
    w = torch.from_numpy((rng.standard_normal((256, 128)) * 0.06).astype(np.float32)).to(device)
    x.requires_grad_()
    w.requires_grad_()
    y = quartet_linear(x, w, 0, QUARTET_CONFIG)
    ref = x.detach() @ w.detach()
    rel = float(torch.linalg.norm(y.detach() - ref) / torch.linalg.norm(ref))
    print(f"[1] forward in MXFP4: relative error {rel:.3f} "
          f"(all three GEMMs of the backward run in MXFP4 too)")
    dx, dw = torch.autograd.grad((y ** 2).sum(), [x, w])
    print(f"    backward: |dx|={float(torch.linalg.norm(dx)):.2f} "
          f"|dw|={float(torch.linalg.norm(dw)):.2f}")

    # -- 2. the error-bias trade-off (Table 2) --------------------------------
    g = torch.from_numpy(rng.standard_normal((2048, 32)).astype(np.float32)).to(device)
    mses = {}
    for name, r in [("QuEST  ", Q.quest(g)), ("RTN    ", Q.rtn_absmax(g)),
                    ("SR     ", Q.sr_absmax(g, threefry.prng_key(2)))]:
        mses[name.strip()] = float(torch.mean((r.values - g) ** 2) / torch.mean(g ** 2))
        print(f"[2] {name} forward MSE {mses[name.strip()]:.4f}")
    mis = float(M.pma_misalignment(g.reshape(-1)[:4096], "sr_absmax", threefry.prng_key(3),
                                   num_samples=16))
    print(f"    SR misalignment {mis:+.1e}  → unbiased backward (§4.3)")

    # -- 3. end-to-end: a tiny Llama fully trained in MXFP4 -------------------
    from repro_torch.configs.llama_paper import tiny_llama
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train

    cfg = tiny_llama(d=64, layers=2, vocab=512)
    if device != "cpu":
        cfg = kernel_config(cfg)
    model = build_model(cfg)
    batcher = TokenBatcher(SyntheticC4Dataset(vocab_size=cfg.vocab_size, seed=0),
                           global_batch=8, seq_len=64)
    opt = adamw(cosine_warmup(2e-3, steps), weight_decay=0.0)
    _, hist = train(model, opt, batcher, steps, log_every=0, device=device)
    print(f"[3] tiny-Llama, every linear in MXFP4: "
          f"loss {hist[0]['loss']:.3f} → {hist[-1]['loss']:.3f} in {steps} steps")
    return {"relative_error": rel, "mse": mses, "sr_misalignment": mis,
            "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain path")
    main(args.device, args.steps)
