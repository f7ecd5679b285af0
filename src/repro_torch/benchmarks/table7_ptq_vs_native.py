"""Table 7 on the port (scaled down): post-training quantization against
native Quartet training.

The twin of ``benchmarks/table7_ptq_vs_native.py``: one tiny Llama trained
in bf16 and one with Quartet natively on the same tokens; the bf16 weights
evaluated through the quantized forward (fixed Hadamard + MXFP4, the
QuaRot-style PTQ) against the natively trained model.  The claim under
test: native Quartet < PTQ, both within reach of bf16.

    PYTHONPATH=src python -m repro_torch.benchmarks.table7_ptq_vs_native [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.llama_paper import tiny_llama
from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.loop import evaluate, train


def run(device="cuda", steps: int = 300) -> list[tuple]:
    cfg = tiny_llama(d=64, layers=2, vocab=512)
    ds = SyntheticC4Dataset(vocab_size=cfg.vocab_size, seed=11)
    rows = []

    def held_out():
        return TokenBatcher(ds, global_batch=8, seq_len=64, seed=99)

    def train_one(method):
        model = build_model(cfg)
        batcher = TokenBatcher(ds, global_batch=8, seq_len=64, seed=2)
        opt = adamw(cosine_warmup(2e-3, steps), weight_decay=0.0)
        state, _ = train(model, opt, batcher, steps, method=method, log_every=0,
                         device=device)
        return model, state, evaluate(model, state, held_out(), 4, method=method,
                                      device=device)

    t0 = time.perf_counter()
    model_bf, state_bf, loss_bf = train_one("bf16")
    rows.append(("table7/bf16_eval", (time.perf_counter() - t0) * 1e6,
                 f"loss={loss_bf:.4f} (paper ppl 16.40)"))

    # PTQ: the bf16-trained weights through the quantized forward (fixed
    # Hadamard + MXFP4, QuaRot-style), no adaptation
    t0 = time.perf_counter()
    loss_ptq = evaluate(model_bf, state_bf, held_out(), 4, method="quartet", device=device)
    rows.append(("table7/ptq_quarot_eval", (time.perf_counter() - t0) * 1e6,
                 f"loss={loss_ptq:.4f} (paper ppl 18.19)"))

    t0 = time.perf_counter()
    _, _, loss_q = train_one("quartet")
    rows.append(("table7/quartet_native_eval", (time.perf_counter() - t0) * 1e6,
                 f"loss={loss_q:.4f} (paper ppl 17.77)"))
    rows.append(("table7/native_beats_ptq", 0.0,
                 "PASS" if loss_q < loss_ptq else f"FAIL q={loss_q:.4f} ptq={loss_ptq:.4f}"))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    for row in run(args.device):
        print(*row, sep="\t")
