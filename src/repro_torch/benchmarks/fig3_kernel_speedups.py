"""Figure 3 on the H100: the Quartet linear on the kernels against bf16.

The twin of ``benchmarks/fig3_kernel_speedups.py``, which estimates FP4
speed-ups from a cost model.  This one measures: at the paper's Llama-7B
linear shapes (batch 64 × sequence 512 = 32768 tokens; d 4096, FFN 11008)
it times ``core.quartet.quartet_linear`` with ``use_kernels=True`` (B1 and
B3 forward; B2, B3 and the epilogues backward) against one bf16
``torch.matmul`` forward, and the forward with backward against bf16's
three GEMMs, and prints each ratio.  Each time is the median of CUDA-event
timings with the 50 MB L2 flushed before each call.  The H100 has no FP4
tensor cores: B3 multiplies its MXFP4 operands on bf16 tensor cores, so
the ratios say what the port costs against bf16, not what FP4 silicon
gives (the paper: ~2.4× forward over FP8 on an RTX 5090).  Needs a CUDA
card; prints its name and power limit.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_kernel_speedups [--reps 15]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys

import torch

from repro_torch.core.quartet import QUARTET_CONFIG, quartet_linear

# Llama-7B linear shapes (M tokens, K, N): batch 64 x sequence 512, as Fig. 3
SHAPES = {
    "qkv_proj": (32768, 4096, 4096),
    "ffn_up": (32768, 4096, 11008),
    "ffn_down": (32768, 11008, 4096),
}
L2_FLUSH_BYTES = 50 * 2 ** 20


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, each after an L2
    flush (a write of 50 MB) and one warm-up call before them all."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_shape(m: int, k: int, n: int, reps: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5).to(torch.bfloat16)
    dy = torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16)
    qc = dataclasses.replace(QUARTET_CONFIG, use_kernels=True)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()

    def quartet_fwd():
        with torch.no_grad():
            quartet_linear(x, w, 7, qc)

    def quartet_train():
        y = quartet_linear(xg, wg, 7, qc)
        torch.autograd.grad(y, (xg, wg), dy)

    def bf16_fwd():
        torch.matmul(x, w)

    def bf16_train():
        y = torch.matmul(xg, wg)
        torch.autograd.grad(y, (xg, wg), dy)

    out = {"quartet_fwd_ms": median_ms(quartet_fwd, reps),
           "bf16_fwd_ms": median_ms(bf16_fwd, reps),
           "quartet_train_ms": median_ms(quartet_train, reps),
           "bf16_train_ms": median_ms(bf16_train, reps)}
    out["fwd_speedup_vs_bf16"] = out["bf16_fwd_ms"] / out["quartet_fwd_ms"]
    out["train_speedup_vs_bf16"] = out["bf16_train_ms"] / out["quartet_train_ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fig3_kernel_speedups: no CUDA device; this benchmark runs only on the GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    rows = {}
    for name, (m, k, n) in SHAPES.items():
        rows[name] = r = time_shape(m, k, n, args.reps)
        print(f"{name:10s} M={m} K={k} N={n}: forward {r['quartet_fwd_ms']:.3f} ms "
              f"(bf16 {r['bf16_fwd_ms']:.3f}, x{r['fwd_speedup_vs_bf16']:.3f}); forward + "
              f"backward {r['quartet_train_ms']:.3f} ms (bf16 {r['bf16_train_ms']:.3f}, "
              f"x{r['train_speedup_vs_bf16']:.3f})")
    print(json.dumps({"card": card_line(), "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
