"""Continuous-batching serving launcher: Poisson arrival workload.

Port of ``repro.launch.serve_engine`` for the dense family::

    python -m repro_torch.launch.serve_engine --arch qwen3-1.7b --requests 12 \
        [--decode-backend gather]

samples arrival times from a Poisson process, prompt lengths uniformly from
``[--min-prompt, --max-prompt]``, and drives the engine on a virtual clock:
each ``Engine.step`` advances time by its measured wall duration, and
requests are submitted the moment the clock passes their arrival time.
Weights are random, drawn from ``--seed``.  The Quartet linears run through
the Hopper kernels (``use_kernels=True``); the run is on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import init_params
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig


def poisson_workload(rng: np.random.Generator, n: int, rate: float,
                     min_prompt: int, max_prompt: int, max_new: int, vocab: int):
    """[(arrival_time, prompt, max_new)] with exponential inter-arrival gaps."""
    t, out = 0.0, []
    for _ in range(n):
        t += rng.exponential(1.0 / rate)
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        out.append((t, rng.integers(0, vocab, plen).astype(np.int32), max_new))
    return out


def run_workload(engine: Engine, workload, verbose: bool = True):
    """Drive the engine on a virtual clock; returns (requests, elapsed)."""
    pending = list(workload)
    clock, t0 = 0.0, time.perf_counter()
    while pending or engine.sched.pending:
        while pending and pending[0][0] <= clock:
            at, prompt, max_new = pending.pop(0)
            engine.submit(prompt, max_new, arrival_time=at)
        if not engine.sched.pending:  # idle gap: jump to the next arrival
            clock = pending[0][0]
            continue
        s0 = time.perf_counter()
        info = engine.step(now=clock)
        clock += time.perf_counter() - s0
        if verbose and info["step"] % 20 == 0:
            print(f"  step {info['step']:4d} t={clock:7.2f}s queued={info['queued']} "
                  f"prefill={info['prefilling']} decode={info['decoding']}")
    return engine.completed, time.perf_counter() - t0


def kernel_config(cfg):
    """The config with the Quartet linears routed through the kernels."""
    return dataclasses.replace(cfg, quartet=dataclasses.replace(cfg.quartet, use_kernels=True))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=4.0, help="arrivals per second")
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--kv", default="mxfp4", choices=["mxfp4", "dense"])
    ap.add_argument("--decode-backend", default=None, choices=["paged", "gather"],
                    help="paged: attend over the pool (default); gather: dense oracle")
    ap.add_argument("--method", default="quartet", choices=["quartet", "bf16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    cfg = kernel_config(get_reduced_config(args.arch) if args.reduced
                        else get_config(args.arch))
    model = build_model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, args.device)
    rng = np.random.default_rng(args.seed)
    workload = poisson_workload(rng, args.requests, args.rate, args.min_prompt,
                                args.max_prompt, args.max_new, cfg.vocab_size)
    engine = Engine(model, params, EngineConfig(
        n_slots=args.slots, max_len=args.max_len, page_size=args.page_size,
        kv_dtype=args.kv, prefill_chunk=args.prefill_chunk, method=args.method,
        decode_backend=args.decode_backend))
    done, elapsed = run_workload(engine, workload)

    total_tokens = sum(len(r.tokens) for r in done)
    ttfts = [r.ttft() for r in done]
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"\n{cfg.name} [{cfg.family}] kv={args.kv} decode={engine.decode_backend} "
          f"slots={args.slots} on {where}")
    print(f"  {len(done)} requests, {total_tokens} tokens in {elapsed:.2f}s wall "
          f"→ {total_tokens / elapsed:.1f} tok/s, mean TTFT {np.mean(ttfts):.3f}s "
          f"(virtual clock), KV pool {engine.cache_bytes()} bytes")


if __name__ == "__main__":
    main()
