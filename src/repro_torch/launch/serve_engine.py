"""Continuous-batching serving launcher: Poisson arrival workload.

Port of ``repro.launch.serve_engine``::

    python -m repro_torch.launch.serve_engine --arch qwen3-1.7b --requests 12 \
        [--decode-backend gather]
    python -m repro_torch.launch.serve_engine --arch falcon-mamba-7b \
        [--decode-backend dense_slots]
    python -m repro_torch.launch.serve_engine --arch zamba2-7b \
        [--decode-backend dense_slots]
    python -m repro_torch.launch.serve_engine --arch whisper-tiny \
        [--decode-backend dense_slots] [--prefix-cache]
    python -m repro_torch.launch.serve_engine --arch llama-3.2-vision-11b

samples arrival times from a Poisson process, prompt lengths uniformly from
``[--min-prompt, --max-prompt]``, and drives the engine on a virtual clock:
each ``Engine.step`` advances time by its measured wall duration, and
requests are submitted the moment the clock passes their arrival time.
Weights are random, drawn from ``--seed``; an enc-dec or VLM workload's
conditioning (one source or image for every request, bf16 standard
normals, :func:`make_extra`) too, so under ``--prefix-cache`` the requests
share its encoded cross-KV.  The Quartet linears run through
the Hopper kernels (``use_kernels=True``); the run is on the card unless
``--device cpu`` is given.

``--spec {self,ngram,draft} --spec-k 4`` turns on speculative decoding
(``--draft-arch`` names the draft model of the ``draft`` proposer) and
reports tokens per verify call and draft acceptance;
``--temperature/--top-k/--top-p/--sample-seed`` turn on per-request
sampling; ``--prefix-cache`` shares the pages of cached prompt prefixes
(``--debug-cache`` audits the allocator after every mutation).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import init_params
from repro_torch.core.quartet import check_kernel_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, SamplingParams, SpecConfig
from repro_torch.serve.spec import aggregate_stats

STATE = ("statepool", "dense_slots")


def make_extra(cfg, seed: int, device, batch: int = 1):
    """A request's conditioning: an enc-dec model's ``source_embeds``
    [batch, max_source_len, d] or a VLM's ``image_embeds`` [batch,
    num_image_tokens, d], bf16 standard normals drawn from ``seed``; None
    for the other families."""
    n = {"encdec": cfg.max_source_len, "vlm": cfg.num_image_tokens}.get(cfg.family)
    if n is None:
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, n, cfg.d_model), generator=gen, device=device)
    key = "source_embeds" if cfg.family == "encdec" else "image_embeds"
    return {key: x.to(torch.bfloat16)}


def poisson_workload(rng: np.random.Generator, n: int, rate: float,
                     min_prompt: int, max_prompt: int, max_new: int, vocab: int):
    """[(arrival_time, prompt, max_new)] with exponential inter-arrival gaps."""
    t, out = 0.0, []
    for _ in range(n):
        t += rng.exponential(1.0 / rate)
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        out.append((t, rng.integers(0, vocab, plen).astype(np.int32), max_new))
    return out


def run_workload(engine: Engine, workload, extra=None, verbose: bool = True, sampling=None):
    """Drive the engine on a virtual clock, every request with the
    conditioning ``extra``; returns (requests, elapsed)."""
    pending = list(workload)
    clock, t0 = 0.0, time.perf_counter()
    while pending or engine.sched.pending:
        while pending and pending[0][0] <= clock:
            at, prompt, max_new = pending.pop(0)
            engine.submit(prompt, max_new, extra=extra, arrival_time=at, sampling=sampling)
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
    """The config with the Quartet linears routed through the kernels; raises
    on a Quartet variant the kernels do not compute."""
    qc = dataclasses.replace(cfg.quartet, use_kernels=True)
    check_kernel_config(qc)
    return dataclasses.replace(cfg, quartet=qc)


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
    ap.add_argument("--decode-backend", default=None,
                    choices=["paged", "gather", "statepool", "dense_slots"],
                    help="dense/MoE: paged (attend over the pool, default) or gather (the "
                         "dense oracle); SSM, hybrid, enc-dec and VLM: statepool (quantized "
                         "state rings, a paged KV plane, a cross-KV plane; default) or "
                         "dense_slots (the oracle)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache: admissions alias the pages of cached shared "
                         "prefixes (copy-on-write, LRU-evicted) and prefill only the tail; "
                         "enc-dec/VLM on statepool: requests with the same conditioning "
                         "share its encoded cross-KV pages")
    ap.add_argument("--debug-cache", action="store_true",
                    help="check the page allocator's invariants after every pool mutation")
    ap.add_argument("--method", default="quartet", choices=["quartet", "bf16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # speculative decoding
    ap.add_argument("--spec", default=None, choices=["self", "ngram", "draft"],
                    help="enable speculative decoding with this proposer")
    ap.add_argument("--spec-k", type=int, default=4, help="drafted tokens per verify call")
    ap.add_argument("--ngram", type=int, default=2, help="ngram proposer: suffix length")
    ap.add_argument("--draft-arch", default=None,
                    help="draft proposer: registry arch of the draft model")
    # per-request sampling (greedy argmax when temperature is 0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=0)
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
    spec = None
    if args.spec is not None:
        spec = SpecConfig(k=args.spec_k, proposer=args.spec, ngram=args.ngram,
                          draft_arch=args.draft_arch, draft_reduced=args.reduced)
    sampling = None
    if args.temperature > 0:
        sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                  top_p=args.top_p, seed=args.sample_seed)
    elif args.top_k or args.top_p < 1.0 or args.sample_seed:
        ap.error("--top-k/--top-p/--sample-seed require --temperature > 0 "
                 "(temperature 0 is greedy argmax and ignores them)")
    engine = Engine(model, params, EngineConfig(
        n_slots=args.slots, max_len=args.max_len, page_size=args.page_size,
        kv_dtype=args.kv, prefill_chunk=args.prefill_chunk, method=args.method,
        decode_backend=args.decode_backend, prefix_cache=args.prefix_cache,
        debug_cache=args.debug_cache, spec=spec))
    done, elapsed = run_workload(engine, workload, extra=make_extra(cfg, args.seed, args.device),
                                 sampling=sampling)

    total_tokens = sum(len(r.tokens) for r in done)
    ttfts = [r.ttft() for r in done]
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"\n{cfg.name} [{cfg.family}] kv={args.kv} decode={engine.decode_backend} "
          f"slots={args.slots} on {where}"
          + (f" spec={args.spec}(k={args.spec_k})" if spec else ""))
    print(f"  {len(done)} requests, {total_tokens} tokens in {elapsed:.2f}s wall "
          f"→ {total_tokens / elapsed:.1f} tok/s, mean TTFT {np.mean(ttfts):.3f}s "
          f"(virtual clock), {'state' if engine.decode_backend in STATE else 'KV pool'} "
          f"{engine.cache_bytes()} bytes")
    if engine.decode_backend == "statepool":
        planes = {}
        for kind, plane in engine.cache.planes():
            planes[kind] = planes.get(kind, 0) + plane.cache_bytes()
        print("  planes: " + ", ".join(f"{k} {v} bytes" for k, v in planes.items()))
    if spec is not None:
        agg = aggregate_stats(done)
        print(f"  spec: {agg['tokens_per_decode_call']} tok/verify-call, "
              f"acceptance {agg['acceptance_rate']} "
              f"({agg['drafts_accepted']}/{agg['drafts_proposed']} drafts)")
    if args.prefix_cache or "cross_encode_calls" in engine.counters:
        print(f"  counters: {engine.counters}")


if __name__ == "__main__":
    main()
