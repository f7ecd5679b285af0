"""Serving example: the continuous-batching engine on mixed prompt lengths
with staggered arrivals, for any architecture family.

The port's twin of ``examples/serve_batched.py``::

    PYTHONPATH=src python -m repro_torch.examples.serve_batched             # dense arch, FP4 KV pages
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --kv dense  # the token check
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --spec ngram --spec-k 4
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu

Requests arrive over the first few engine steps (not all at once), prompts
range from 6 to 30 tokens, and there are more requests than decode slots —
so the run exercises queueing, chunked prefill riding alongside in-flight
decodes, retirement, and slot/page recycling.  The engine's own telemetry
reports the run (queue depths, TTFT/TPOT percentiles, pool occupancy, FP4
clip and scale health sampled every 4 ticks).  With a dense pool (``--kv
dense``, or a family whose engine keeps dense state) each request's tokens
are held against the argmax of the model's teacher-forced forward of the
prompt and the tokens before them (the repo's token oracle;
``greedy_generate`` is not one: ROADMAP C1).  Weights are random, from seed
0, at the reduced size; the run is on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params
from repro_torch.launch.serve_engine import kernel_config, make_extra
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, SpecConfig, TelemetryConfig
from repro_torch.serve.spec import aggregate_stats
from repro_torch.train.serve import cast_params


def teacher_forced_tokens(model, params, prompt, tokens, extra, method: str) -> list[int]:
    """Argmax of the cache-free forward over prompt + tokens[:-1] at the
    positions that emitted ``tokens`` (params cast as the serving steps cast
    them)."""
    cp = cast_params(params, getattr(torch, model.cfg.dtype))
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
    dev = params["embed"]["table"].device
    with torch.inference_mode():
        logits, _ = model.forward(cp, torch.from_numpy(seq)[None].to(dev), 0, extra=extra,
                                  method=method)
    return logits[0, prompt.size - 1:].argmax(-1).tolist()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--kv", default="mxfp4", choices=["mxfp4", "dense"])
    ap.add_argument("--method", default="quartet", choices=["quartet", "bf16"])
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged families: radix prefix cache with copy-on-write — prompts get "
                         "a shared 16-token system prefix so later admissions alias its pages "
                         "and prefill only their unique tail")
    ap.add_argument("--spec", default=None, choices=["self", "ngram"],
                    help="speculative decoding proposer (paged families)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--metrics-out", default=None,
                    help="stream telemetry snapshots as JSON lines here")
    ap.add_argument("--trace-out", default=None,
                    help="write per-request span traces as JSON lines here")
    ap.add_argument("--profile-out", default=None,
                    help="profile the run: roofline/bandwidth gauges and a Chrome trace-event "
                         "JSON written here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")

    cfg = kernel_config(get_reduced_config(args.arch))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device=args.device).manual_seed(0), args.device)
    rng = np.random.default_rng(0)
    extra = make_extra(cfg, 0, args.device)

    spec = SpecConfig(k=args.spec_k, proposer=args.spec) if args.spec is not None else None
    engine = Engine(model, params, EngineConfig(
        n_slots=args.slots, max_len=48, page_size=8, kv_dtype=args.kv, prefill_chunk=8,
        method=args.method, prefix_cache=args.prefix_cache, spec=spec,
        telemetry=TelemetryConfig(metrics_path=args.metrics_out, trace_path=args.trace_out,
                                  profile_trace_path=args.profile_out, quant_stride=4)))

    # mixed prompt lengths, arrivals staggered over the first steps
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(6, 31))).astype(np.int32)
               for _ in range(args.requests)]
    if args.prefix_cache:
        # a shared system prefix (two full pages): the first request to
        # retire publishes its pages, later admissions alias them
        system = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
        prompts = [np.concatenate([system, p]) for p in prompts]
    arrive_at_step = sorted(int(rng.integers(0, 4)) for _ in range(args.requests))

    t0 = time.time()
    handles, next_req = [], 0
    while next_req < len(prompts) or engine.sched.pending:
        while next_req < len(prompts) and arrive_at_step[next_req] <= engine.steps:
            handles.append(engine.submit(prompts[next_req], args.max_new, extra=extra,
                                         arrival_time=float(engine.steps)))
            next_req += 1
        info = engine.step(now=float(engine.steps))
        print(f"step {info['step']:3d}: queued={info['queued']} "
              f"prefill={info['prefilling']} decode={info['decoding']}")
    dt = time.time() - t0

    total = sum(len(h.tokens) for h in handles)
    print(f"\n{cfg.name} [{cfg.family}] kv={args.kv if engine.paged else engine.decode_backend}"
          f" on {torch.cuda.get_device_name(0) if args.device == 'cuda' else 'cpu'}: "
          f"{len(handles)} requests ({min(p.size for p in prompts)}–"
          f"{max(p.size for p in prompts)} prompt tokens) → {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    # the engine's telemetry reports the run: queue depths, TTFT/TPOT
    # percentiles, pool occupancy and FP4 clip/scale health
    engine.telemetry.finalize()
    print(engine.telemetry.summary())
    if engine.prefix is not None:
        c = engine.telemetry.registry.counter
        print(f"prefix cache: {c('prefix_hit_requests').value}/{c('prefix_lookups').value} "
              f"admissions hit, {c('prefix_shared_tokens').value} prompt tokens aliased, "
              f"{c('prefix_cow_pages').value} COW pages, {engine.prefix.cached_pages()} "
              f"pages cached")
    for label, path in (("metrics", args.metrics_out), ("traces", args.trace_out),
                        ("profile trace", args.profile_out)):
        if path:
            print(f"{label} → {path}")
    if spec is not None:
        agg = aggregate_stats(handles)
        print(f"spec[{args.spec}, k={args.spec_k}]: {agg['tokens_per_decode_call']} "
              f"tokens/verify-call, acceptance {agg['acceptance_rate']}")
    for h in handles[:3]:
        print(f"  req {h.rid}: prompt[{h.prompt_len}] -> {h.tokens}")

    parity = None
    if args.kv == "dense" or engine.decode_backend == "dense_slots":
        parity = all(h.tokens == teacher_forced_tokens(model, params, h.prompt, h.tokens, extra,
                                                       args.method)
                     for h in handles)
        print("token-for-token parity vs the teacher-forced forward's argmax:", parity)
    return {"handles": handles, "engine": engine, "parity": parity}


if __name__ == "__main__":
    main()
