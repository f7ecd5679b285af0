"""Serving launcher: a greedy round trip, on one device or on a TP/DP world.

Port of ``repro.launch.serve``::

    python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced --device cpu

generates ``--max-new`` tokens for a batch of random prompts with
``train.serve.greedy_generate`` (dense caches) under ``activate_mesh`` on
the local mesh, and prints the tokens and their rate.  Started as a world
of ranks with ``--tp`` / ``--dp``::

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --device cpu --tp 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch qwen3-1.7b --tp 2 --dp 2

it serves the same prompts through ``serve.replica.make_engine`` (paged
MXFP4 pool, ``EngineConfig.sharding``; NCCL on the card, gloo with
``--device cpu``), checks the tokens against the one-device engine's on
rank 0 when ``--check`` is given, and rank 0 prints them.  Weights are
random, drawn from ``--seed`` on every rank and broadcast from rank 0.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import init_params
from repro_torch.distributed.context import activate_mesh
from repro_torch.launch.mesh import init_distributed, make_local_mesh, world_rank
from repro_torch.launch.serve_engine import kernel_config, make_extra
from repro_torch.models import build_model
from repro_torch.train.serve import greedy_generate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--method", default="quartet")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks a replica")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel replicas")
    ap.add_argument("--check", action="store_true",
                    help="with --tp/--dp: hold the tokens against one device's engine")
    args = ap.parse_args()

    dev = torch.device(args.device)
    if "WORLD_SIZE" in os.environ:
        dev = init_distributed(device=args.device)
    elif args.tp * args.dp > 1:
        raise SystemExit(f"--tp {args.tp} --dp {args.dp} needs {args.tp * args.dp} ranks: "
                         f"start under torchrun --nproc-per-node {args.tp * args.dp}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if dev.type == "cuda":
        cfg = kernel_config(cfg)
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    gen = torch.Generator().manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                           dtype=torch.int32)

    if args.tp * args.dp == 1 and "WORLD_SIZE" not in os.environ:
        with activate_mesh(make_local_mesh()):
            t0 = time.time()
            out = greedy_generate(model, params, prompt.to(dev), max_new=args.max_new,
                                  max_len=args.prompt_len + args.max_new,
                                  extra=make_extra(cfg, args.seed, dev, args.batch),
                                  method=args.method).cpu()
        dt = time.time() - t0
        print(f"generated {tuple(out.shape)} in {dt:.2f}s "
              f"({args.batch * args.max_new / dt:.1f} tok/s)")
        print(out[:2])
        return

    from repro_torch.serve import EngineConfig, ShardingConfig, make_engine

    ecfg = EngineConfig(n_slots=args.batch, max_len=args.prompt_len + args.max_new,
                        method=args.method, sharding=ShardingConfig(args.tp, args.dp))
    eng = make_engine(model, params, ecfg)
    extra = make_extra(cfg, args.seed, dev)  # one source or image for every request
    t0 = time.time()
    for p in prompt.numpy():
        eng.submit(p, args.max_new, extra=extra, arrival_time=0.0)
    done = eng.drain()
    dt = time.time() - t0
    tokens = [r.tokens for r in done]
    pool_bytes = eng.cache_bytes()  # a collective of the world: every rank asks
    if args.check and world_rank() == 0:
        from repro_torch.serve import Engine

        one = Engine(model, params, EngineConfig(n_slots=args.batch,
                                                 max_len=args.prompt_len + args.max_new,
                                                 method=args.method))
        for p in prompt.numpy():
            one.submit(p, args.max_new, extra=extra)
        want = [r.tokens for r in sorted(one.drain(), key=lambda r: r.rid)]
        if tokens != want:
            raise SystemExit(f"tp {args.tp} x dp {args.dp} tokens differ from one device's")
        print("tokens equal one device's engine")
    if world_rank() == 0:
        print(f"tp {args.tp} x dp {args.dp}: {len(done)} requests x {args.max_new} tokens in "
              f"{dt:.2f}s ({len(done) * args.max_new / dt:.1f} tok/s), pool "
              f"{pool_bytes} bytes")
        print(tokens[:2])
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
