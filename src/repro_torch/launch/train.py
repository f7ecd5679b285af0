"""Training launcher::

    python -m repro_torch.launch.train --arch llama-paper-200m --steps 5 \\
        --batch 32 --seq 512 --microbatch 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch llama-paper-7b --steps 3 --batch 32 --seq 512 --microbatch 2

Port of ``repro.launch.train``.  Under ``torchrun`` (``WORLD_SIZE`` set)
each process joins the world as one rank (NCCL on ``cuda:LOCAL_RANK``, or
gloo with ``--device cpu``) and trains under ``make_local_mesh()``, as the
reference's launcher does: every rank on ``data``, FSDP data parallelism
(``train.loop``), ``--batch`` the global batch; ``--production-mesh``
takes the reference's 16 × 16 layout and raises below 256 ranks.  Trains ``--arch`` (any
config of the registry: the paper's Llama family, the other dense configs,
MoE, SSM, hybrid, enc-dec or VLM; ``--reduced`` for its CPU-scale
stand-in) from random weights drawn from ``--seed`` on synthetic
C4-like data (or a memmap token file, ``--data``), with AdamW on a cosine
schedule with 10% warmup at the paper's learning rate.  ``--opt8bit``
takes the 8-bit AdamW and a bf16 master, as the reference trains its large
MoE configs (one full-width qwen3-moe-235b-a22b layer fits one card only
so; under ``torchrun`` across data ranks, its shards of the 8-bit moments).
``--layers`` cuts the depth to the first N layers at the published widths
(qwen3-moe-235b-a22b's 94 layers hold 234 B parameters).  ``--method``
takes Quartet, bf16 or one of the paper's baselines
(``luq_int4``, ``luq_fp4``, ``jetfire_fp4``, ``halo_fp4``, ``lss_int4``;
plain PyTorch, as the reference computes them); ``--grad-compress`` adds the
SR-int8 gradient round trip with error feedback.  On ``cuda`` (the
default) the Quartet linears run on the Hopper kernels; without a GPU it
exits non-zero unless ``--device cpu`` is given,
which runs the kernels' plain versions.  As in the reference, no source
or image is drawn here: an enc-dec arch raises the encoder's error for want
of ``source_embeds``, and a VLM's cross blocks, given no ``image_embeds``,
attend over the text itself; ``train.loop.train(extra_batch=...)`` trains
either with its conditioning.  With ``--checkpoint-dir`` the
state is saved every ``--checkpoint-every`` steps and at the end; the same
command started again resumes from the latest checkpoint there.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.llama_paper import LEARNING_RATES
from repro_torch.core.baselines import BASELINE_METHODS
from repro_torch.data.pipeline import TokenBatcher, make_dataset
from repro_torch.distributed.context import activate_mesh
from repro_torch.launch.mesh import (init_distributed, make_local_mesh, make_production_mesh,
                                     world_rank, world_size)
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model
from repro_torch.optim import adamw, adamw8bit, cosine_warmup
from repro_torch.train.loop import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-paper-200m")
    ap.add_argument("--reduced", action="store_true", help="the CPU-scale config")
    ap.add_argument("--layers", type=int, default=None,
                    help="the first N layers (the depth cut, widths unchanged)")
    ap.add_argument("--method", default="quartet", choices=["quartet", "bf16", *BASELINE_METHODS])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true",
                    help="SR-int8 gradient round trip with error feedback")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--opt8bit", action="store_true",
                    help="8-bit AdamW moments and a bf16 master")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--fp4-allgather", action="store_true",
                    help="FSDP weights cross the ranks as MXFP4 codes (QuartetConfig)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's 16 x 16 mesh (needs 256 ranks)")
    args = ap.parse_args()

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    device = args.device
    if "WORLD_SIZE" in os.environ:
        device = init_distributed(device=args.device)
    mesh = make_production_mesh() if args.production_mesh else make_local_mesh()
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.device == "cuda":
        cfg = kernel_config(cfg)
    if args.fp4_allgather:
        cfg = dataclasses.replace(cfg, quartet=dataclasses.replace(cfg.quartet,
                                                                   fp4_allgather=True))
    model = build_model(cfg)
    lr = args.lr or LEARNING_RATES.get(args.arch, 3e-4)
    opt = (adamw8bit if args.opt8bit else adamw)(cosine_warmup(lr, args.steps))
    batcher = TokenBatcher(make_dataset(args.data, cfg.vocab_size), args.batch, args.seq)
    t0 = time.perf_counter()
    with activate_mesh(mesh):
        _, history = train(model, opt, batcher, args.steps, method=args.method,
                           master_dtype="bfloat16" if args.opt8bit else "float32",
                           microbatch=args.microbatch, seed=args.seed, device=device,
                           checkpoint_dir=args.checkpoint_dir,
                           checkpoint_every=args.checkpoint_every,
                           grad_compress=args.grad_compress, log_every=1)
    wall = time.perf_counter() - t0
    rank, ranks = world_rank(), world_size()
    if ranks > 1:
        torch.distributed.destroy_process_group()
    if rank != 0:
        return
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    if ranks > 1:
        where = f"{ranks} x {where} (data parallel)"
    if not history:
        print(f"\n{cfg.name}: nothing to run, the checkpoint is at step {args.steps}")
        return
    tokens = len(history) * args.batch * args.seq
    print(f"\n{cfg.name}: steps {history[0]['step']}..{history[-1]['step']} x {args.batch} x "
          f"{args.seq} tokens on {where}, {wall:.2f} s wall (init included) -> "
          f"{tokens / wall:.1f} tok/s; final loss {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
