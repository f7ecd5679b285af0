"""Where a data-parallel MoE step's backward first parts from one
device's, on N cards.

    python3 tools/moe_dp_grad_probe.py [--rows 8] [--world 4]

Each rank (one process a card, NCCL over ``tcp://localhost``) runs one
Quartet train step of qwen3-moe-235b-a22b at full width, one layer, f32
master, on ``--rows`` x 512 tokens in ``--micro`` microbatches, once on the
whole batch (one device) and once at dp N on its rows (one group of 4096
tokens that every rank shares, at the defaults), with gradient
hooks on the layer's tensors: the residual stream after the layer, the MoE
FFN's output and input, the MoE block's input, and the gradient reaching
the router's logits.  For each it prints, per rank, how many elements of
the rank's rows differ between the two runs (0: bit for bit), in backward
order, so the first nonzero names the op where the runs part.
"""

import argparse
import dataclasses
import json
import os
import socket
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _rank(rank, world, init, rows, micro, out_dir):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["LOCAL_RANK"] = str(rank)
    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.distributed.context import activate_mesh
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as TM
    from repro_torch.optim.adamw import Optimizer
    from repro_torch.train.state import make_train_state
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import tree_map

    init_distributed(rank=rank, world_size=world, init_method=init)
    mesh = make_local_mesh()
    cfg = kernel_config(dataclasses.replace(get_config("qwen3-moe-235b-a22b"), num_layers=1))
    model = build_model(cfg)
    opt = Optimizer(lambda p: {"g": None},
                    lambda g, s, p: (tree_map(lambda t: t.new_zeros(()), g), {"g": g}))
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=0), rows, 512)
    rec: dict = {}
    block, ffn, softmax = TM.moe_block, TM.moe_ffn, TM.L.row_softmax

    def keep(name, t):
        if t.requires_grad:
            t.register_hook(lambda gr, name=name: rec.__setitem__(name, gr.detach().clone()))

    def hooked_block(params, x, *a, **k):
        keep("2 moe_block input", x)
        out, aux = block(params, x, *a, **k)
        keep("0 moe_block output", out)
        return out, aux

    def hooked_ffn(params, x, *a, **k):
        keep("1b moe_ffn input", x)
        y, aux = ffn(params, x, *a, **k)
        keep("1a moe_ffn output", y)
        return y, aux

    def hooked_softmax(logits):  # the router's softmax alone calls it
        keep("1c router logits (the group's, gathered)", logits)
        return softmax(logits)

    TM.moe_block, TM.moe_ffn, TM.L.row_softmax = hooked_block, hooked_ffn, hooked_softmax
    runs = {}
    for name, on_mesh in (("one", False), ("dp", True)):
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        specs = None
        if on_mesh:
            from repro_torch.distributed import sharding as SH

            specs = SH.param_partition(params, mesh)
            params = SH.shard_tree(params, specs, mesh)
        state = make_train_state(params, opt)
        del params
        step = make_train_step(model, opt, microbatch=micro, param_specs=specs, loss_chunk=128)
        b = batcher.batch(0) if not on_mesh else batcher.rank_batch(0, rank, world, micro)
        batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        rec.clear()
        if on_mesh:
            with activate_mesh(mesh):
                step(state, batch)
        else:
            step(state, batch)
        runs[name] = dict(rec)
        del state
        torch.cuda.empty_cache()
    out = {}
    per = rows // micro // world  # a rank's rows of the (last) microbatch
    for key in sorted(runs["dp"]):
        a, b = runs["one"][key], runs["dp"][key]
        if "logits" in key:  # [G, g, E] of one group shared by every rank: its rows
            t = per * 512
            a, b = a[:, rank * t:(rank + 1) * t], b[:, rank * t:(rank + 1) * t]
        elif a.shape != b.shape:  # the rank's rows of one device's tensor
            a = a[rank * per:(rank + 1) * per]
        out[key] = {"shape": list(b.shape), "differ": int((a != b).sum()) if a.shape == b.shape
                    else f"shapes {list(a.shape)} vs {list(b.shape)}",
                    "max_abs": float((a - b).abs().max()) if a.shape == b.shape else None}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()


def main():
    import tempfile

    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = tempfile.mkdtemp()
    mp.start_processes(_rank, args=(args.world, f"tcp://localhost:{port}", args.rows,
                                    args.micro, out_dir), nprocs=args.world, start_method="spawn")
    for r in range(args.world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            print(f"rank {r}: {fh.read()}")


if __name__ == "__main__":
    main()
