"""Ranks of a gloo world for the port's data-parallel training tests
(``tests/test_torch_dp_*.py``).

The ranks start through ``_tp_ranks.start(..., script=__file__)``: each is
a fresh interpreter joined to a gloo world over a ``FileStore`` in the
test's ``tmp_path``, running one function of this module.  This module
imports torch and the port only (no JAX), so a rank starts in about 3 s.
The one-device runs in the test process share :func:`step_grads` with the
ranks, so both sides run the same step on the same weights and rows.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys

import numpy as np
import torch

import _tp_ranks as R

VOCAB, SEQ, BATCH, MICRO = 512, 16, 8, 2  # a rank's microbatch: 2 rows, 32 tokens


def start(tmp_path, world: int, fn: str, *args, limit_s: float = 120):
    return R.start(tmp_path, world, fn, *args, limit_s=limit_s, script=__file__)


def tiny_cfg(dtype: str = "float32", fp4: bool = False, kernels: bool = False):
    """The reduced Llama (2 layers, d 128, vocab 512) in ``dtype``; with
    ``kernels`` the Quartet linears take the kernel path (on the CPU, the
    kernels' plain versions)."""
    from repro_torch.configs import llama_paper as TLP

    cfg = dataclasses.replace(TLP.tiny_llama(d=128, layers=2, vocab=VOCAB), dtype=dtype)
    return dataclasses.replace(cfg, quartet=dataclasses.replace(
        cfg.quartet, fp4_allgather=fp4, use_kernels=kernels))


def grad_opt():
    """An optimizer whose state holds the step's (clipped) f32 gradients
    and whose updates are zero: the step's gradients, read from its state."""
    from repro_torch.optim.adamw import Optimizer
    from repro_torch.tree import tree_map

    def init(params):
        return {"g": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32), params)}

    def update(grads, state, params):
        return (tree_map(torch.zeros_like, grads),
                {"g": tree_map(lambda g: g.to(torch.float32), grads)})

    return Optimizer(init, update)


def xla_cpu_hadamard(x: torch.Tensor, g: int = 32, dim: int = -1) -> torch.Tensor:
    """``test_torch_numerics.xla_cpu_hadamard`` (the grouped Hadamard in the
    reference's CPU summation order), here without JAX."""
    from repro_torch.core import hadamard as TH

    x = torch.movedim(x, dim, -1)
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // g, g).to(torch.float64)
    h = torch.as_tensor(TH.hadamard_matrix(g), dtype=torch.float64)
    acc = [torch.zeros(xb.shape, dtype=torch.float32) for _ in range(2)]
    for i in range(g):
        acc[i % 2] = (acc[i % 2].to(torch.float64) + xb[..., i:i + 1] * h[i]).to(torch.float32)
    return torch.movedim((acc[0] + acc[1]).reshape(x.shape).to(x.dtype), -1, dim)


def use_reference_dot_order() -> None:
    """``test_torch_numerics.use_reference_dot_order`` for a rank's process
    (which exits after its one function)."""
    import repro_torch.core.hadamard as TH
    import repro_torch.core.quartet as TQ

    TH.hadamard_transform = TQ.hadamard_transform = xla_cpu_hadamard


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def paths(tree, prefix=""):
    """{path: numpy leaf} of a tree of tensors."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in paths(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree.detach().to(torch.float32).numpy()}


def step_grads(params, batch, *, microbatch=MICRO, dtype="float32", fp4=False, kernels=False,
               method="quartet"):
    """One train step of the reduced Llama from ``params`` (whole, numpy or
    torch) on ``batch`` (this rank's rows under a mesh) → (loss, grad-norm,
    {path: the step's clipped gradient, a rank's shard under a mesh},
    {path: the dim it is split along}, the kernel-wrapper launches)."""
    from repro_torch.distributed import context as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.state import make_train_state
    from repro_torch.train.steps import make_train_step, training_mesh

    cfg = tiny_cfg(dtype, fp4, kernels)
    model = build_model(cfg)
    if not isinstance(_first(params), torch.Tensor):
        params = to_torch(params)
    mesh = training_mesh()
    specs, dims = None, {}
    if mesh is not None:
        specs = SH.param_partition(params, mesh)
        dims = C.make_plan(mesh, specs).dims
        params = SH.shard_tree(params, specs, mesh)
    opt = grad_opt()
    state = make_train_state(params, opt, "float32")
    step = make_train_step(model, opt, method=method, microbatch=microbatch,
                           param_specs=specs)
    ops.reset_launch_counts()
    state, m = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    return (float(m["loss"]), float(m["grad_norm"]), paths(state.opt_state["g"]), dims,
            ops.launch_counts())


def _first(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def rank_rows(batch: dict, microbatch: int = MICRO) -> dict:
    """This rank's rows of a global batch (``data.pipeline.rank_rows``)."""
    from repro_torch.data.pipeline import rank_rows as rows
    from repro_torch.launch.mesh import world_rank, world_size

    idx = rows(len(batch["tokens"]), microbatch, world_rank(), world_size())
    return {k: np.asarray(v)[idx] for k, v in batch.items()}


def dp_steps(params, batch, runs, ref_order=False):
    """The rank work of a data-parallel step: ``step_grads`` under
    ``make_local_mesh()`` for each keyword set in ``runs``."""
    from repro_torch.distributed.context import activate_mesh
    from repro_torch.launch.mesh import make_local_mesh

    if ref_order:
        use_reference_dot_order()
    mesh = make_local_mesh()
    with activate_mesh(mesh):
        return [step_grads(params, rank_rows(batch, kw.get("microbatch", MICRO)), **kw)
                for kw in runs]


def dp_checkpoint(whole_dir: str, part_dir: str) -> dict:
    """``train.loop.train`` at dp 2 for 2 steps (checkpoint every step),
    then: a fresh state restored from its last checkpoint against the
    trained shards; a run in ``part_dir`` holding only step 1's checkpoint
    (as if killed after it) to step 2 (it resumes), against the unbroken
    run."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.context import activate_mesh
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train
    from repro_torch.train.state import make_train_state

    cfg = tiny_cfg()
    model = build_model(cfg)
    opt = adamw(cosine_warmup(1e-3, 10))
    batcher = TokenBatcher(SyntheticC4Dataset(VOCAB, seed=0), BATCH, SEQ)

    def params():
        return init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def run(d, steps):
        return train(model, opt, batcher, steps, microbatch=MICRO, device="cpu",
                     params=params(), checkpoint_dir=d, checkpoint_every=1, log_every=0)

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, tuple):
            return [x for c in t for x in leaves(c)]
        return [t]

    def same(a, b):
        la, lb = leaves(a), leaves(b)
        return len(la) == len(lb) and all(
            torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))

    mesh = make_local_mesh()
    with activate_mesh(mesh):
        state, hist = run(whole_dir, 2)
        specs = SH.param_partition(params(), mesh)
        like = make_train_state(SH.shard_tree(params(), specs, mesh), opt)
        restored, _ = Checkpointer(whole_dir).restore(
            like, shardings=(mesh, SH.partition_state(like, specs, mesh)))
        # a run killed after step 1's checkpoint: its directory holds that
        # checkpoint alone; started again, it resumes there
        if torch.distributed.get_rank() == 0:
            shutil.copytree(os.path.join(whole_dir, "step_000000001"),
                            os.path.join(part_dir, "step_000000001"))
        torch.distributed.barrier()
        resumed, hist2 = run(part_dir, 2)
        return {"loss": [h["loss"] for h in hist], "steps": [h["step"] for h in hist],
                "resumed_steps": [h["step"] for h in hist2],
                "restored_equal": same(restored, state), "resumed_equal": same(resumed, state),
                "whole": paths(SH.unshard_tree(state.params, specs, mesh)),
                "whole_mu": paths(SH.unshard_tree(state.opt_state["mu"], specs, mesh))}


def unshard(shards: list[dict], dims: dict) -> dict:
    """The whole gradients from every rank's {path: shard}, rank order."""
    return {p: (shards[0][p] if dims[p] is None
                else np.concatenate([s[p] for s in shards], axis=dims[p])) for p in shards[0]}


if __name__ == "__main__":
    sys.exit(R._rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                          float(sys.argv[5]), globals()))
