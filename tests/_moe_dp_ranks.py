"""Ranks of a gloo world for the port's MoE data-parallel training tests
(``tests/test_torch_moe_dp_*.py``).

The ranks start through ``_tp_ranks.start(..., script=__file__)``, as
``_dp_ranks`` starts them: each a fresh interpreter joined to a gloo world
over a ``FileStore`` in the test's ``tmp_path``, running one function of
this module.  This module imports torch and the port only (no JAX).  The
one-device runs in the test process share :func:`moe_step` and
:func:`ffn_grads` with the ranks, so both sides run the same code on the
same weights and rows.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

import _dp_ranks as D
import _tp_ranks as R

ARCH = "qwen3-moe-235b-a22b"
SEQ = 32


def start(tmp_path, world: int, fn: str, *args, limit_s: float = 120):
    return R.start(tmp_path, world, fn, *args, limit_s=limit_s, script=__file__)


def moe_cfg(arch: str = ARCH, dtype: str = "float32", fp4: bool = False):
    """The reduced MoE config (2 layers, d 128, 8 experts top-2, vocab
    512) in ``dtype``, with ``fp4_allgather`` on or off."""
    from repro_torch.configs import get_reduced_config

    cfg = get_reduced_config(arch, dtype=dtype)
    return dataclasses.replace(cfg, quartet=dataclasses.replace(cfg.quartet, fp4_allgather=fp4))


def _numpy(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def ffn_grads(params, x, r, seed: int, method: str, group_tokens: int, arch: str = ARCH):
    """``moe_ffn`` on this rank's rows of x [B, S, D] (all of them without
    a plan) → (y, aux, the gradients of ⟨y, r⟩ + 0.3·aux with respect to x
    and every parameter leaf in ``tree_leaves`` order, and the recorded
    routing (first group, sel_idx, sel_gate)), as numpy."""
    from repro_torch.models import moe as TM
    from repro_torch.tree import tree_leaves, tree_unflatten

    params = D.to_torch(params)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
    with TM.recording_routing() as log:
        y, aux = TM.moe_ffn(tree_unflatten(params, leaves), xt, seed, moe_cfg(arch), method,
                            group_tokens=group_tokens)
    grads = torch.autograd.grad((y * torch.from_numpy(np.ascontiguousarray(r))).sum()
                                + 0.3 * aux, [xt, *leaves])
    (first, sel_idx, sel_gate), = log.values()
    return (_numpy(y), float(aux.detach()), [_numpy(g) for g in grads],
            (first, sel_idx.numpy(), sel_gate.numpy()))


def ffn_ranks(cases: list[dict]) -> list:
    """The rank work of the ``moe_ffn`` tests: ``ffn_grads`` under a
    two-rank plan (this rank's contiguous rows of x and r) for each case
    (its ``params``, ``x``, ``r``, ``seed``, ``method``, ``group_tokens``,
    ``arch`` and ``ref_order``)."""
    from repro_torch.distributed import context as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh()
    rank, n = SH.data_rank_and_size(mesh)
    out = []
    for case in cases:
        if case["ref_order"]:
            D.use_reference_dot_order()
        x, r = case["x"], case["r"]
        b = x.shape[0] // n
        rows = slice(rank * b, (rank + 1) * b)
        plan = C.make_plan(mesh, SH.param_partition(D.to_torch(case["params"]), mesh))
        plan.rows = x.shape[0]
        with C.activate_mesh(mesh), C.fsdp_plan(plan):
            out.append(ffn_grads(case["params"], x[rows], r[rows], case["seed"], case["method"],
                                 case["group_tokens"], case["arch"]))
    return out


def moe_step(params, batch, *, arch: str = ARCH, method: str = "quartet", fp4: bool = False,
             microbatch: int = 1, opt: str = "grad"):
    """Train steps of the reduced MoE from ``params`` (whole) on ``batch``
    (this rank's rows under a mesh; a list of batches, one a step), the
    step's optimizer the
    gradient keeper (``opt="grad"``) or the 8-bit AdamW with a bf16 master
    (``"8bit"``) → (losses, grad-norms, auxes, {path: the last step's state
    leaf, a rank's shard under a mesh}, {param path: its split dim},
    launches, routing {seed: (first group, sel_idx)})."""
    from repro_torch.distributed import context as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models import moe as TM
    from repro_torch.optim import adamw8bit
    from repro_torch.train.state import make_train_state
    from repro_torch.train.steps import make_train_step, training_mesh

    model = build_model(moe_cfg(arch, fp4=fp4))
    params = D.to_torch(params)
    mesh = training_mesh()
    specs, dims, shardings = None, {}, None
    if mesh is not None:
        specs = SH.param_partition(params, mesh)
        dims = C.make_plan(mesh, specs).dims
        params = SH.shard_tree(params, specs, mesh)
        shardings = (mesh, specs)
    optimizer = D.grad_opt() if opt == "grad" else adamw8bit(1e-3)
    master = "float32" if opt == "grad" else "bfloat16"
    state = make_train_state(params, optimizer, master, shardings=shardings)
    step = make_train_step(model, optimizer, method=method, microbatch=microbatch,
                           param_specs=specs)
    ops.reset_launch_counts()
    losses, gnorms, auxes = [], [], []
    with TM.recording_routing() as log:
        for b in batch if isinstance(batch, list) else [batch]:
            state, m = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            auxes.append(float(m["aux"]))
    leaves = D.paths(state.opt_state["g"]) if opt == "grad" else _state_paths(state)
    routing = {s: (first, idx.numpy()) for s, (first, idx, _) in log.items()}
    return losses, gnorms, auxes, leaves, dims, ops.launch_counts(), routing


def _state_paths(state) -> dict:
    """{path: numpy} of a state's parameters and 8-bit moments (int8 codes
    as int8, scales and parameters as f32)."""
    out = {f"params/{p}": v for p, v in D.paths(state.params).items()}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], f"{prefix}{k}/")
        elif isinstance(tree, torch.Tensor):
            out[prefix[:-1]] = (tree.numpy() if tree.dtype == torch.int8
                                else tree.detach().to(torch.float32).numpy())

    walk({k: state.opt_state[k] for k in ("mu", "nu")}, "")
    return out


def moe_step_ranks(params, batch, runs: list[dict], ref_order: bool = False,
                   microbatch: int = 1) -> list:
    """The rank work of a data-parallel MoE step: :func:`moe_step` under
    ``make_local_mesh()`` on this rank's rows, for each keyword set in
    ``runs``."""
    from repro_torch.distributed.context import activate_mesh
    from repro_torch.launch.mesh import make_local_mesh

    if ref_order:
        D.use_reference_dot_order()
    mesh = make_local_mesh()
    with activate_mesh(mesh):
        rows = ([D.rank_rows(b, microbatch) for b in batch] if isinstance(batch, list)
                else D.rank_rows(batch, microbatch))
        return [moe_step(params, rows, microbatch=microbatch, **kw) for kw in runs]


# 8-bit AdamW leaves by how a rank's shard meets the blocks of 256 along
# the last axis at dp 2: split on a leading dim; on the last into whole
# blocks (4 blocks, 2 a rank); into a block count the ranks do not divide
# (3 blocks, kept whole); into halves that straddle a block (1000 = 2 x
# 500, 4 blocks); and replicated
OPT8_LEAVES = {"lead": ((4, 512), ("data", None)), "aligned": ((3, 1024), (None, "data")),
               "kept": ((2, 768), (None, "data")), "straddle": ((2, 1000), (None, "data")),
               "replicated": ((300,), (None,))}


def opt8_inputs(steps: int = 2):
    """Parameters and ``steps`` gradients of :data:`OPT8_LEAVES` (numpy)."""
    rng = np.random.default_rng(8)
    params = {k: rng.standard_normal(shape).astype(np.float32)
              for k, (shape, _) in OPT8_LEAVES.items()}
    grads = [{k: (rng.standard_normal(shape) * 10.0 ** -i).astype(np.float32)
              for k, (shape, _) in OPT8_LEAVES.items()} for i in range(steps)]
    return params, grads


def opt8_updates(params, grads, shardings=None) -> list:
    """``adamw8bit``'s updates and state after each of the gradients (a
    rank's shards with ``shardings``) as {path: numpy}."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim import adamw8bit

    opt = adamw8bit(1e-2)
    params, grads = D.to_torch(params), [D.to_torch(g) for g in grads]
    if shardings is not None:
        params = SH.shard_tree(params, shardings[1], shardings[0])
        grads = [SH.shard_tree(g, shardings[1], shardings[0]) for g in grads]
    state = opt.init(params, shardings=shardings)
    out = []
    for g in grads:
        u, state = opt.update(g, state, params, shardings=shardings)
        leaves = {f"u/{k}": v.numpy() for k, v in u.items()}
        for m in ("mu", "nu"):
            for k, qs in state[m].items():
                leaves[f"{m}/{k}/q"], leaves[f"{m}/{k}/s"] = qs["q"].numpy(), qs["s"].numpy()
        out.append(leaves)
    return out


def opt8_ranks(params, grads) -> dict:
    """The 8-bit update on this rank's shards of :data:`OPT8_LEAVES` at dp
    2, and the state's specs (``partition_state`` of the shards)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adamw8bit
    from repro_torch.train.state import TrainState

    mesh = make_local_mesh()
    specs = {k: SH.P(*spec) for k, (_, spec) in OPT8_LEAVES.items()}
    steps = opt8_updates(params, grads, (mesh, specs))
    shards = SH.shard_tree(D.to_torch(params), specs, mesh)
    state = TrainState(shards, adamw8bit(1e-2).init(shards, shardings=(mesh, specs)), 0)
    parts = SH.partition_state(state, specs, mesh, sharded=True).opt_state["mu"]
    return {"steps": steps, "specs": {k: (tuple(v["q"]), tuple(v["s"])) for k, v in parts.items()}}


def checkpoint_8bit(whole_dir: str) -> dict:
    """``train.loop.train`` of the reduced MoE with the 8-bit AdamW and a
    bf16 master at dp 2 for 2 steps of 4 x 32 (a checkpoint every step) →
    its losses and its whole final state, gathered (every rank calls the
    gathers)."""
    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.context import activate_mesh
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw8bit, cosine_warmup
    from repro_torch.train.loop import train

    cfg = moe_cfg()
    mesh = make_local_mesh()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = SH.param_partition(params, mesh)
    with activate_mesh(mesh):
        state, hist = train(build_model(cfg), adamw8bit(cosine_warmup(1e-3, 10)),
                            TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=0), 4, SEQ),
                            2, master_dtype="bfloat16", device="cpu", params=params,
                            checkpoint_dir=whole_dir, checkpoint_every=1, log_every=0)
        whole = SH.unshard_tree(state, SH.partition_state(state, specs, mesh, sharded=True),
                                mesh)
    return {"loss": [h["loss"] for h in hist], "whole": _state_paths(whole),
            "step": whole.step}


if __name__ == "__main__":
    sys.exit(R._rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                          float(sys.argv[5]), globals()))
