"""The training loop: checkpoint/restart, straggler monitoring and eval.

Port of ``repro.train.loop``.  ``train(...)`` is the single entry point of
the launcher.  It is restart-safe: the state (params, optimizer state,
step, and gradient compression's error feedback when on) is saved every ``checkpoint_every`` steps and at the end, and the data
position is the step, so a killed run started again with the same
arguments restores the latest checkpoint and continues bit for bit (the
per-step rounding seed is derived from the step counter).

Under a training mesh (``launch/train.py`` activates ``make_local_mesh()``
under ``torchrun``) every rank builds the same whole parameters (the same
``seed``, or the same ``params``, e.g. converted from the reference), keeps
its shard (``distributed.sharding.shard_tree``), reads its rows of every
microbatch (``TokenBatcher.rank_batch``), and trains FSDP data-parallel
(``train.steps``); the metrics are reduced over the ranks, rank 0 logs,
and checkpoints hold whole leaves (any width restores them).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import init_params
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import world_rank
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import Optimizer
from repro_torch.train.state import TrainState, make_train_state
from repro_torch.train.steps import make_eval_step, make_train_step, training_mesh
from repro_torch.train.straggler import StragglerMonitor
from repro_torch.tree import tree_map


def _to_device(batch: dict, device) -> dict:
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
            .to(device) for k, v in batch.items()}


def train(
    model: Model,
    optimizer: Optimizer,
    batcher: TokenBatcher,
    total_steps: int,
    *,
    method: str = "quartet",
    master_dtype: str = "float32",
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 500,
    eval_batcher: TokenBatcher | None = None,
    eval_every: int = 0,
    eval_batches: int = 8,
    log_every: int = 10,
    log_fn: Callable = print,
    grad_compress: bool = False,
    microbatch: int = 1,
    extra_batch: dict | None = None,
    seed: int = 0,
    params: dict | None = None,
    device="cuda",
) -> tuple[TrainState, list[dict]]:
    """Train up to step ``total_steps`` from ``params`` (or random weights
    drawn from ``seed``) on ``device``, or from the latest checkpoint in
    ``checkpoint_dir`` when it holds one.  Returns the final state and one
    metrics dict per step run (loss, grad_norm, nll, tokens, step, dt in
    seconds).  ``extra_batch`` (the enc-dec family's ``source_embeds``, the
    VLM's ``image_embeds``: tensors or arrays with the batch's rows) joins
    every step's batch, on ``device``, as in the reference."""
    if params is None:
        params = init_params(model.cfg, torch.Generator(device=device).manual_seed(seed),
                             device)
    mesh = training_mesh()
    specs = shardings = None
    rank, ranks = SH.data_rank_and_size(mesh) if mesh is not None else (0, 1)
    if mesh is not None:
        specs = SH.param_partition(params, mesh)
        params = tree_map(lambda t: t.contiguous(), SH.shard_tree(params, specs, mesh))
    state = make_train_state(params, optimizer, master_dtype, grad_compress,
                             None if mesh is None else (mesh, specs))
    del params
    if mesh is not None:
        shardings = (mesh, SH.partition_state(state, specs, mesh, sharded=True))
    if world_rank() != 0:
        log_fn = _quiet

    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(state, device=device, shardings=shardings)
        start_step = int(meta["step"])
        log_fn(f"[resume] restored step {start_step} from {checkpoint_dir}")

    step_fn = make_train_step(model, optimizer, method=method, grad_compress=grad_compress,
                              microbatch=microbatch, param_specs=specs)

    def rows(step):
        if mesh is None:
            return batcher.batch(step)
        return batcher.rank_batch(step, rank, ranks, microbatch)

    monitor = StragglerMonitor(
        on_straggler=lambda s, dt, mu: log_fn(
            f"[straggler] step {s}: {dt:.2f}s vs ewma {mu:.2f}s"))
    history = []
    extra = _to_device(extra_batch, device) if extra_batch else {}
    for step in range(start_step, total_steps):
        batch = {**_to_device(rows(step), device), **extra}
        monitor.step_start()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # synchronises
        verdict = monitor.step_end(step)
        metrics.update(step=step, dt=verdict["dt"])
        history.append(metrics)
        if log_every and step % log_every == 0:
            log_fn(f"step {step:6d} loss {metrics['loss']:.4f} "
                   f"gnorm {metrics['grad_norm']:.3f} ({verdict['dt']:.2f}s)")
        if eval_batcher and eval_every and step and step % eval_every == 0:
            loss = evaluate(model, state, eval_batcher, eval_batches, method, device, specs)
            log_fn(f"step {step:6d} eval_loss {loss:.4f}")
        if ckpt and checkpoint_every and (step + 1) % checkpoint_every == 0:
            ckpt.save(step + 1, state, shardings=shardings)
    if ckpt:
        ckpt.save(total_steps, state, blocking=True, shardings=shardings)
    return state, history


def _quiet(*_args, **_kwargs) -> None:
    """The log of a rank other than 0."""


def evaluate(model: Model, state: TrainState, batcher: TokenBatcher, n_batches: int,
             method: str = "quartet", device="cuda", param_specs=None) -> float:
    """Mean nll over ``n_batches`` held-out batches; under a training mesh
    each data rank evaluates its rows and the step reduces the metrics
    (``param_specs`` as ``train`` shards by)."""
    eval_fn = make_eval_step(model, method=method, param_specs=param_specs)
    mesh = training_mesh()
    rank, ranks = SH.data_rank_and_size(mesh) if mesh is not None else (0, 1)
    tot, cnt = 0.0, 0.0
    for i in range(n_batches):
        b = (batcher.batch(10_000_000 + i) if mesh is None
             else batcher.rank_batch(10_000_000 + i, rank, ranks))
        m = eval_fn(state.params, _to_device(b, device))
        tot += float(m["nll"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    return tot / max(cnt, 1.0)
