"""The training loop: straggler monitoring and eval.

Port of ``repro.train.loop``.  ``train(...)`` is the single entry point of
the launcher.  Its state is (params, optimizer state, step) and the data
position is the step, so the run is deterministic given the seed.
Checkpoint/restart (``checkpoint/checkpointer.py``) is not ported yet: it
heads the port's next slice (ROADMAP, Queue A), and until then
``checkpoint_dir`` raises.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.convert import init_params
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import Optimizer
from repro_torch.train.state import TrainState, make_train_state
from repro_torch.train.steps import make_eval_step, make_train_step
from repro_torch.train.straggler import StragglerMonitor


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def train(
    model: Model,
    optimizer: Optimizer,
    batcher: TokenBatcher,
    total_steps: int,
    *,
    method: str = "quartet",
    master_dtype: str = "float32",
    checkpoint_dir: str | None = None,
    eval_batcher: TokenBatcher | None = None,
    eval_every: int = 0,
    eval_batches: int = 8,
    log_every: int = 10,
    log_fn: Callable = print,
    microbatch: int = 1,
    seed: int = 0,
    params: dict | None = None,
    device="cuda",
) -> tuple[TrainState, list[dict]]:
    """Train ``total_steps`` steps from ``params`` (or random weights drawn
    from ``seed``) on ``device``.  Returns the final state and one metrics
    dict per step (loss, grad_norm, nll, tokens, step, dt in seconds)."""
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "train(checkpoint_dir=...): checkpoint/checkpointer.py is not ported yet; "
            "it heads the port's next slice (ROADMAP, Queue A)")
    if params is None:
        params = init_params(model.cfg, torch.Generator(device=device).manual_seed(seed),
                             device)
    state = make_train_state(params, optimizer, master_dtype)
    del params

    step_fn = make_train_step(model, optimizer, method=method, microbatch=microbatch)
    monitor = StragglerMonitor(
        on_straggler=lambda s, dt, mu: log_fn(
            f"[straggler] step {s}: {dt:.2f}s vs ewma {mu:.2f}s"))
    history = []
    for step in range(total_steps):
        batch = _to_device(batcher.batch(step), device)
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
            loss = evaluate(model, state, eval_batcher, eval_batches, method, device)
            log_fn(f"step {step:6d} eval_loss {loss:.4f}")
    return state, history


def evaluate(model: Model, state: TrainState, batcher: TokenBatcher, n_batches: int,
             method: str = "quartet", device="cuda") -> float:
    eval_fn = make_eval_step(model, method=method)
    tot, cnt = 0.0, 0.0
    for i in range(n_batches):
        m = eval_fn(state.params, _to_device(batcher.batch(10_000_000 + i), device))
        tot += float(m["nll"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    return tot / max(cnt, 1.0)
