"""Step builders: the train and eval step functions.

Port of ``repro.train.steps``.  ``make_train_step`` wires the paper's
pipeline: compute params cast from the f32 master, the Quartet (or bf16)
forward and backward, the chunked LM loss, global-norm clipping and AdamW.
The per-step ``seed`` is derived from the step counter exactly as the
reference derives it, ``((step + 1) · microbatch) mod 2^32`` and then
``seed + i`` for microbatch i, so every stochastic rounding draws the
reference's bits and a step is reproducible from the state.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import Model
from repro_torch.optim.adamw import Optimizer, apply_updates
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.train.losses import chunked_lm_loss, cross_entropy_loss
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_MASK = 0xFFFFFFFF


def _cast(params, dtype):
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def make_train_step(model: Model, optimizer: Optimizer, *, method: str = "quartet",
                    clip_norm: float = 1.0, z_loss: float = 0.0, loss_chunk: int = 512,
                    microbatch: int = 1) -> Callable:
    """``microbatch`` > 1 splits the batch into that many sequential
    gradient-accumulation steps (activation memory shrinks in proportion).
    The step takes and returns a :class:`TrainState`; the metrics it returns
    are 0-d tensors on the params' device (reading them synchronises)."""
    cfg = model.cfg
    compute_dtype = getattr(torch, cfg.dtype)

    def loss_fn(params, batch, seed):
        cparams = _cast(params, compute_dtype)
        feats, _ = model.forward(cparams, batch["tokens"], seed, method=method,
                                 features_only=True)
        loss, metrics = chunked_lm_loss(model.head, cparams, feats, batch["labels"], seed,
                                        batch.get("loss_mask"), z_loss, chunk=loss_chunk,
                                        method=method)
        metrics["aux"] = torch.zeros((), device=loss.device)  # dense: no router loss
        return loss, metrics

    def value_and_grad(params, batch, seed):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, seed)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def grads_of(params, batch, seed):
        if microbatch <= 1:
            return value_and_grad(params, batch, seed)
        n = next(iter(batch.values())).shape[0] // microbatch
        acc, loss_sum, ms = None, 0.0, []
        for i in range(microbatch):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            loss, metrics, g = value_and_grad(params, mb, (seed + i) & _MASK)
            g = [t.to(torch.float32) for t in g]
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
            loss_sum = loss_sum + loss
            ms.append(metrics)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return loss_sum / microbatch, metrics, [a / microbatch for a in acc]

    def train_step(state: TrainState, batch):
        seed = ((state.step + 1) * microbatch) & _MASK
        loss, metrics, grads = grads_of(state.params, batch, seed)
        with torch.no_grad():
            grads = tree_unflatten(state.params, grads)
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
        metrics.update(loss=loss, grad_norm=gnorm)
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def make_eval_step(model: Model, *, method: str = "quartet") -> Callable:
    compute_dtype = getattr(torch, model.cfg.dtype)

    @torch.no_grad()
    def eval_step(params, batch):
        logits, _ = model.forward(_cast(params, compute_dtype), batch["tokens"], 0,
                                  method=method)
        _, metrics = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
        return metrics

    return eval_step
