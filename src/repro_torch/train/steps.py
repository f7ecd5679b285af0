"""Step builders: the train and eval step functions.

Port of ``repro.train.steps``.  ``make_train_step`` wires the paper's
pipeline: compute params cast from the master (f32, or bf16 with the 8-bit
AdamW), the Quartet (or bf16, or a baseline method's) forward and backward,
the chunked LM loss plus ``aux_weight`` times the MoE router loss (0 for a
dense model), global-norm clipping, optionally the SR-int8 gradient
compression with error feedback (``grad_compress``), and AdamW.
Under a baseline method (``core.baselines``) the weights that reach
``baseline_linear`` go to the model in f32, uncast: it casts them itself and
hands back an f32 dW, which the reference's ``jax.grad`` delivers to the
master unrounded (an f32 gradient even for a bf16 master).
A batch's ``source_embeds`` (enc-dec) or ``image_embeds`` (VLM) reach the
forward as its ``extra``, in the train and the eval step alike, and a
microbatch takes its rows of them as it takes its tokens.
The per-step ``seed`` is derived from the step counter exactly as the
reference derives it, ``((step + 1) · microbatch) mod 2^32`` and then
``seed + i`` for microbatch i, so every stochastic rounding draws the
reference's bits and a step is reproducible from the state.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import threefry
from repro_torch.core.baselines import BASELINE_METHODS
from repro_torch.models.layers import takes_master_weight
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import Optimizer, apply_updates
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.grad_compress import compress_decompress_gradient
from repro_torch.train.losses import chunked_lm_loss, cross_entropy_loss
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_MASK = 0xFFFFFFFF
_EXTRA = ("source_embeds", "image_embeds")


def _extra(batch: dict) -> dict | None:
    """The batch's conditioning for ``model.forward``'s ``extra``: the
    enc-dec family's ``source_embeds``, the VLM's ``image_embeds``."""
    return {k: v for k, v in batch.items() if k in _EXTRA} or None


def _cast(params, dtype):
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def _leaf_paths(tree, path=()) -> list[tuple[str, ...]]:
    """Each leaf's keys, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], path + (k,))]
    return [path]


def make_train_step(model: Model, optimizer: Optimizer, *, method: str = "quartet",
                    clip_norm: float = 1.0, aux_weight: float = 0.01, z_loss: float = 0.0,
                    grad_compress: bool = False, loss_chunk: int = 512,
                    microbatch: int = 1) -> Callable:
    """``microbatch`` > 1 splits the batch into that many sequential
    gradient-accumulation steps (activation memory shrinks in proportion).
    With ``grad_compress`` (and a state whose ``err`` is not None) the
    clipped gradients take one SR-int8 round trip with error feedback
    (``optim.grad_compress``), every leaf under the step's one key
    ``fold_in(PRNGKey(0xC0), seed)``, before the optimizer.
    The step takes and returns a :class:`TrainState`; the metrics it returns
    are 0-d tensors on the params' device (reading them synchronises)."""
    cfg = model.cfg
    compute_dtype = getattr(torch, cfg.dtype)
    baseline = method in BASELINE_METHODS

    def loss_fn(cparams, batch, seed):
        feats, _, aux = model.forward(cparams, batch["tokens"], seed, extra=_extra(batch),
                                      method=method, features_only=True, return_aux=True)
        loss, metrics = chunked_lm_loss(model.head, cparams, feats, batch["labels"], seed,
                                        batch.get("loss_mask"), z_loss, chunk=loss_chunk,
                                        method=method)
        metrics["aux"] = aux
        # a dense model's aux is exactly 0: its loss and gradients are unchanged
        return loss + aux_weight * aux, metrics

    def value_and_grad(params, batch, seed):
        # under a baseline method the weights baseline_linear casts itself
        # stay uncast f32 leaves, so even a bf16 master gets the f32 dW
        master = [baseline and takes_master_weight(p) for p in _leaf_paths(params)]
        leaves = [(p.detach().to(torch.float32) if m else p.detach()).requires_grad_()
                  for p, m in zip(tree_leaves(params), master)]
        cparams = tree_unflatten(params, [
            p if m or not p.is_floating_point() else p.to(compute_dtype)
            for p, m in zip(leaves, master)])
        loss, metrics = loss_fn(cparams, batch, seed)
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
            err = state.err
            if grad_compress and err is not None:
                key = threefry.fold_in(threefry.prng_key(0xC0), seed)
                pairs = [compress_decompress_gradient(g, e, key)
                         for g, e in zip(tree_leaves(grads), tree_leaves(err))]
                grads = tree_unflatten(grads, [p[0] for p in pairs])
                err = tree_unflatten(err, [p[1] for p in pairs])
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
        metrics.update(loss=loss, grad_norm=gnorm)
        return TrainState(params, opt_state, state.step + 1, err), metrics

    return train_step


def make_eval_step(model: Model, *, method: str = "quartet") -> Callable:
    compute_dtype = getattr(torch, model.cfg.dtype)

    @torch.no_grad()
    def eval_step(params, batch):
        logits, _ = model.forward(_cast(params, compute_dtype), batch["tokens"], 0,
                                  extra=_extra(batch), method=method)
        _, metrics = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
        return metrics

    return eval_step
