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

Under a training mesh (``distributed.context``: a mesh with a ``data``
axis is active, as ``launch/train.py`` sets it) a dense model trains FSDP
data-parallel, as the reference's GSPMD program does: the state holds a
rank's shards (``distributed.sharding.shard_tree`` by ``param_specs``), a
rank's batch holds its rows of every microbatch
(``data.pipeline.TokenBatcher.rank_batch``), the step opens the anchors'
plan, each rank's loss is its share of the global token count (so the
summed gradients are the one-device gradient, with a ``loss_mask`` too),
the accumulator stays in shard shapes, the clip sums the shards' squares
across the ranks and counts a replicated leaf once, and AdamW updates a
rank's shards only.  The metrics come back reduced over the ranks.  A
MoE model trains the same way: its layers route the global microbatch's
groups (``models.moe``), and its aux loss, like the LM loss, is each
rank's share of one device's.  The 8-bit AdamW updates a rank's shards of
its moments (``optim.adamw``, given the mesh and the specs).  On one data
rank the step takes the same anchors (gathers of one rank) and equals the
step without a mesh bit for bit.  At more than one data rank what is not
ported raises (``distributed.sharding.DEFERRED``).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import threefry
from repro_torch.core.baselines import BASELINE_METHODS
from repro_torch.distributed import context as C
from repro_torch.distributed import sharding as SH
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


def training_mesh():
    """The active mesh when it is a training mesh (it has a ``data`` axis),
    else None (no mesh, or a serving mesh)."""
    mesh = C.current_mesh()
    return mesh if mesh is not None and "data" in mesh.axis_names else None


def check_data_parallel(cfg, method: str, grad_compress: bool, mesh) -> None:
    """Raise on what data-parallel training does not do yet, at more than
    one data rank (each message names its ROADMAP item)."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(SH.DEFERRED["tp"])
    if SH.data_rank_and_size(mesh)[1] == 1:
        return
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r}: {SH.DEFERRED['family']}")
    if grad_compress:
        raise NotImplementedError(SH.DEFERRED["grad_compress"])
    if method in BASELINE_METHODS:
        raise NotImplementedError(f"method {method!r}: {SH.DEFERRED['baseline']}")


def _plan(model, method, grad_compress, state, param_specs):
    """The anchors' plan for this step (None without a training mesh, and
    for the families whose anchors are not driven yet on one rank)."""
    mesh = training_mesh()
    if mesh is None:
        return None
    check_data_parallel(model.cfg, method, grad_compress, mesh)
    if model.cfg.family not in ("dense", "moe"):
        return None
    if param_specs is None:
        if SH.data_rank_and_size(mesh)[1] > 1:
            raise ValueError("a data-parallel step needs the parameters' specs "
                             "(make_train_step(param_specs=param_partition(whole, mesh)))")
        param_specs = SH.param_partition(state.params, mesh)
    return C.make_plan(mesh, param_specs, model.cfg.quartet.fp4_allgather
                       and method == "quartet")


def _token_count(batch: dict) -> torch.Tensor:
    mask = batch.get("loss_mask")
    if mask is None:
        return torch.tensor(float(batch["labels"].numel()), device=batch["labels"].device)
    return mask.to(torch.float32).sum()


def make_train_step(model: Model, optimizer: Optimizer, *, method: str = "quartet",
                    clip_norm: float = 1.0, aux_weight: float = 0.01, z_loss: float = 0.0,
                    grad_compress: bool = False, loss_chunk: int = 512,
                    microbatch: int = 1, param_specs=None) -> Callable:
    """``microbatch`` > 1 splits the batch into that many sequential
    gradient-accumulation steps (activation memory shrinks in proportion).
    With ``grad_compress`` (and a state whose ``err`` is not None) the
    clipped gradients take one SR-int8 round trip with error feedback
    (``optim.grad_compress``), every leaf under the step's one key
    ``fold_in(PRNGKey(0xC0), seed)``, before the optimizer.
    The step takes and returns a :class:`TrainState`; the metrics it returns
    are 0-d tensors on the params' device (reading them synchronises).
    ``param_specs`` (the whole parameters' ``param_partition`` under the
    mesh) tells a data-parallel step which leaves are shards, and along
    which dim."""
    cfg = model.cfg
    compute_dtype = getattr(torch, cfg.dtype)
    baseline = method in BASELINE_METHODS

    def loss_fn(cparams, batch, seed, denom=None):
        cparams = C.constrain_params(cparams)
        feats, _, aux = model.forward(cparams, batch["tokens"], seed, extra=_extra(batch),
                                      method=method, features_only=True, return_aux=True)
        loss, metrics = chunked_lm_loss(model.head, cparams, feats, batch["labels"], seed,
                                        batch.get("loss_mask"), z_loss, chunk=loss_chunk,
                                        method=method, denom=denom)
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
        plan = C.current_plan()
        if plan is None or plan.size == 1:
            loss, metrics = loss_fn(cparams, batch, seed)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)
        # this rank's share of the global mean (its tokens' losses over the
        # global count): summed over the ranks, the loss and the gradients
        # are the one-device ones, each token's gradient bit for bit
        plan.rows = batch["tokens"].shape[0] * plan.size
        loss, metrics = loss_fn(cparams, batch, seed,
                                C.all_reduce_data(_token_count(batch), plan.mesh))
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() if k == "tokens" else C.all_reduce_data(v.detach(), plan.mesh)
                   for k, v in metrics.items()}
        return C.all_reduce_data(loss.detach(), plan.mesh), metrics, list(grads)

    def grads_of(params, batch, seed):
        if microbatch <= 1:
            return value_and_grad(params, batch, seed)
        n = next(iter(batch.values())).shape[0] // microbatch
        acc, loss_sum, ms = None, 0.0, []
        for i in range(microbatch):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            loss, metrics, g = value_and_grad(params, mb, (seed + i) & _MASK)
            if acc is None:  # a copy of ours (a gradient may be a view)
                acc = [t.to(torch.float32, copy=True) for t in g]
            else:  # in place, a leaf at a time: one f32 copy of the gradients
                for a, t in zip(acc, g):
                    a.add_(t)
            del g
            loss_sum = loss_sum + loss
            ms.append(metrics)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return loss_sum / microbatch, metrics, [a.div_(microbatch) for a in acc]

    def train_step(state: TrainState, batch):
        seed = ((state.step + 1) * microbatch) & _MASK
        plan = _plan(model, method, grad_compress, state, param_specs)
        if plan is None:
            loss, metrics, grads = grads_of(state.params, batch, seed)
        else:
            with C.fsdp_plan(plan):
                loss, metrics, grads = grads_of(state.params, batch, seed)
        with torch.no_grad():
            grads = tree_unflatten(state.params, grads)
            if plan is None or plan.size == 1:
                grads, gnorm = clip_by_global_norm(grads, clip_norm)
            else:
                sharded = [plan.dims["/".join(p)] is not None for p in _leaf_paths(grads)]
                grads, gnorm = clip_by_global_norm(
                    grads, clip_norm, sharded, lambda t: C.all_reduce_data(t, plan.mesh))
            err = state.err
            if grad_compress and err is not None:
                key = threefry.fold_in(threefry.prng_key(0xC0), seed)
                pairs = [compress_decompress_gradient(g, e, key)
                         for g, e in zip(tree_leaves(grads), tree_leaves(err))]
                grads = tree_unflatten(grads, [p[0] for p in pairs])
                err = tree_unflatten(err, [p[1] for p in pairs])
            sharded = {}
            if plan is not None and plan.size > 1 and optimizer.sharded:
                sharded["shardings"] = (plan.mesh, param_specs)
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params,
                                                  **sharded)
            params = apply_updates(state.params, updates)
        metrics.update(loss=loss, grad_norm=gnorm)
        return TrainState(params, opt_state, state.step + 1, err), metrics

    return train_step


def make_eval_step(model: Model, *, method: str = "quartet", param_specs=None) -> Callable:
    """The evaluation step; under a training mesh with more than one data
    rank (``param_specs`` as :func:`make_train_step` takes them) the
    anchors gather the shards and the metrics come back reduced."""
    compute_dtype = getattr(torch, model.cfg.dtype)

    @torch.no_grad()
    def eval_step(params, batch):
        mesh = training_mesh()
        if mesh is None or SH.data_rank_and_size(mesh)[1] == 1:
            logits, _ = model.forward(_cast(params, compute_dtype), batch["tokens"], 0,
                                      extra=_extra(batch), method=method)
            _, metrics = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
            return metrics
        check_data_parallel(model.cfg, method, False, mesh)
        if param_specs is None:
            raise ValueError("a data-parallel eval step needs the parameters' specs")
        plan = C.make_plan(mesh, param_specs)
        plan.rows = batch["tokens"].shape[0] * plan.size
        with C.fsdp_plan(plan):
            logits, _ = model.forward(C.constrain_params(_cast(params, compute_dtype)),
                                      batch["tokens"], 0, extra=_extra(batch), method=method)
        _, metrics = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
        count = _token_count(batch)
        share = count / torch.clamp(C.all_reduce_data(count, mesh), min=1.0)
        return {k: C.all_reduce_data(v if k == "tokens" else v * share, mesh)
                for k, v in metrics.items()}

    return eval_step
