"""The active mesh; the one data-plane collective of tensor-parallel
serving; and the anchors of FSDP data-parallel training.

Port of ``repro.distributed.context``'s mesh stack.  The serving steps run
their model under ``activate_mesh(placement.mesh)``; a model whose config
names a ``tp_axis`` asks :func:`tp_rank` which slice of heads or experts
is its own and :func:`all_gather_tiled` for the other ranks' slices.  The
gather is a concatenation in rank order, never a reduction, so a rank's
outputs carry the bits one device computes.  Outside an active mesh both
raise: a model that finds a sharded cache with no group to gather over
must not run on its slice alone.

Training (FSDP over the ``data`` axis, or ``("pod", "data")``, with
``model`` of one rank) runs under :func:`fsdp_plan`, which the train step
opens with the parameters' specs.  Under a plan the reference's anchors do
in PyTorch what GSPMD derives from them:

* :func:`constrain_layer_params` all-gathers a layer's sharded leaves on
  each leaf's own sharded dim (an autograd Function whose backward
  reduce-scatters the gradient, summed in f32, back to the shard); a
  replicated leaf's gradient is all-reduced instead.  Across ranks every
  leaf leaves the anchor in f32 (its bf16 values, exact: :func:`widened`),
  so Quartet's backward hands the f32 dW to the reduce-scatter and the sum
  is rounded to bf16 once, as one device rounds its whole-batch dW; a
  product reads such a leaf through :func:`weight_operand`.  With
  ``fp4_allgather``
  the Quartet weights stay shards, tagged with their dim
  (:func:`fsdp_dim`), and ``core.quartet.quest_qdq_gathered`` gathers
  their MXFP4 codes instead; a MoE layer's expert stacks [E, K, N] too
  (``gate`` and ``up`` split along K, ``down`` along N).
* :func:`constrain_params` does the same for the leaves outside the layer
  stack (embedding, final norm, head).
* :func:`constrain_tokens` checks that a rank holds its rows of the
  microbatch; the reference's sequence-parallel fallback raises.
* :func:`constrain_logits` is the identity while ``model`` has one rank.

A MoE layer routes the global microbatch's groups
(:func:`moe_group_layout`): a rank holds whole groups, or a part of one
that consecutive data ranks share (:func:`data_subgroup`), whose tokens
and router logits they gather (:func:`gather_own_rows`) and whose experts
they split, gathering their outputs (:func:`gather_blocks`).

Each rank's loss is its share of the global mean, so summed gradients are
the one-device gradient.  Outside a plan (no mesh, a serving mesh, or a
forward without a plan) all four return their input unchanged, as the
reference's do without a mesh.

``stats`` counts the collectives and their bytes received, in all and by
kind (``all_gather``, ``reduce_scatter``, ``all_reduce``); with
``stats.timing`` set, each one on the card is bracketed by CUDA events,
read with :meth:`CollectiveStats.device_ms` after a synchronisation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as SH

_STACK: list = []


@contextlib.contextmanager
def activate_mesh(mesh):
    _STACK.append(mesh)
    try:
        yield mesh
    finally:
        _STACK.pop()


def current_mesh():
    return _STACK[-1] if _STACK else None


def _mesh_for(axis: str):
    mesh = current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise RuntimeError(f"tensor-parallel model code needs an active mesh with axis "
                           f"{axis!r} (serve the model through a Placement's steps)")
    return mesh


def tp_group(axis: str = "model"):
    """This rank's process group along ``axis`` of the active mesh (None on
    an axis of one rank)."""
    return _mesh_for(axis).group(axis)


def tp_rank(axis: str = "model") -> int:
    """This rank's index along ``axis`` of the active mesh."""
    return _mesh_for(axis).axis_index(axis)


class CollectiveStats:
    """Counts of the collectives (calls, bytes received), in all and by
    kind, and with ``timing`` their device time from CUDA events."""

    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self._events: list = []
        self.kinds: dict[str, dict] = {}

    def _start(self, x: torch.Tensor):
        if not (self.timing and x.is_cuda):
            return None
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        return ev

    def _end(self, kind: str, nbytes: int, ev) -> None:
        k = self.kinds.setdefault(kind, {"calls": 0, "bytes": 0, "events": []})
        if ev is not None:
            ev[1].record()
            self._events.append(ev)
            k["events"].append(ev)
        self.calls += 1
        self.bytes += nbytes
        k["calls"] += 1
        k["bytes"] += nbytes

    def device_ms(self, kind: str | None = None) -> float:
        """Summed device time of the timed collectives, of one kind or all
        (synchronises)."""
        events = self._events if kind is None else self.kinds.get(kind, {}).get("events", [])
        if not events:
            return 0.0
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events)

    def summary(self) -> dict:
        """Calls and MB received by kind (no synchronisation)."""
        return {k: {"calls": v["calls"], "mb": v["bytes"] / 1e6} for k, v in self.kinds.items()}


stats = CollectiveStats()


def all_gather_tiled(x: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated on ``dim`` in rank
    order (the reference's ``all_gather(..., tiled=True)``).  NCCL gathers
    into one tensor; gloo through its list form."""
    n = _mesh_for(axis).shape[axis]
    if n == 1:
        return x
    return _gather(x, dim, tp_group(axis), n)


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated on ``dim`` in rank
    order: NCCL gathers into one tensor, gloo through its list form."""
    xt = x.movedim(dim, 0).contiguous()
    ev = stats._start(xt)
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=xt.dtype, device=xt.device)
        with warnings.catch_warnings():  # renamed in newer releases, same collective
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, xt, group=group)
    else:
        parts = [torch.empty_like(xt) for _ in range(n)]
        dist.all_gather(parts, xt, group=group)
        out = torch.cat(parts, 0)
    stats._end("all_gather", out.numel() * out.element_size(), ev)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int, rank: int) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``, this rank's slice of
    ``dim``: NCCL's reduce-scatter; gloo (which has none) an all-reduce and
    the slice."""
    xt = x.movedim(dim, 0).contiguous()
    m = xt.shape[0] // n
    ev = stats._start(xt)
    if dist.get_backend(group) == "nccl":
        out = torch.empty((m, *xt.shape[1:]), dtype=xt.dtype, device=xt.device)
        dist.reduce_scatter_tensor(out, xt, group=group)
    else:
        dist.all_reduce(xt, group=group)
        out = xt[rank * m:(rank + 1) * m].clone()
    stats._end("reduce_scatter", out.numel() * out.element_size(), ev)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x`` (a new tensor)."""
    out = x.contiguous().clone()
    ev = stats._start(out)
    dist.all_reduce(out, group=group)
    stats._end("all_reduce", out.numel() * out.element_size(), ev)
    return out


# ---------------------------------------------------------------------------
# FSDP data-parallel training
# ---------------------------------------------------------------------------

SEQUENCE_PARALLEL = SH.DEFERRED["sequence_parallel"]


def data_group(mesh):
    """The data-parallel group of a training mesh (None on one rank)."""
    axes = SH.dp_axes(mesh)
    return mesh.group(axes[0] if len(axes) == 1 else axes)


def gather_data(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Every data rank's ``x`` concatenated on ``dim`` (no autograd)."""
    _, n = SH.data_rank_and_size(mesh)
    if n == 1:
        return x
    return _gather(x, dim, data_group(mesh), n)


def reduce_scatter_data(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The sum of ``x`` over the data ranks, this rank's block of ``dim``
    (no autograd)."""
    rank, n = SH.data_rank_and_size(mesh)
    return x if n == 1 else _reduce_scatter(x, dim, data_group(mesh), n, rank)


def all_reduce_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the data ranks (no autograd)."""
    _, n = SH.data_rank_and_size(mesh)
    return x if n == 1 else _all_reduce(x, data_group(mesh))


@dataclasses.dataclass
class FsdpPlan:
    """What the anchors need in a train step: the mesh, the sharded dim of
    every parameter by its path (stacked layer leaves keep their [L] dim),
    whether Quartet weights cross as MXFP4 codes, and the global row count
    of the microbatch being run."""

    mesh: object
    dims: dict
    fp4_allgather: bool = False
    rows: int | None = None

    @property
    def rank(self) -> int:
        return SH.data_rank_and_size(self.mesh)[0]

    @property
    def size(self) -> int:
        return SH.data_rank_and_size(self.mesh)[1]


_PLAN: list[FsdpPlan] = []


def make_plan(mesh, param_specs, fp4_allgather: bool = False) -> FsdpPlan:
    """A plan from the whole parameters' spec tree (``param_partition``)."""
    dims = {}

    def one(path, spec):
        dims[path] = SH.sharded_dim(spec, mesh)
        return spec

    SH.tree_map_with_path(one, param_specs)
    return FsdpPlan(mesh, dims, fp4_allgather)


@contextlib.contextmanager
def fsdp_plan(plan: FsdpPlan):
    _PLAN.append(plan)
    try:
        yield plan
    finally:
        _PLAN.pop()


def current_plan() -> FsdpPlan | None:
    return _PLAN[-1] if _PLAN else None


def token_window() -> tuple[int, int]:
    """(rank, ranks) of the data axis under a plan, (0, 1) outside: a rank
    holds block ``rank`` of ``ranks`` equal blocks of the microbatch's
    tokens."""
    plan = current_plan()
    return (0, 1) if plan is None else (plan.rank, plan.size)


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Where a rank's tokens lie among a MoE layer's routing groups of the
    global microbatch (``models.moe.moe_ffn``).  The microbatch's T tokens
    form ``groups`` groups of ``g``; a rank routes ``local`` of them,
    starting at global group ``first``.  ``share`` ranks hold one group
    between them (1 when every rank holds whole groups); a rank is member
    ``member`` of its group's ``group`` (a process group, None at share 1)
    and owns the group's rows [member·T_l, (member + 1)·T_l)."""

    g: int
    groups: int
    local: int
    first: int
    share: int = 1
    member: int = 0
    group: object = None


def moe_group_layout(tokens: int, group_tokens: int, num_experts: int) -> GroupLayout:
    """The layout of a rank's ``tokens`` (T_l) in a MoE layer's groups of
    ``min(group_tokens, T)``, T the global microbatch's tokens (T_l times
    the data ranks under a plan, T_l outside one).  Contiguous rank rows
    hold either whole groups (T_l a multiple of g) or a part of one group
    that ``g / T_l`` ranks share (then E must split over them); any other
    layout raises."""
    r, n = token_window()
    T = tokens * n
    g = min(group_tokens, T)
    if T % g:
        raise ValueError(f"tokens {T} not divisible into groups of {g}")
    if tokens % g == 0:
        return GroupLayout(g, T // g, tokens // g, r * (tokens // g))
    share = g // tokens
    if g % tokens or num_experts % share:
        raise NotImplementedError(
            f"MoE groups of {g} tokens over {n} data ranks of {tokens} tokens and "
            f"{num_experts} experts: a group neither lies whole on a rank nor splits over "
            f"ranks that divide its experts; groups that straddle the ranks' token blocks "
            f"(ROADMAP A8d.3)")
    plan = current_plan()
    return GroupLayout(g, T // g, 1, r // share, share, r % share,
                       data_subgroup(plan.mesh, share))


def _data_ranks(mesh) -> list[int]:
    """The world ranks of this rank's data-parallel line, in data-rank
    order (``pod`` major)."""
    import numpy as np

    ranks = mesh.ranks
    if "model" in mesh.axis_names:
        ranks = np.take(ranks, mesh.axis_index("model"), axis=mesh.axis_names.index("model"))
    return [int(x) for x in np.asarray(ranks).reshape(-1)]


def data_subgroup(mesh, size: int):
    """This rank's process group among the blocks of ``size`` consecutive
    data ranks (the whole data group at ``size`` = the data ranks).  Every
    block's group is created on every rank in one order, at the first call
    (which every rank makes at the same point of a step), and kept on the
    mesh."""
    rank, n = SH.data_rank_and_size(mesh)
    if size == n:
        return data_group(mesh)
    cache = mesh.__dict__.setdefault("_data_subgroups", {})
    if size not in cache:
        ranks = _data_ranks(mesh)
        mine = None
        for b in range(n // size):
            grp = dist.new_group(ranks=ranks[b * size:(b + 1) * size])
            if b == rank // size:
                mine = grp
        cache[size] = mine
    return cache[size]


def gather_group(x: torch.Tensor, dim: int, lay: GroupLayout) -> torch.Tensor:
    """Every member's ``x`` of a shared group concatenated on ``dim`` (no
    autograd)."""
    return x if lay.share == 1 else _gather(x, dim, lay.group, lay.share)


class _GatherOwnRows(torch.autograd.Function):
    """Forward: the group members' rows concatenated (dim 0).  Backward:
    this member's rows of the gradient.  For values every member then
    computes alike from the whole group, whose gradient on a member reaches
    only the rows it owns."""

    @staticmethod
    def forward(ctx, x, lay):
        ctx.lay, ctx.rows = lay, x.shape[0]
        return gather_group(x, 0, lay)

    @staticmethod
    def backward(ctx, g):
        m = ctx.lay.member * ctx.rows
        return g[m:m + ctx.rows].contiguous(), None


def gather_own_rows(x: torch.Tensor, lay: GroupLayout) -> torch.Tensor:
    return x if lay.share == 1 else _GatherOwnRows.apply(x, lay)


class _GatherBlocks(torch.autograd.Function):
    """Forward: the members' blocks concatenated on dim 0 (a shared group's
    experts).  Backward: the gradient summed over the members and this
    member's block kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, lay):
        ctx.lay = lay
        return gather_group(x, 0, lay)

    @staticmethod
    def backward(ctx, g):
        lay = ctx.lay
        return _reduce_scatter(g, 0, lay.group, lay.share, lay.member), None


def gather_blocks(x: torch.Tensor, lay: GroupLayout) -> torch.Tensor:
    return x if lay.share == 1 else _GatherBlocks.apply(x, lay)


def widened() -> bool:
    """Whether the anchors hand the step's floating leaves over in f32: under
    a plan across data ranks, with autograd on.  Each such leaf holds its
    compute dtype's values exactly; the backward then sums f32 partials
    across the ranks and rounds once, as one device rounds its whole-batch
    gradient."""
    plan = current_plan()
    return plan is not None and plan.size > 1 and torch.is_grad_enabled()


def weight_operand(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` for a product in ``dtype``: a leaf the anchors widened stays
    f32 (:func:`widened`; its f32 gradient reaches the cross-rank sum
    unrounded), any other is cast."""
    return w if w.dtype == torch.float32 and widened() else w.to(dtype)


def fsdp_dim(w: torch.Tensor) -> int | None:
    """The dim a weight left sharded for the FP4 all-gather is split along
    (None for a whole weight)."""
    return getattr(w, "_fsdp_dim", None)


class _GatherShard(torch.autograd.Function):
    """Forward: the whole leaf from every data rank's shard (in the shard's
    dtype on the wire), cast to ``out_dtype``.  Backward: the gradient
    summed over the data ranks in f32 and scattered to the shard, then cast
    to the shard's dtype."""

    @staticmethod
    def forward(ctx, shard, dim, group, n, rank, out_dtype):
        ctx.dim, ctx.group, ctx.n, ctx.rank, ctx.dtype = dim, group, n, rank, shard.dtype
        whole = _gather(shard, dim, group, n) if n > 1 else shard
        # row-major, as one device holds the leaf: a gather along dim 1 comes
        # back transposed in memory, and an op that reads a weight can round
        # by its layout (a library GEMM picks its algorithm from the strides)
        return whole.to(out_dtype, memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32)
        if ctx.n > 1:
            g = _reduce_scatter(g, ctx.dim, ctx.group, ctx.n, ctx.rank)
        return g.to(ctx.dtype), None, None, None, None, None


class _ReduceGrad(torch.autograd.Function):
    """The leaf in ``out_dtype`` forward; the backward sums the gradient
    over the data ranks in f32 (a replicated leaf: every rank's share of
    the loss) and casts it to the leaf's dtype."""

    @staticmethod
    def forward(ctx, x, group, n, out_dtype):
        ctx.group, ctx.n, ctx.dtype = group, n, x.dtype
        return x.to(out_dtype) if out_dtype != x.dtype else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.n > 1:
            g = _all_reduce(g.to(torch.float32), ctx.group)
        return g.to(ctx.dtype), None, None, None


def _is_dense_weight(path: str) -> bool:
    """A weight that ``models.layers.dense`` multiplies by (every ``w`` but
    the MoE router's)."""
    parts = path.split("/")
    return parts[-1] == "w" and (len(parts) < 2 or parts[-2] != "router")


def _is_expert_stack(path: str) -> bool:
    """A MoE layer's stacked expert weight [E, K, N] (``gate``, ``up``,
    ``down``), which ``models.layers.dense_experts`` multiplies by."""
    parts = path.split("/")
    return len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in ("gate", "up", "down")


def _anchor(tree, prefix: str, plan: FsdpPlan, stacked: bool, skip=None):
    """Gather every sharded leaf of ``tree`` (at ``prefix`` in the whole
    parameter tree) and hook every replicated one's gradient."""
    group, n, rank = data_group(plan.mesh), plan.size, plan.rank
    grad = torch.is_grad_enabled()

    def one(path, x):
        if not isinstance(x, torch.Tensor) or not x.is_floating_point():
            return x
        full = f"{prefix}/{path}" if prefix else path
        if skip is not None and full.startswith(skip):
            return x
        if full not in plan.dims:
            raise KeyError(f"no sharding for parameter {full!r} in the train step's plan")
        dim = plan.dims[full]
        if dim is not None and stacked:
            dim -= 1  # a layer's slice of a stacked [L, ...] leaf
        wide = torch.float32 if widened() else x.dtype
        if dim is None:
            return _ReduceGrad.apply(x, group, n, wide) if grad else x
        # a layer's Quartet weight, or its experts' stacks (the head is a
        # bf16 GEMM unless the config quantizes it: it gathers as it is);
        # the shard's contraction dim K must hold whole groups of 32
        if stacked and plan.fp4_allgather and (
                (_is_dense_weight(full) and x.shape[0] % 32 == 0)
                or (_is_expert_stack(full) and x.shape[1] % 32 == 0)):
            x = x.view_as(x)  # a tagged alias: quest_qdq_gathered gathers its codes
            x._fsdp_dim = dim
            return x
        return _GatherShard.apply(x, dim, group, n, rank, wide)

    return SH.tree_map_with_path(one, tree)


def constrain_layer_params(tree, path: str = "layers"):
    """Anchor a layer's parameter slice (``path``: the stacked subtree's
    place in the whole parameter tree): under a plan, gather its sharded
    leaves; the backward scatters dW to the shard.  Called inside the
    checkpointed layer body, so the recompute gathers again."""
    plan = current_plan()
    if plan is None:
        return tree
    return _anchor(tree, path, plan, stacked=True)


def constrain_params(tree, skip: str = "layers"):
    """Anchor a whole parameter tree's leaves outside the layer stack
    (``skip``; the stack gathers a layer at a time in
    :func:`constrain_layer_params`): under a plan, gather the embedding and
    head, hook the replicated norms."""
    plan = current_plan()
    if plan is None:
        return tree
    return _anchor(tree, "", plan, stacked=False, skip=skip)


def constrain_tokens(x: torch.Tensor) -> torch.Tensor:
    """Anchor [B, S, ...] activations: under a plan, a rank holds B = rows
    / ranks of the microbatch's rows (the batch over ``data``); a row count
    the ranks do not divide would take the reference's sequence-parallel
    fallback, which raises."""
    plan = current_plan()
    if plan is None or x.dim() < 2 or plan.rows is None:
        return x
    if plan.rows % plan.size or x.shape[0] * plan.size != plan.rows:
        raise NotImplementedError(f"{plan.rows} rows over {plan.size} data ranks (a rank "
                                  f"holds {x.shape[0]}): {SEQUENCE_PARALLEL}")
    return x


def constrain_logits(x: torch.Tensor) -> torch.Tensor:
    """[B, S, V]: the identity while ``model`` has one rank (vocab-parallel
    logits are tensor-parallel training, which raises)."""
    plan = current_plan()
    if plan is not None and plan.mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(f"vocab-parallel logits: {SH.TP_TRAINING}")
    return x
