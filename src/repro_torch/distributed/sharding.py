"""Sharding rules: param path → PartitionSpec, MaxText-style.

Port of ``repro.distributed.sharding``: the same rule table as pure
functions over a tree path, a leaf shape and the mesh's axis sizes.  The
rules read only ``mesh.shape`` (axis name → size) and ``mesh.axis_names``,
so any object with those two attributes serves as a mesh
(``launch.mesh.Mesh``, or a stand-in holding sizes only).

Mesh axes: ``(pod, data, model)`` multi-pod or ``(data, model)`` single-pod.

  * batch/tokens      → (pod, data)            [DP]
  * weights, K dim    → data (+pod)            [FSDP / ZeRO-3]
  * weights, N dim    → model                  [TP: heads / d_ff / vocab]
  * MoE expert dim    → model                  [EP]
  * long-context seq  → data                   [SP / context parallelism]
  * mamba inner dim   → model                  [SSM TP]

Every mapping is divisibility-guarded: a dim is sharded only if the axis
size divides it.  Trees are nested dicts, lists and tuples (a NamedTuple
keeps its type) whose leaves have a ``.shape``: torch tensors, or the
shapes of another package's tree.  Paths join dict keys and sequence
indices with ``/``.  Serving uses :func:`serve_pool_partition` (the pool's
KV-head axis).  Training shards by :func:`param_partition` over the
data-parallel axes (FSDP): :func:`shard_tree` takes a rank's slice of a
whole tree, :func:`unshard_tree` gathers the whole back (a collective:
every rank of the data group calls it); :func:`partition_state` gives a
state's specs, the 8-bit moments' by the whole parameters' block counts.
A spec's ``model`` entries are honoured only while the mesh's ``model``
axis has one rank: tensor parallelism in training is not ported
(``DEFERRED``, ROADMAP A8d.5) and raises.
"""

from __future__ import annotations

import re
from typing import Any


class PartitionSpec(tuple):
    """One leaf's sharding: per dim an axis name, a tuple of axis names, or
    None (replicated).  A tuple, so it compares equal to the reference's
    ``tuple(jax.sharding.PartitionSpec(...))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") or isinstance(x, PartitionSpec)


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree's leaves (dicts, lists, tuples and
    NamedTuples keep their structure; ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _join(path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        out = [tree_map_with_path(fn, v, _join(path, i)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(path, tree)


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _map(fn, tree, *rest):
    """``fn`` over ``tree``'s leaves and the matching subtrees of ``rest``
    (whose structure may go deeper than ``tree``'s at a leaf)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        out = [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def fsdp_axes(mesh, include_pod: bool):
    if include_pod and "pod" in mesh.axis_names:
        return ("pod", "data")
    return ("data",)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fit(mesh, dim: int, axes):
    """``axes`` if its size divides ``dim``, else the longest prefix of it
    that does (None if none).  A string stays a string, a tuple a tuple."""
    if axes is None:
        return None
    was_str = isinstance(axes, str)
    if was_str:
        axes = (axes,)
    while axes and dim % _axis_size(mesh, axes) != 0:
        axes = axes[:-1]
    if not axes:
        return None
    return axes[0] if was_str else tuple(axes)


def _pad(shape, trailing) -> tuple:
    """Left-pad a trailing-dims spec with None for stacked leading dims."""
    return tuple([None] * (len(shape) - len(trailing))) + tuple(trailing)


def _spec_for(path: str, shape: tuple[int, ...], mesh, fsdp) -> PartitionSpec:
    """The rule table, over the unstacked parameter's trailing dims; a
    leading stack dim (layers, super-blocks) is padded with None."""
    tp = "model"

    def fit(dim, axes):
        return _fit(mesh, dim, axes)

    # embeddings / lm head
    if re.search(r"embed/table$", path):
        v, d = shape[-2:]
        return P(fit(v, tp), fit(d, fsdp))
    if re.search(r"lm_head/w$", path):
        d, v = shape[-2:]
        return P(*_pad(shape, (fit(d, fsdp), fit(v, tp))))
    # MoE experts: [.., E, K, N]
    if re.search(r"moe/(gate|up)$", path):
        e, d, _ = shape[-3:]
        return P(*_pad(shape, (fit(e, tp), fit(d, fsdp), None)))
    if re.search(r"moe/down$", path):
        e, _, d = shape[-3:]
        return P(*_pad(shape, (fit(e, tp), None, fit(d, fsdp))))
    if re.search(r"moe/router/w$", path):
        d, _ = shape[-2:]
        return P(*_pad(shape, (fit(d, fsdp), None)))
    # column-parallel linears: K → fsdp, N → tp
    if re.search(r"(wq|wk|wv|gate|up|in_proj|dt_proj)/w$", path):
        k, n = shape[-2:]
        return P(*_pad(shape, (fit(k, fsdp), fit(n, tp))))
    # row-parallel linears: K → tp, N → fsdp
    if re.search(r"(wo|down|out_proj|x_proj)/w$", path):
        k, n = shape[-2:]
        return P(*_pad(shape, (fit(k, tp), fit(n, fsdp))))
    # biases of column-parallel layers
    if re.search(r"(wq|wk|wv|gate|up|in_proj|dt_proj)/b$", path):
        return P(*_pad(shape, (fit(shape[-1], tp),)))
    # SSM internals: inner dim → tp
    if re.search(r"conv_w$", path):
        return P(*_pad(shape, (None, fit(shape[-1], tp))))
    if re.search(r"conv_b$", path):
        return P(*_pad(shape, (fit(shape[-1], tp),)))
    if re.search(r"A_log$", path) and len(shape) >= 2:
        return P(*_pad(shape, (fit(shape[-2], tp), None)))
    # everything else (norms, scalars, small vectors): replicated
    return P(*([None] * len(shape)))


def param_partition(params: Any, mesh, include_pod_fsdp: bool = True):
    """PartitionSpec tree for a param tree."""
    fsdp = fsdp_axes(mesh, include_pod_fsdp)
    return tree_map_with_path(
        lambda path, leaf: _spec_for(path, tuple(leaf.shape), mesh, fsdp), params)


def _is_int8(leaf) -> bool:
    return str(getattr(leaf, "dtype", "")).removeprefix("torch.") == "int8"


def opt_partition(opt_state: dict, param_specs: Any, mesh, blocks: Any = None) -> dict:
    """Adam moments inherit their parameter's spec; the 8-bit moments
    (``{"q": [..., n, 256], "s": [..., n]}`` blocked along the param's last
    axis) keep its leading dims' sharding, and its last dim's axis moves to
    the block-count dim when that count stays divisible.  The count is the
    whole state's: ``q``'s, or for a state of shards ``blocks`` (a tree of
    each parameter's whole block count, :func:`partition_state`)."""

    def like(spec, leaf):
        if hasattr(leaf, "shape") and len(leaf.shape) == len(spec):
            return spec
        return P(*([None] * len(getattr(leaf, "shape", ()))))

    def q8spec(spec, m, nb=None):
        if not isinstance(m, dict):
            return P(*([None] * len(m.shape)))
        parts = list(spec)
        lead = parts[:-1]
        nb = m["q"].shape[-2] if nb is None else nb
        last = _fit(mesh, nb, parts[-1]) if parts else None
        qdims, sdims = len(m["q"].shape), len(m["s"].shape)
        qspec = (lead + [last, None])[:qdims]
        qspec = [None] * (qdims - len(qspec)) + qspec
        sspec = (lead + [last])[:sdims]
        sspec = [None] * (sdims - len(sspec)) + sspec
        return {"q": P(*qspec), "s": P(*sspec)}

    out = {}
    for key in opt_state:
        if key == "step":
            out[key] = P()
        elif any(_is_int8(x) for x in _leaves(opt_state[key])):
            out[key] = (_map(q8spec, param_specs, opt_state[key]) if blocks is None
                        else _map(q8spec, param_specs, opt_state[key], blocks))
        else:
            out[key] = _map(like, param_specs, opt_state[key])
    return out


def partition_state(state, param_specs, mesh, sharded: bool = False):
    """Specs for a ``train.state.TrainState``: a whole one, or with
    ``sharded`` a rank's shards of one (as ``train.loop`` holds it), whose
    8-bit moments split by the whole parameters' block counts."""
    from repro_torch.train.state import TrainState

    blocks = None
    if sharded:
        n = data_rank_and_size(mesh)[1]

        def count(spec, p):
            if not len(p.shape):
                return 1
            last = p.shape[-1] * (n if sharded_dim(spec, mesh) == len(p.shape) - 1 else 1)
            return -(-last // 256)

        blocks = _map(count, param_specs, state.params)
    opt = opt_partition(state.opt_state, param_specs, mesh, blocks)
    return TrainState(param_specs, opt, P(), None if state.err is None else param_specs)


# ---------------------------------------------------------------------------
# Inputs / caches / the serving pool
# ---------------------------------------------------------------------------


def batch_partition(mesh, batch: int, seq: int | None = None) -> PartitionSpec:
    """Token batches: batch over the DP axes; the sequence over ``data``
    when the batch is too small (context parallelism)."""
    dp = _fit(mesh, batch, dp_axes(mesh))
    if dp is not None and _axis_size(mesh, dp) > 1:
        return P(dp, None)
    if seq is not None and seq % mesh.shape["data"] == 0:
        return P(None, "data")
    return P(None, None)


def serve_pool_partition(pool: Any, mesh) -> Any:
    """PartitionSpecs for the serving pool: every leaf is ``[L, n_pages,
    page, H, payload]``, sharded on the KV-head axis (axis 3) over
    ``model`` when the axis size divides H, else replicated — which the
    models' shape-based detection reads as "not sharded"."""
    return tree_map_with_path(
        lambda _, leaf: P(None, None, None, _fit(mesh, leaf.shape[3], "model"), None), pool)


def cache_partition(cache_specs: Any, mesh, batch: int) -> Any:
    """KV/SSM cache sharding: the batch dim → DP axes if divisible; the
    head-like or inner dim → model if divisible; long sequences → data."""

    def spec(_, leaf):
        shape = tuple(leaf.shape)
        out = [None] * len(shape)
        bdim = next((i for i, s in enumerate(shape) if s == batch and i > 0), None)
        dp = _fit(mesh, batch, dp_axes(mesh))
        batch_sharded = bdim is not None and dp is not None and _axis_size(mesh, dp) > 1
        if batch_sharded:
            out[bdim] = dp
        start = (bdim + 1) if bdim is not None else (1 if len(shape) > 1 else 0)
        free = [i for i in range(start, len(shape)) if out[i] is None]

        def fits(i, axis):
            return shape[i] % mesh.shape[axis] == 0 and shape[i] >= mesh.shape[axis]

        # model axis: the head-like dim (second to last, <= 512), else the
        # largest remaining divisible dim
        mi = None
        if len(shape) >= 2 and (len(shape) - 2) in free and shape[-2] <= 512 \
                and fits(len(shape) - 2, "model"):
            mi = len(shape) - 2
        else:
            mi = next((i for i in sorted(free, key=lambda i: -shape[i])
                       if fits(i, "model")), None)
        if mi is not None:
            out[mi] = "model"
            free.remove(mi)
        # data axis (when the batch could not use it): the sequence-like dim
        if not batch_sharded:
            for i in sorted(free, key=lambda i: -shape[i]):
                if shape[i] > 1024 and fits(i, "data"):
                    out[i] = "data"
                    break
        return P(*out)

    return tree_map_with_path(spec, cache_specs)


# ---------------------------------------------------------------------------
# Training: a rank's shard of a tree, and the whole back
# ---------------------------------------------------------------------------

# what data-parallel training does not do yet, each with its ROADMAP item;
# every one raises at more than one data rank
DEFERRED = {
    "grad_compress": "grad_compress on shards (ROADMAP A8d.2, its remainder)",
    "baseline": "the paper's baseline methods across data ranks (ROADMAP A8d.2, its remainder)",
    "sequence_parallel": "constrain_tokens' sequence-parallel fallback (ROADMAP A8d.3)",
    "family": "the SSM, hybrid, enc-dec and VLM families across devices (ROADMAP A8d.4)",
    "tp": "tensor parallelism in training (ROADMAP A8d.5)",
}
TP_TRAINING = DEFERRED["tp"]


def data_axes_of(entry) -> tuple:
    """The data-parallel axes named by one spec entry (() for none)."""
    if entry is None:
        return ()
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(a for a in axes if a in ("pod", "data"))


def sharded_dim(spec, mesh) -> int | None:
    """The dim a leaf is split along over the data-parallel axes (FSDP), or
    None for a leaf every data rank holds whole.  Raises on a dim split
    over a ``model`` axis of more than one rank."""
    dim = None
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if any(a == "model" and mesh.shape["model"] > 1 for a in axes):
            raise NotImplementedError(f"a spec over 'model' ({spec}) on a mesh of "
                                      f"{mesh.shape['model']} model ranks: {TP_TRAINING}")
        if data_axes_of(entry):
            if dim is not None:
                raise ValueError(f"spec {spec} splits two dims over the data axes")
            dim = i
    return dim


def data_rank_and_size(mesh) -> tuple[int, int]:
    """This rank's index on the mesh's data-parallel axes (``pod`` major)
    and their size."""
    r, n = 0, 1
    for a in dp_axes(mesh):
        r = r * mesh.shape[a] + mesh.axis_index(a)
        n *= mesh.shape[a]
    return r, n


def shard_leaf(x, spec, mesh):
    """This rank's slice of a whole leaf (a view; a leaf held whole comes
    back as it is)."""
    dim = sharded_dim(spec, mesh)
    if dim is None:
        return x
    r, n = data_rank_and_size(mesh)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    m = x.shape[dim] // n
    return x.narrow(dim, r * m, m)


def shard_tree(tree, specs, mesh):
    """A rank's slice of every leaf of a whole tree, by its spec (``specs``
    a tree of PartitionSpecs of the same structure, as
    :func:`param_partition` or :func:`partition_state` give).  Non-tensor
    leaves (a step counter) come back as they are."""
    def one(x, spec):
        return shard_leaf(x, spec, mesh) if hasattr(x, "narrow") else x

    return _map(one, tree, specs)


def unshard_leaf(x, spec, mesh):
    """The whole leaf from every data rank's slice (an all-gather over the
    data-parallel group, rank order)."""
    dim = sharded_dim(spec, mesh)
    if dim is None:
        return x
    from repro_torch.distributed.context import gather_data

    return gather_data(x, dim, mesh)


def unshard_tree(tree, specs, mesh):
    """The whole tree back from the ranks' slices: one all-gather a sharded
    leaf, in tree order (every rank of the data group calls it)."""
    def one(x, spec):
        return unshard_leaf(x, spec, mesh) if hasattr(x, "narrow") else x

    return _map(one, tree, specs)
