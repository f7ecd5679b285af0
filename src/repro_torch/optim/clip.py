"""Global-norm gradient clipping (paper: clip at 1.0).  Port of
``repro.optim.clip``."""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def _sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.to(torch.float32)))


def global_norm(tree, sharded=None, reduce=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (f32; leaves in the
    reference's order, dict keys sorted).  Over data-parallel shards
    (``sharded``: a flag a leaf, in that order; ``reduce``: the sum over the
    data ranks) the shards' squares are summed across the ranks and a
    replicated leaf, whole on every rank, counts once."""
    if sharded is None:
        return torch.sqrt(sum(_sq(x) for x in tree_leaves(tree)))
    leaves = tree_leaves(tree)
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    part = sum((_sq(x) for x, s in zip(leaves, sharded) if s), zero)
    whole = sum((_sq(x) for x, s in zip(leaves, sharded) if not s), zero)
    return torch.sqrt(reduce(part) + whole)


def clip_by_global_norm(grads, max_norm: float = 1.0, sharded=None, reduce=None):
    norm = global_norm(grads, sharded, reduce)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm
