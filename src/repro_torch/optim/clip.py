"""Global-norm gradient clipping (paper: clip at 1.0).  Port of
``repro.optim.clip``."""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (f32; leaves in the
    reference's order, dict keys sorted)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float = 1.0):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm
