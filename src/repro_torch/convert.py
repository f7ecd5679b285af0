"""Parameter trees: the port's own random init, and the JAX package's
params carried over leaf by leaf.

The port keeps the reference's tree paths and its stacked ``[L, ...]`` layer
leaves, so a JAX param tree (as numpy arrays, e.g. from ``jax.device_get``)
maps onto the port's by converting each leaf.  bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` numpy arrays; their bits are reinterpreted, not
rounded.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import init_lm


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights at the config's width, depth and dtype, drawn from
    ``generator`` with the reference's init laws (not its draws)."""
    return init_lm(cfg, generator, device)


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda") -> dict:
    """JAX param tree (nested dicts of numpy arrays) → the port's tree on
    ``device``.  Raises if the tree does not have the config's layout."""
    def convert(t):
        if isinstance(t, dict):
            return {k: convert(v) for k, v in t.items()}
        return _leaf(t, device)

    params = convert(np_tree)
    expect = {"embed", "layers", "final_norm"} | (set() if cfg.tie_embeddings else {"lm_head"})
    if set(params) != expect:
        raise ValueError(f"param tree has {sorted(params)}, config {cfg.name} needs "
                         f"{sorted(expect)}")
    wq = params["layers"]["attn"]["wq"]["w"]
    want = (cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim_)
    if tuple(wq.shape) != want:
        raise ValueError(f"layers.attn.wq.w is {tuple(wq.shape)}, config {cfg.name} needs {want}")
    return params
