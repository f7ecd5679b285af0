"""TrainState: master params + optimizer state + step, with the paper's
mixed-precision policy (an f32 master outside the quantized graph; MXFP4
only inside the linear layers, through ``quartet_linear``).  Port of
``repro.train.state``."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import Optimizer
from repro_torch.tree import tree_map


class TrainState(NamedTuple):
    params: Any  # master weights (f32 or bf16 per config), a nested dict
    opt_state: Any
    step: int


def make_train_state(params, optimizer: Optimizer,
                     master_dtype: str = "float32") -> TrainState:
    dtype = getattr(torch, master_dtype)
    master = tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params)
    return TrainState(master, optimizer.init(master), 0)
