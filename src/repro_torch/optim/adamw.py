"""AdamW with f32 state, the paper's optimizer.

Port of ``repro.optim.adamw`` (``adamw``; the 8-bit variant arrives with
the baselines slice), with its optax-style functional interface::

    opt = adamw(lr_fn, b1, b2, eps, weight_decay)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameters, gradients and moments are nested dicts of tensors
(``repro_torch.tree``).  The update is written out of place, term for term
as the reference writes it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)


def adamw(lr: Callable[[int], float] | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params), "step": 0}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = float(lr_fn(step))
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step

        def upd(g, mu, nu, p):
            g = g.to(torch.float32)
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            mhat = mu / bc1
            nhat = nu / bc2
            u = -lr_t * (mhat / (torch.sqrt(nhat) + eps) + weight_decay * p.to(torch.float32))
            return u, mu, nu

        out = tree_map(upd, grads, state["mu"], state["nu"], params)  # (u, mu, nu) leaves
        updates, mu, nu = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
        return updates, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update)
