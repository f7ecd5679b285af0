"""AdamW with f32 state (the paper's optimizer) and its 8-bit variant.

Port of ``repro.optim.adamw`` (``adamw`` and ``adamw8bit``), with its
optax-style functional interface::

    opt = adamw(lr_fn, b1, b2, eps, weight_decay)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameters, gradients and moments are nested dicts of tensors
(``repro_torch.tree``).  The update is written out of place, term for term
as the reference writes it.

``adamw8bit`` keeps each moment as int8 codes with one f32 scale per block
of 256 along the last axis (``{"q", "s"}`` at the parameter's place in the
tree): about 2 bytes of state a parameter where ``adamw`` keeps 8.  With a
bf16 master it is what lets one full-width qwen3-moe-235b-a22b layer train
on one 80 GB card.
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


# ---------------------------------------------------------------------------
# 8-bit AdamW (block-scaled int8 moments)
# ---------------------------------------------------------------------------

_BLOCK = 256


def _q8(x: torch.Tensor):
    """Symmetric int8 quantization blocked along the last axis: [..., D] →
    (q int8 [..., ceil(D/256), 256], scales f32 [..., ceil(D/256)])."""
    if x.dim() == 0:
        x = x.reshape(1)
    d = x.shape[-1]
    pad = (-d) % _BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], (d + pad) // _BLOCK, _BLOCK)
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=-1), min=1e-30) / 127.0
    q = torch.round(blocks / scale[..., None]).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    full = q.to(torch.float32) * scale[..., None]
    full = full.reshape(*full.shape[:-2], full.shape[-2] * full.shape[-1])
    d = shape[-1] if len(shape) else 1
    if full.shape[-1] != d:
        full = full[..., :d]
    return full.reshape(shape)


def adamw8bit(lr: Callable[[int], float] | float, b1: float = 0.9, b2: float = 0.95,
              eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    """AdamW with int8 block-scaled first and second moments: the
    reference's arithmetic term for term (the moments dequantized, updated in
    f32, ``nu`` clamped at 0, requantized)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def z8(p):
            q, s = _q8(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
            return {"q": q, "s": s}

        return {"mu": tree_map(z8, params), "nu": tree_map(z8, params), "step": 0}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = float(lr_fn(step))
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step

        def upd(g, mu8, nu8, p):
            g = g.to(torch.float32)
            mu = b1 * _dq8(mu8["q"], mu8["s"], g.shape) + (1 - b1) * g
            nu = b2 * _dq8(nu8["q"], nu8["s"], g.shape) + (1 - b2) * g * g
            nu = torch.clamp(nu, min=0.0)  # quantization can ring slightly negative
            u = -lr_t * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                         + weight_decay * p.to(torch.float32))
            mq, ms = _q8(mu)
            nq, ns = _q8(nu)
            return u, {"q": mq, "s": ms}, {"q": nq, "s": ns}

        out = tree_map(upd, grads, state["mu"], state["nu"], params)  # (u, mu8, nu8) leaves
        updates, mu, nu = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
        return updates, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update)
