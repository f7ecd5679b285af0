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

Under FSDP (``shardings=(mesh, param specs)``: a rank's shards of the
parameters and gradients) the 8-bit moments follow
``distributed.sharding.opt_partition``: where a leaf is split along a
leading dim, or along its last dim into whole blocks of 256, its moments
split with it and the update is shard-local; where the last dim's split
leaves a block across two ranks, or the block count does not divide over
them (the moments are kept whole), the rank gathers the gradient (and
split moments), updates the whole leaf's moments and keeps its slice of
the update and of split moments.  Either way a rank's result is the slice
of the one-device update, bit for bit (elementwise arithmetic on the same
blocks).  ``Optimizer.sharded`` marks an optimizer whose ``init`` and
``update`` take ``shardings``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    sharded: bool = False  # init and update take ``shardings=(mesh, param specs)``


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
_CHUNK = 1 << 26  # elements of a leaf that the 8-bit update takes at once


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


def _split_blocks(spec, shard_shape, shardings):
    """How a rank's shard of a leaf meets the 8-bit blocks along its last
    axis: None when the update is shard-local (no split across ranks, a
    split along a leading dim, or one into whole blocks of 256), else
    (mesh, rank, ranks, moments split on the block dim)."""
    if shardings is None or not shard_shape:
        return None
    from repro_torch.distributed import sharding as SH

    mesh = shardings[0]
    r, n = SH.data_rank_and_size(mesh)
    if n == 1 or SH.sharded_dim(spec, mesh) != len(shard_shape) - 1:
        return None
    whole = shard_shape[-1] * n
    split = -(-whole // _BLOCK) % n == 0  # opt_partition's rule for the block dim
    if split and whole % (_BLOCK * n) == 0:
        return None
    return mesh, r, n, split


def _specs(params, shardings):
    """The parameters' spec tree, or a tree of None without shardings."""
    return shardings[1] if shardings is not None else tree_map(lambda _: None, params)


def adamw8bit(lr: Callable[[int], float] | float, b1: float = 0.9, b2: float = 0.95,
              eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    """AdamW with int8 block-scaled first and second moments: the
    reference's arithmetic term for term (the moments dequantized, updated in
    f32, ``nu`` clamped at 0, requantized).  With ``shardings`` the state
    and update are a rank's (module docstring)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params, shardings=None):
        def z8(p, spec):
            shape = tuple(p.shape)
            split = _split_blocks(spec, shape, shardings)
            if split is not None and not split[3]:  # the whole leaf's moments
                shape = shape[:-1] + (shape[-1] * split[2],)
            q, s = _q8(torch.zeros(shape, dtype=torch.float32, device=p.device))
            return {"q": q, "s": s}

        specs = _specs(params, shardings)
        return {"mu": tree_map(z8, params, specs), "nu": tree_map(z8, params, specs), "step": 0}

    def update(grads, state, params, shardings=None):
        step = state["step"] + 1
        lr_t = float(lr_fn(step))
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step

        def upd(g, mu8, nu8, p, spec):
            split = _split_blocks(spec, tuple(g.shape), shardings)
            if split is None and g.dim() >= 2 and g.numel() > _CHUNK and g.shape[0] > 1:
                # a large stacked leaf a slab of leading rows at a time: its
                # blocks lie along the last axis, so each slab's arithmetic is
                # the whole leaf's there, with slab-sized temporaries
                rows = max(1, _CHUNK // (g.numel() // g.shape[0]))
                u = torch.empty(g.shape, dtype=torch.float32, device=g.device)
                mu_o = {k: torch.empty_like(v) for k, v in mu8.items()}
                nu_o = {k: torch.empty_like(v) for k, v in nu8.items()}
                for i in range(0, g.shape[0], rows):
                    sl = slice(i, i + rows)
                    ui, mi, ni = one(g[sl], {k: v[sl] for k, v in mu8.items()},
                                     {k: v[sl] for k, v in nu8.items()}, p[sl], None)
                    u[sl] = ui
                    for k in mi:
                        mu_o[k][sl], nu_o[k][sl] = mi[k], ni[k]
                return u, mu_o, nu_o
            return one(g, mu8, nu8, p, split)

        def one(g, mu8, nu8, p, split):
            g = g.to(torch.float32)
            sl = Ellipsis
            if split is not None:
                from repro_torch.distributed.context import gather_data

                mesh, r, n, on_blocks = split
                m = g.shape[-1]
                sl = (Ellipsis, slice(r * m, (r + 1) * m))
                g = gather_data(g, g.dim() - 1, mesh)
                if on_blocks:
                    mu8, nu8 = ({"q": gather_data(t["q"], t["q"].dim() - 2, mesh),
                                 "s": gather_data(t["s"], t["s"].dim() - 1, mesh)}
                                for t in (mu8, nu8))
            mu = b1 * _dq8(mu8["q"], mu8["s"], g.shape) + (1 - b1) * g
            nu = b2 * _dq8(nu8["q"], nu8["s"], g.shape) + (1 - b2) * g * g
            nu = torch.clamp(nu, min=0.0)  # quantization can ring slightly negative
            u = -lr_t * ((mu[sl] / bc1) / (torch.sqrt(nu[sl] / bc2) + eps)
                         + weight_decay * p.to(torch.float32))
            mq, ms = _q8(mu)
            nq, ns = _q8(nu)
            if split is not None and split[3]:  # this rank's blocks
                nb = ms.shape[-1] // split[2]
                blk = slice(split[1] * nb, (split[1] + 1) * nb)
                mq, nq = mq[..., blk, :].contiguous(), nq[..., blk, :].contiguous()
                ms, ns = ms[..., blk].contiguous(), ns[..., blk].contiguous()
            return u, {"q": mq, "s": ms}, {"q": nq, "s": ns}

        out = tree_map(upd, grads, state["mu"], state["nu"], params,
                       _specs(params, shardings))  # (u, mu8, nu8) leaves
        updates, mu, nu = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
        return updates, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update, sharded=True)
