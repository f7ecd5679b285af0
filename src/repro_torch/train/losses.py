"""Losses: next-token cross entropy (the paper's C4 objective) + z-loss.

Port of ``repro.train.losses``.  :func:`chunked_lm_loss` applies the LM
head and the cross entropy per sequence chunk, each chunk under
``torch.utils.checkpoint``: the whole [B, S, V] f32 logits tensor never
exists (one [B, c, V] chunk at a time), and the backward recomputes each
chunk's logits — one extra head GEMM for a vocabulary-sized saving.  Its
logsumexp over the vocabulary takes one order on the card for any number
of rows (``models.layers.row_logsumexp``), so a data-parallel rank's
tokens get one device's gradients."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import row_logsumexp


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None, z_loss: float = 0.0):
    """logits [B, S, V] (f32), labels [B, S] int.  Returns (loss, metrics)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    nll = lse - ll
    mask = torch.ones_like(nll) if mask is None else mask.to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = torch.sum(nll * mask) / denom
    metrics = {"nll": loss, "tokens": denom}
    if z_loss:
        zl = torch.sum(lse ** 2 * mask) / denom
        loss = loss + z_loss * zl
        metrics["z_loss"] = zl
    return loss, metrics


def chunked_lm_loss(head_fn, params, features, labels, seed: int,
                    mask: torch.Tensor | None = None, z_loss: float = 0.0,
                    chunk: int = 512, method: str = "quartet",
                    denom: torch.Tensor | None = None):
    """head_fn(params, x_chunk, seed, method) → f32 logits; features
    [B, S, D].  Chunks are summed in order, as the reference's scan.
    ``denom``: the token count to divide by (a data-parallel rank passes the
    global count, so its loss is its share of the global mean and each
    token's gradient is the one-device one); by default this call's own."""
    B, S, _ = features.shape
    c = min(chunk, S)
    while S % c != 0:
        c //= 2

    def one(xc, lc, mc):
        logits = head_fn(params, xc, seed, method)
        lse = row_logsumexp(logits)
        ll = torch.take_along_dim(logits, lc.long()[..., None], dim=-1)[..., 0]
        m = torch.ones_like(lse) if mc is None else mc.to(torch.float32)
        nll = torch.sum((lse - ll) * m)
        zl = torch.sum(lse ** 2 * m) if z_loss else torch.zeros((), device=lse.device)
        return nll, zl, torch.sum(m)

    grad = torch.is_grad_enabled()
    nll = zl = cnt = torch.zeros((), dtype=torch.float32, device=features.device)
    for s0 in range(0, S, c):
        args = (features[:, s0:s0 + c], labels[:, s0:s0 + c],
                None if mask is None else mask[:, s0:s0 + c])
        n_i, z_i, c_i = (checkpoint(one, *args, use_reentrant=False) if grad
                         else one(*args))
        nll, zl, cnt = nll + n_i, zl + z_i, cnt + c_i
    denom = torch.clamp(cnt if denom is None else denom, min=1.0)
    loss = nll / denom
    metrics = {"nll": loss, "tokens": denom}
    if z_loss:
        loss = loss + z_loss * zl / denom
        metrics["z_loss"] = zl / denom
    return loss, metrics
