"""Mixture-of-Experts block (qwen3-moe, arctic) with Quartet expert GEMMs.

Port of ``repro.models.moe``: GShard-style grouped, capacity-based
dispatch.

  tokens  [G, g, D]   g tokens per group
  gates   [G, g, E]   dense top-k-masked router weights
  select  [G, E, c]   per (group, expert) the top-c gated tokens (capacity)
  expert  [E, G·c, D] → the expert FFN, each linear one expert-axis launch
  combine each token's ≤ k gated expert outputs added back in bf16

Routing, capacity selection, dispatch, the router and the combine are plain
PyTorch, as the reference leaves them outside any kernel.  Three points keep
them equal to the reference and deterministic on the card:

* ``jax.lax.top_k`` puts the lower index first among equal values; every
  unrouted token scores ``NEG_INF`` in capacity selection, so ties are the
  rule there.  Both top-k's here are a stable descending sort, sliced.
* The reference scatter-adds a token's summands in update order ``[G, E, c]``
  (ascending expert), rounding to bf16 after each add.  On the card
  ``index_add_`` would add them with atomics, in an order (and so to bits)
  that changes from run to run; :func:`_combine` adds them in ascending
  expert order, one bf16 add at a time, on every device.
* On the card a cuBLAS GEMM rounds a row by the call's row count (a
  speculative verify's ``B·(k+1)`` rows against a decode's ``B``); there the
  router's f32 GEMM runs one ``[B, 1]`` column of tokens at a time, as the
  serving steps apply the head, so a token's routing never depends on the
  call's shape.  The weight is cast to f32 once, so in training its
  gradient sums the columns' products in f32 and rounds once.

Every part takes gradients (MoE training).  The dispatch gather's backward
sums a token's gradients from its expert slots; :class:`_Dispatch` adds
them as :func:`_combine` adds the forward's outputs, in ascending expert
order, one add at a time in the gradient's dtype, with no atomics, so the
sum is the same on every run.  Only the gated slots count: a zero-gated
filler slot's output is multiplied by its zero gate, so its gradient is
exactly zero and adds nothing.  :func:`_combine`'s backward writes each
gated slot's gradient once (:class:`_Combine`).

Capacity ``c = max(32, round_up(k·g/E·capacity_factor, 32))`` with
``g = min(4096, B·S)`` counted over all lanes, masked ones included; tokens
over capacity are dropped.  ``token_valid`` zero-gates padding lanes, so they
never compete for capacity.  In a tensor-parallel serving step
(``cfg.tp_axis``) each rank runs its block of E/tp experts and all-gathers
their outputs on the expert axis.  The FP4 all-gather of training
(``fp4_allgather``) waits for the training half of multi-device work.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import all_gather_tiled, tp_rank
from repro_torch.models import layers as L
from repro_torch.models.attention import attention, init_attention
from repro_torch.models.transformer import init_mlp, mlp

NEG_INF = -1e30


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(np.ceil(cfg.experts_per_token * tokens_per_group / cfg.num_experts
                    * cfg.capacity_factor))
    return max(32, ((c + 31) // 32) * 32)


def init_moe_ffn(cfg: ModelConfig, dtype, generator, device) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": L.init_dense(d, e, dtype, generator, device),
        "gate": L.trunc_normal((e, d, f), 1.0 / np.sqrt(d), dtype, generator, device),
        "up": L.trunc_normal((e, d, f), 1.0 / np.sqrt(d), dtype, generator, device),
        "down": L.trunc_normal((e, f, d), 1.0 / np.sqrt(f), dtype, generator, device),
    }
    if cfg.moe_dense_residual:
        p["dense_mlp"] = init_mlp(cfg, dtype, generator, device)
    return p


def _expert_ffn(xe: torch.Tensor, params: dict, seed: int, cfg: ModelConfig,
                method: str, expert_offset: int = 0) -> torch.Tensor:
    """xe [E, T', D] → [E, T', D]: every expert's SwiGLU, each of its three
    linears one stacked call; expert e's seeds are seed_fold(seed, 20) +
    expert_offset + e in uint32, as the reference's vmap carries them (a
    tensor-parallel rank's block of experts starts at ``expert_offset``)."""
    qc = cfg.quartet
    if method == "quartet" and qc.fp4_allgather:
        from repro_torch.distributed.sharding import DEFERRED

        raise NotImplementedError(f"fp4_allgather on the stacked experts: {DEFERRED['moe']}")
    seeds = (L.seed_fold(seed, 20) + expert_offset
             + torch.arange(xe.shape[0], dtype=torch.int64, device=xe.device)) & 0xFFFFFFFF
    g = L.dense_experts(params["gate"], xe, L.seed_fold(seeds, 21), qc, method)
    u = L.dense_experts(params["up"], xe, L.seed_fold(seeds, 22), qc, method)
    h = Fn.silu(g.to(torch.float32)).to(xe.dtype) * u
    return L.dense_experts(params["down"], h, L.seed_fold(seeds, 23), qc, method)


def _top_k(v: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: descending, the lower index
    first among equal values."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_logits(w: torch.Tensor, x: torch.Tensor):
    """The router's bf16 dense on x [B, S, D] → f32 [B, S, E] (``L.dense``'s
    bf16 arithmetic); on the card one [B, 1] column at a time (module
    docstring)."""
    wf = w.to(torch.float32)

    def route(xs):
        return (xs.to(torch.float32) @ wf).to(xs.dtype)

    if x.is_cuda and x.shape[1] > 1:
        logits = torch.cat([route(x[:, s:s + 1]) for s in range(x.shape[1])], dim=1)
    else:
        logits = route(x)
    return logits.to(torch.float32)


def _slots(sel_idx: torch.Tensor, sel_gate: torch.Tensor, g: int, k: int):
    """Each token's gated expert slots in ascending expert order: (expert
    [G, g, k'], slot in the expert's selection [G, g, k'], gated [G, g, k'])
    with k' = min(k, E); where a token has fewer than k' gated slots the
    rest are marked ungated."""
    G, E, c = sel_idx.shape
    dev = sel_idx.device
    # where each (token, expert) pair sits in the expert's selection, if
    # gated: a scatter into [G, g·E + 1], the ungated entries sent to the
    # last column and dropped (an expert selects a token once, so the kept
    # targets are distinct); no boolean indexing, so nothing waits on the
    # host
    ei = torch.arange(E, device=dev)[None, :, None]
    flat = torch.where(sel_gate > 0, sel_idx * E + ei, torch.full_like(sel_idx, g * E))
    ci = torch.arange(c, device=dev).expand(G, E, c)
    pos = torch.full((G, g * E + 1), -1, dtype=torch.int64, device=dev)
    pos = pos.scatter(1, flat.reshape(G, E * c), ci.reshape(G, E * c))[:, :g * E]
    pos = pos.reshape(G, g, E)
    has = pos >= 0
    # each token's gated experts, ascending, first (a stable sort of ~has)
    order = torch.sort((~has).to(torch.uint8), dim=-1, stable=True).indices[..., :min(k, E)]
    ok = has.gather(-1, order)
    slot = torch.clamp(pos.gather(-1, order), min=0)
    return order, slot, ok


def _sum_slots(ye: torch.Tensor, e_s, c_s, ok) -> torch.Tensor:
    """out[G, t] = Σ_j ye[G, e_s[G, t, j], c_s[G, t, j]] over the gated j,
    in j order (ascending expert), each add rounded to ye's dtype."""
    G, _, _, D = ye.shape
    g = e_s.shape[1]
    out = torch.zeros((G, g, D), dtype=ye.dtype, device=ye.device)
    g_idx = torch.arange(G, device=ye.device)[:, None]
    for j in range(e_s.shape[-1]):
        val = ye[g_idx, e_s[..., j], c_s[..., j]]
        out = out + torch.where(ok[..., j, None], val, torch.zeros_like(val))
    return out


class _Combine(torch.autograd.Function):
    """The combine [G, E, c, D] → [G, g, D] (:func:`_sum_slots`); its
    backward hands each gated slot its token's gradient, one write a slot
    (the ungated j's go to a dropped row), and zero to the other slots."""

    @staticmethod
    def forward(ctx, ye, e_s, c_s, ok):
        ctx.save_for_backward(e_s, c_s, ok)
        ctx.shape = ye.shape
        return _sum_slots(ye, e_s, c_s, ok)

    @staticmethod
    def backward(ctx, dout):
        e_s, c_s, ok = ctx.saved_tensors
        G, E, c, D = ctx.shape
        kk = e_s.shape[-1]
        idx = torch.where(ok, e_s * c + c_s, torch.full_like(e_s, E * c))  # [G, g, k']
        grad = torch.zeros((G, E * c + 1, D), dtype=dout.dtype, device=dout.device)
        src = dout[:, :, None, :].expand(G, dout.shape[1], kk, D)
        grad.scatter_(1, idx.reshape(G, -1, 1).expand(G, idx[0].numel(), D),
                      src.reshape(G, -1, D))
        return grad[:, :E * c].reshape(G, E, c, D), None, None, None


class _Dispatch(torch.autograd.Function):
    """xe [G, E, c, D] = xg [G, g, D] gathered at sel_idx; the backward sums
    each token's gated slots' gradients with :func:`_sum_slots` (module
    docstring)."""

    @staticmethod
    def forward(ctx, xg, sel_idx, e_s, c_s, ok):
        ctx.save_for_backward(e_s, c_s, ok)
        G = xg.shape[0]
        return xg[torch.arange(G, device=xg.device)[:, None, None], sel_idx]

    @staticmethod
    def backward(ctx, dxe):
        e_s, c_s, ok = ctx.saved_tensors
        return _sum_slots(dxe, e_s, c_s, ok), None, None, None, None


def _combine(ye: torch.Tensor, sel_idx: torch.Tensor, sel_gate: torch.Tensor, g: int,
             k: int) -> torch.Tensor:
    """The gated expert outputs ye [G, E, c, D] back to token order [G, g, D]:
    each token's summands (at most k carry a non-zero gate; the zero-gated
    ones add ±0 and change nothing) added in ascending expert order, each
    add rounded to ye's dtype, as the reference's scatter-add does on
    XLA:CPU."""
    return _Combine.apply(ye, *_slots(sel_idx, sel_gate, g, k))


def moe_ffn(params: dict, x: torch.Tensor, seed: int, cfg: ModelConfig,
            method: str = "quartet", group_tokens: int = 4096, token_valid=None,
            return_routing: bool = False):
    """x [B, S, D] → (y [B, S, D], aux scalar); with ``return_routing`` also
    ``(sel_idx, sel_gate)`` [G, E, c].  ``token_valid`` [B, S] bool marks the
    lanes that carry real tokens: masked lanes get zero gates, score
    ``NEG_INF`` in capacity selection, add nothing to the combine and drop
    out of the load-balance statistics."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.experts_per_token
    g = min(group_tokens, T)
    G = T // g
    assert G * g == T, f"tokens {T} not divisible into groups of {g}"
    xg = x.reshape(G, g, D)

    # --- router (bf16, tiny) ---
    logits = _router_logits(params["router"]["w"], x).reshape(G, g, E)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(probs, k)
    top_sum = top_vals[..., :1]
    for j in range(1, k):  # XLA:CPU's order, elementwise: a row's sum is shape-free
        top_sum = top_sum + top_vals[..., j:j + 1]
    top_vals = top_vals / torch.clamp(top_sum, min=1e-9)
    gates = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
    if token_valid is not None:
        gates = gates * token_valid.reshape(G, g)[..., None].to(gates.dtype)

    # --- aux losses: load balance [Switch] + router z-loss ---
    me = (gates > 0).to(torch.float32).mean(dim=1)
    pe = probs.mean(dim=1)
    aux = E * torch.mean(torch.sum(me * pe, dim=-1))
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = aux + cfg.router_zloss * zloss

    # --- capacity selection: per (G, E) the top-c gated tokens ---
    c = min(moe_capacity(cfg, g), g)
    scores = torch.where(gates > 0, gates, torch.full_like(gates, NEG_INF))
    sel_val, sel_idx = _top_k(scores.transpose(1, 2), c)  # [G, E, c]
    sel_gate = torch.where(sel_val > 0, sel_val, torch.zeros_like(sel_val))

    # --- dispatch, expert FFN ---
    slots = _slots(sel_idx, sel_gate, g, k)
    xe = _Dispatch.apply(xg, sel_idx, *slots)  # [G, E, c, D]
    xe = xe.transpose(0, 1).reshape(E, G * c, D)
    tp = cfg.tp_size if cfg.tp_axis is not None and cfg.tp_size > 1 and E % cfg.tp_size == 0 \
        else 1
    if tp > 1:
        # expert parallelism in a tensor-parallel serving step: this rank's
        # contiguous block of E/tp experts (weights and dispatched tokens),
        # then the blocks all-gathered back to the whole expert axis — a
        # concatenation, so the combine below adds in one device's order.
        # Routing and capacity ran on replicated inputs, the same on every rank
        r, El = tp_rank(cfg.tp_axis), E // tp
        blk = slice(r * El, (r + 1) * El)
        eparams = {**params, "gate": params["gate"][blk], "up": params["up"][blk],
                   "down": params["down"][blk]}
        ye = _expert_ffn(xe[blk], eparams, seed, cfg, method, expert_offset=r * El)
        ye = all_gather_tiled(ye, 0, cfg.tp_axis)
    else:
        ye = _expert_ffn(xe, params, seed, cfg, method)
    ye = ye.reshape(E, G, c, D).transpose(0, 1)
    ye = ye * sel_gate[..., None].to(ye.dtype)

    # --- combine (bf16, fixed order) ---
    y = _Combine.apply(ye.to(x.dtype), *slots).reshape(B, S, D)
    if cfg.moe_dense_residual:
        y = y + mlp(params["dense_mlp"], x, L.seed_fold(seed, 30), cfg, method)
    y = y.to(x.dtype)
    if return_routing:
        return y, aux, (sel_idx, sel_gate)
    return y, aux


def init_moe_block(cfg: ModelConfig, dtype, generator, device) -> dict:
    return {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": init_attention(cfg, dtype, generator, device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "moe": init_moe_ffn(cfg, dtype, generator, device),
    }


def moe_block(params: dict, x: torch.Tensor, positions: torch.Tensor, seed: int,
              cfg: ModelConfig, cache, method: str, cache_index: torch.Tensor | None = None,
              token_valid: torch.Tensor | None = None, rope=None):
    """→ (x [B, S, D], the layer's aux loss, an f32 scalar)."""
    h, _ = attention(params["attn"], L.rmsnorm(params["attn_norm"], x, cfg.norm_eps),
                     positions, L.seed_fold(seed, 100), cfg, causal=cfg.is_causal_lm,
                     kv_cache=cache, cache_index=cache_index, method=method, rope=rope)
    x = x + h
    h, aux = moe_ffn(params["moe"], L.rmsnorm(params["mlp_norm"], x, cfg.norm_eps),
                     L.seed_fold(seed, 200), cfg, method, token_valid=token_valid)
    return x + h, aux
