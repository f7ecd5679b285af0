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
  speculative verify's ``B·(k+1)`` rows against a decode's ``B``, a data
  rank's B/n rows against one device's B); there the router's f32 GEMM
  runs on blocks of ``ROUTER_ROWS`` tokens, the last padded with zero rows,
  so every GEMM has one shape and a token's routing never depends on the
  call's.  The weight is cast to f32 once, so in training its gradient sums
  the blocks' products in f32 and rounds once.  The softmax and logsumexp
  over the experts likewise take one order there, forward and backward
  (``layers.row_softmax``, ``layers.row_logsumexp``): torch's reductions
  round a row by the call's row count.

Every part takes gradients (MoE training).  The dispatch gather's backward
sums a token's gradients from its expert slots; :class:`_Dispatch` adds
them as :func:`_combine` adds the forward's outputs, in ascending expert
order, one add at a time in the gradient's dtype, with no atomics, so the
sum is the same on every run.  Only the gated slots count: a zero-gated
filler slot's output is multiplied by its zero gate, so its gradient is
exactly zero and adds nothing.  :func:`_combine`'s backward writes each
gated slot's gradient once (:class:`_Combine`).

Capacity ``c = max(32, round_up(k·g/E·capacity_factor, 32))`` with
``g = min(4096, T)`` counted over all lanes, masked ones included; tokens
over capacity are dropped.  ``token_valid`` zero-gates padding lanes, so they
never compete for capacity.  In a tensor-parallel serving step
(``cfg.tp_axis``) each rank runs its block of E/tp experts and all-gathers
their outputs on the expert axis.  With ``fp4_allgather`` the expert stacks
are rotated and QuEST-quantized whole (a rank's shards under the train
step's anchors, their codes all-gathered) before a block of experts is
taken, as the reference quantizes them before its vmap.

Data-parallel training (``distributed.context``'s plan): T is the global
microbatch's tokens, so every rank computes what one device computes
(``distributed.context.moe_group_layout``).  Where a rank holds whole
groups, routing, capacity, dispatch and the combine are rank-local (every
piece is per row), and expert e's slot axis of the logical [E, G·c, D] is
this rank's block of G_l·c slots, the window the experts' backward draws
its token-axis uniforms and signs in.  Where ``share`` ranks hold one group
between them, each gathers the group's tokens and router logits and routes
the whole group alike; member j runs experts [j·E/share, (j + 1)·E/share)
over the group's slots (the seeds at their global index) and the blocks are
gathered on the expert axis; each member combines its own tokens.  The
backward keeps one device's order: the slot gradients come back to their
expert's member by a reduce-scatter whose other summands are exactly zero,
and each member gathers every block's dispatch gradients and sums its own
tokens' slots in ascending expert order (:class:`_GroupDispatch`).  A
token's router, aux and z-loss terms count on its own rank only: the aux
loss is each rank's share of one device's value (its groups, or its rows'
part of a shared group's mean router probability, over the global group and
token counts), so the ranks' shares sum to it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quartet import quartet_linear_pq, quest_qdq_gathered
from repro_torch.distributed import context as C
from repro_torch.distributed.context import all_gather_tiled, tp_rank
from repro_torch.models import layers as L
from repro_torch.models.attention import attention, init_attention
from repro_torch.models.transformer import init_mlp, mlp

NEG_INF = -1e30
ROUTER_ROWS = 256  # tokens a router GEMM on the card: one shape for any call


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
                method: str, expert_offset: int = 0, experts: slice | None = None,
                window=(0, None)) -> torch.Tensor:
    """xe [E', T', D] → [E', T', D]: every expert's SwiGLU, each of its
    three linears one stacked call, over the stacks' block ``experts`` (all
    of them by default); expert e's seeds are seed_fold(seed, 20) +
    expert_offset + e in uint32, as the reference's vmap carries them (a
    block of experts starts at ``expert_offset``).  ``window`` (offset,
    row length) places the T' slots in an expert's logical slot axis, for
    the backward's draws."""
    qc = cfg.quartet
    seeds = (L.seed_fold(seed, 20) + expert_offset
             + torch.arange(xe.shape[0], dtype=torch.int64, device=xe.device)) & 0xFFFFFFFF

    def linear(name, x, s):
        w = params[name]
        if method == "quartet" and qc.fp4_allgather and w.shape[1] % 32 == 0:
            # the whole stack (or a rank's shard) quantized, its codes
            # gathered, then the block taken
            vals, mask, codes, scales = quest_qdq_gathered(w, qc)
            if experts is not None:
                vals, codes, scales = vals[experts], codes[experts], scales[experts]
            return quartet_linear_pq(x, vals, mask, s, qc, codes, scales, window)
        return L.dense_experts(w if experts is None else w[experts], x, s, qc, method, window)

    g = linear("gate", xe, L.seed_fold(seeds, 21))
    u = linear("up", xe, L.seed_fold(seeds, 22))
    h = Fn.silu(g.to(torch.float32)).to(xe.dtype) * u
    return linear("down", h, L.seed_fold(seeds, 23))


def _top_k(v: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: descending, the lower index
    first among equal values."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_logits(w: torch.Tensor, x: torch.Tensor):
    """The router's bf16 dense on x [B, S, D] → f32 [B, S, E] (``L.dense``'s
    bf16 arithmetic); on the card a block of ``ROUTER_ROWS`` tokens at a
    time (module docstring)."""
    wf = w.to(torch.float32)

    def route(xs):
        return (xs.to(torch.float32) @ wf).to(xs.dtype)

    if not x.is_cuda:
        return route(x).to(torch.float32)
    B, S, D = x.shape
    flat = x.reshape(B * S, D)
    pad = (-flat.shape[0]) % ROUTER_ROWS
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, D))])
    logits = torch.cat([route(blk) for blk in flat.split(ROUTER_ROWS)])[:B * S]
    return logits.reshape(B, S, -1).to(torch.float32)


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


class _GroupDispatch(torch.autograd.Function):
    """A shared group's dispatch for this member's block of experts: xe
    [E_l, c, D] = the group's tokens (this member's x_own [T_l, D] gathered
    with the others') at sel_blk [E_l, c].  The backward gathers every
    member's block of slot gradients (the whole expert axis) and sums this
    member's tokens' gated slots (its rows of the slots, [1, T_l, k']) with
    :func:`_sum_slots`, as one device's :class:`_Dispatch` sums them."""

    @staticmethod
    def forward(ctx, x_own, sel_blk, e_s, c_s, ok, lay):
        ctx.save_for_backward(e_s, c_s, ok)
        ctx.lay = lay
        return C.gather_group(x_own, 0, lay)[sel_blk]

    @staticmethod
    def backward(ctx, dxe):
        e_s, c_s, ok = ctx.saved_tensors
        dall = C.gather_group(dxe.contiguous(), 0, ctx.lay)  # [E, c, D]
        return _sum_slots(dall[None], e_s, c_s, ok)[0], None, None, None, None, None


_ROUTING: list[dict] = []


@contextlib.contextmanager
def recording_routing():
    """Within the block, every ``moe_ffn`` call records its routing into
    the dict it yields: its seed → (first global group, sel_idx, sel_gate
    [G_l, E, c]) of the groups this rank routed (a recompute overwrites a
    layer's entry with the same values)."""
    log: dict = {}
    _ROUTING.append(log)
    try:
        yield log
    finally:
        _ROUTING.pop()


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
    ``(sel_idx, sel_gate)`` [G, E, c] of the groups this rank routed.
    ``token_valid`` [B, S] bool marks the lanes that carry real tokens:
    masked lanes get zero gates, score ``NEG_INF`` in capacity selection,
    add nothing to the combine and drop out of the load-balance
    statistics.  Under a data-parallel plan the groups are the global
    microbatch's (module docstring)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    ranks = C.token_window()[1]
    lay = C.moe_group_layout(B * S, group_tokens, E)
    g, G = lay.g, lay.local
    tl = B * S  # this rank's tokens
    own = slice(lay.member * tl, (lay.member + 1) * tl)  # its rows of a shared group

    # --- router (bf16, tiny): this rank's tokens, a shared group's gathered ---
    logits_own = _router_logits(params["router"]["w"], x).reshape(tl, E)
    logits = C.gather_own_rows(logits_own, lay).reshape(G, g, E)
    probs, lse = L.row_softmax(logits), L.row_logsumexp(logits)
    top_vals, top_idx = _top_k(probs, k)
    top_sum = top_vals[..., :1]
    for j in range(1, k):  # XLA:CPU's order, elementwise: a row's sum is shape-free
        top_sum = top_sum + top_vals[..., j:j + 1]
    top_vals = top_vals / torch.clamp(top_sum, min=1e-9)
    gates = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
    if token_valid is not None:
        valid = C.gather_group(token_valid.reshape(tl).to(torch.uint8), 0, lay)
        gates = gates * valid.reshape(G, g)[..., None].to(gates.dtype)

    # --- aux losses: load balance [Switch] + router z-loss ---
    me = (gates > 0).to(torch.float32).mean(dim=1)
    if ranks == 1:
        pe = probs.mean(dim=1)
        aux = E * torch.mean(torch.sum(me * pe, dim=-1))
        zloss = torch.mean(lse ** 2)
    else:
        # this rank's share: its groups' terms, or its rows' part of a
        # shared group's mean probability and z-loss, over the global counts
        if lay.share == 1:
            pe = probs.mean(dim=1)
        else:
            pe, lse = probs[:, own].sum(dim=1) / g, lse[:, own]
        aux = E * torch.sum(torch.sum(me * pe, dim=-1)) / lay.groups
        zloss = torch.sum(lse ** 2) / (lay.groups * g)
    aux = aux + cfg.router_zloss * zloss

    # --- capacity selection: per (G, E) the top-c gated tokens ---
    c = min(moe_capacity(cfg, g), g)
    scores = torch.where(gates > 0, gates, torch.full_like(gates, NEG_INF))
    sel_val, sel_idx = _top_k(scores.transpose(1, 2), c)  # [G, E, c]
    sel_gate = torch.where(sel_val > 0, sel_val, torch.zeros_like(sel_val))
    if _ROUTING:
        _ROUTING[-1][seed] = (lay.first, sel_idx.detach(), sel_gate.detach())

    # --- dispatch, expert FFN ---
    slots = _slots(sel_idx, sel_gate, g, k)
    # the slots' place on an expert's logical slot axis (its G·c slots)
    window = (0, None) if ranks == 1 else (lay.first * c, lay.groups * c)
    tp = cfg.tp_size if cfg.tp_axis is not None and cfg.tp_size > 1 and E % cfg.tp_size == 0 \
        else 1
    if lay.share > 1:
        # a group shared by `share` data ranks: this member's block of
        # experts over the group's slots, the blocks gathered on the expert
        # axis; the combine below adds its own tokens' slots
        El = E // lay.share
        blk = slice(lay.member * El, (lay.member + 1) * El)
        slots = tuple(t[:, own] for t in slots)
        xe = _GroupDispatch.apply(x.reshape(tl, D), sel_idx[0, blk], *slots, lay)
        ye = _expert_ffn(xe, params, seed, cfg, method, lay.member * El, blk, window)
        ye = C.gather_blocks(ye, lay)
    else:
        xe = _Dispatch.apply(x.reshape(G, g, D), sel_idx, *slots)  # [G, E, c, D]
        xe = xe.transpose(0, 1).reshape(E, G * c, D)
        if tp > 1:
            # expert parallelism in a tensor-parallel serving step: this rank's
            # contiguous block of E/tp experts (weights and dispatched tokens),
            # then the blocks all-gathered back to the whole expert axis — a
            # concatenation, so the combine below adds in one device's order.
            # Routing and capacity ran on replicated inputs, the same on every
            # rank
            r, El = tp_rank(cfg.tp_axis), E // tp
            blk = slice(r * El, (r + 1) * El)
            ye = _expert_ffn(xe[blk], params, seed, cfg, method, r * El, blk)
            ye = all_gather_tiled(ye, 0, cfg.tp_axis)
        else:
            ye = _expert_ffn(xe, params, seed, cfg, method, window=window)
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
