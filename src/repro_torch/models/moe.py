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
  call's shape.

Capacity ``c = max(32, round_up(k·g/E·capacity_factor, 32))`` with
``g = min(4096, B·S)`` counted over all lanes, masked ones included; tokens
over capacity are dropped.  ``token_valid`` zero-gates padding lanes, so they
never compete for capacity.  Tensor-parallel experts and the FP4 all-gather
(``fp4_allgather``) are multi-device work (ROADMAP A8).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import ModelConfig
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
                method: str) -> torch.Tensor:
    """xe [E, T', D] → [E, T', D]: every expert's SwiGLU, each of its three
    linears one stacked call; expert e's seeds are seed_fold(seed, 20) + e in
    uint32, as the reference's vmap carries them."""
    qc = cfg.quartet
    seeds = (L.seed_fold(seed, 20)
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


def _router_logits(w: torch.Tensor, x: torch.Tensor, seed: int, cfg: ModelConfig):
    """The router's bf16 dense on x [B, S, D] → f32 [B, S, E]; on the card one
    [B, 1] column at a time (module docstring)."""
    def route(xs):
        return L.dense({"w": w}, xs, seed, cfg.quartet, "bf16")

    if x.is_cuda and x.shape[1] > 1:
        logits = torch.cat([route(x[:, s:s + 1]) for s in range(x.shape[1])], dim=1)
    else:
        logits = route(x)
    return logits.to(torch.float32)


def _combine(ye: torch.Tensor, sel_idx: torch.Tensor, sel_gate: torch.Tensor, g: int,
             k: int) -> torch.Tensor:
    """The gated expert outputs ye [G, E, c, D] back to token order [G, g, D]:
    each token's summands (at most k carry a non-zero gate; the zero-gated
    ones add ±0 and change nothing) added in ascending expert order, each
    add rounded to ye's dtype, as the reference's scatter-add does on
    XLA:CPU."""
    G, E, c, D = ye.shape
    dev = ye.device
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
    order = torch.sort((~has).to(torch.uint8), dim=-1, stable=True).indices[..., :k]
    out = torch.zeros((G, g, D), dtype=ye.dtype, device=dev)
    g_idx = torch.arange(G, device=dev)[:, None]
    for j in range(min(k, E)):
        e_j = order[..., j]
        ok = has.gather(-1, e_j[..., None])[..., 0]
        c_j = torch.clamp(pos.gather(-1, e_j[..., None])[..., 0], min=0)
        val = ye[g_idx, e_j, c_j]
        out = out + torch.where(ok[..., None], val, torch.zeros_like(val))
    return out


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
    logits = _router_logits(params["router"]["w"], x, seed, cfg).reshape(G, g, E)
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
    xe = xg[torch.arange(G, device=x.device)[:, None, None], sel_idx]  # [G, E, c, D]
    xe = xe.transpose(0, 1).reshape(E, G * c, D)
    ye = _expert_ffn(xe, params, seed, cfg, method)
    ye = ye.reshape(E, G, c, D).transpose(0, 1)
    ye = ye * sel_gate[..., None].to(ye.dtype)

    # --- combine (bf16, fixed order) ---
    y = _combine(ye.to(x.dtype), sel_idx, sel_gate, g, k).reshape(B, S, D)
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
              token_valid: torch.Tensor | None = None) -> torch.Tensor:
    h, _ = attention(params["attn"], L.rmsnorm(params["attn_norm"], x, cfg.norm_eps),
                     positions, L.seed_fold(seed, 100), cfg, causal=cfg.is_causal_lm,
                     kv_cache=cache, cache_index=cache_index, method=method)
    x = x + h
    h, _ = moe_ffn(params["moe"], L.rmsnorm(params["mlp_norm"], x, cfg.norm_eps),
                   L.seed_fold(seed, 200), cfg, method, token_valid=token_valid)
    return x + h
