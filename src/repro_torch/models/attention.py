"""GQA attention: blocked, flash, dense-cache and paged paths.

Port of ``repro.models.attention``.  A forward
without a cache (training, teacher-forced scoring) runs
:func:`blocked_attention`, plain PyTorch that autograd differentiates, or,
on a model built with ``attn_backend="flash"``, the forward-only flash
kernel (evaluation).  A forward whose cache is a dense ``(k, v)`` pair
[B, T, Hkv, hd] writes the S new entries at each slot's ``cache_index`` (in
place) and attends over the whole cache with blocked attention (the
gather serving backend).  A forward whose cache is a
:class:`~repro_torch.kernels.paged_attention.PagedKV` quantize-scatters the
new tokens' K/V into the pool and attends over it with the paged-attention
kernel (:func:`_paged_decode`).  Cross attention (the enc-dec and VLM
families) takes its keys and values from a source (``kv_source``) or from
a precomputed ``(k, v)`` cache, with unrotated keys and no causal mask.

Tensor-parallel serving (``cfg.tp_axis``, set by the serving steps): a pool
or dense cache whose head count is not ``num_kv_heads`` holds this rank's
block of KV heads.  The rank then writes its block of the new K/V, attends
over its heads (the paged kernel over its query groups; blocked attention
at the model's head count, :func:`_tp_dense_attend`), and all-gathers the
outputs on the head axis (``distributed.context.all_gather_tiled``) before
the output projection, which every rank computes whole.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import all_gather_tiled, tp_rank
from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.kernels.paged_attention import PagedKV, paged_attention, scatter_token
from repro_torch.models import layers as L

NEG_INF = -1e30
# the widest key chunk of blocked attention: a 512-token training sequence
# takes one chunk, and a shorter call is padded to at most this width
KV_CHUNK_MAX = 512


def init_attention(cfg: ModelConfig, dtype, generator, device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    args = (dtype, generator, device, cfg.use_bias)
    p = {
        "wq": L.init_dense(d, nq * hd, *args),
        "wk": L.init_dense(d, nkv * hd, *args),
        "wv": L.init_dense(d, nkv * hd, *args),
        "wo": L.init_dense(nq * hd, d, *args),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.init_rmsnorm(hd, dtype, device)
        p["k_norm"] = L.init_rmsnorm(hd, dtype, device)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_positions: torch.Tensor, causal: bool,
                      kv_chunk: int) -> torch.Tensor:
    """Online-softmax GQA attention over KV chunks (f32 state).

    q [B, S, Hq, hd], k/v [B, T, Hkv, hd], q_positions [B, S] absolute
    positions (per row); key t sits at position t.

    Every chunk is ``min(kv_chunk, KV_CHUNK_MAX)`` keys wide whatever T is:
    the last one is padded with masked zero keys.  So a query row's products
    and sums run at one shape for any T, and keys past the ones it sees
    (masked, or padding) add exact zeros: a serving step's row over a slot's
    whole cache view computes what the teacher-forced forward computes over
    the prompt's keys."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    ck = min(kv_chunk, KV_CHUNK_MAX)
    qf = (q.to(torch.float32) * scale).reshape(B, S, Hkv, group, hd)
    m = torch.full((B, S, Hkv, group), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, S, Hkv, group, hd), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, ck):
        kj = k[:, t0:t0 + ck].to(torch.float32)
        vj = v[:, t0:t0 + ck].to(torch.float32)
        pad = ck - kj.shape[1]
        if pad:
            kj, vj = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (kj, vj))
        s = torch.einsum("bskgd,bckd->bskgc", qf, kj)
        if causal or pad:
            kv_pos = torch.arange(t0, t0 + ck, device=q.device)
            mask = q_positions[:, :, None, None, None] >= kv_pos if causal else None
            if pad:
                mask = kv_pos < T if mask is None else mask & (kv_pos < T)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgc,bckd->bskgd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def dispatch_attention(q, k, v, q_positions, *, causal: bool, cfg: ModelConfig) -> torch.Tensor:
    """Cache-free attention call site.  ``"flash"`` applies to
    self-attention with S == T, where query row i sits at position i (every
    cache-free forward); other shapes run blocked attention.  ``"paged"``
    concerns attention over the pool only, so here it runs ``"blocked"``."""
    if cfg.attn_backend not in ("blocked", "paged", "flash"):
        raise NotImplementedError(f"attention backend {cfg.attn_backend!r} is not ported yet")
    if cfg.attn_backend == "flash" and q.shape[1] == k.shape[1]:
        return mha_flash(q, k, v, causal=causal)
    return blocked_attention(q, k, v, q_positions, causal=causal, kv_chunk=cfg.attn_kv_chunk)


def _dense_cache_attend(q, k, v, positions, cache, cache_index, *, causal: bool,
                        cfg: ModelConfig) -> torch.Tensor:
    """Write the S new entries of every slot at ``cache_index[b]`` of the
    dense cache ``(k, v)`` [B, T, Hkv, hd] (in place; the start is clamped
    to T − S, as a dynamic update slice clamps it), then attend over the
    whole cache.  The causal mask on the query positions hides every entry
    past a query, stale ones included."""
    ck, cv = cache
    sharded = _tp_sharded(cfg, ck.shape[2])
    if sharded:  # a head-sliced cache (the gather backend under tensor parallelism)
        _, k, v = _tp_slice_heads(q, k, v, cfg, ck.shape[2])
    B, S = q.shape[:2]
    T = ck.shape[1]
    start = torch.clamp(cache_index.to(torch.int64), 0, T - S)
    idx = start[:, None] + torch.arange(S, device=q.device)[None, :]
    bidx = torch.arange(B, device=q.device)[:, None]
    ck[bidx, idx] = k.to(ck.dtype)
    cv[bidx, idx] = v.to(cv.dtype)
    if sharded:
        return _tp_dense_attend(q, ck, cv, positions, causal, cfg)
    return blocked_attention(q, ck, cv, positions, causal=causal, kv_chunk=cfg.attn_kv_chunk)


def _tp_sharded(cfg: ModelConfig, local_kv_heads: int) -> bool:
    """A KV cache operand announces a tensor-parallel head slice by its head
    count (the reference's shape-based detection): a replicated pool leaf
    keeps the model's count and is attended whole."""
    return cfg.tp_axis is not None and local_kv_heads != cfg.num_kv_heads


def _tp_slice_heads(q, k, v, cfg: ModelConfig, local_kv_heads: int):
    """This rank's contiguous block of ``local_kv_heads`` KV heads of the
    freshly projected k/v, and its GQA query groups (q is kv-head-major:
    head h of group g sits at ``g * group + h``).  Only a slice; the tiled
    all-gather of the attention output is a concatenation."""
    r = tp_rank(cfg.tp_axis)
    group = cfg.num_heads // cfg.num_kv_heads
    kv = slice(r * local_kv_heads, (r + 1) * local_kv_heads)
    qs = slice(r * local_kv_heads * group, (r + 1) * local_kv_heads * group)
    return q[:, :, qs], k[:, :, kv], v[:, :, kv]


def _tp_dense_attend(q, k, v, positions, causal: bool, cfg: ModelConfig) -> torch.Tensor:
    """Attention of this rank's block of KV heads ``k``/``v`` [B, T, Hkv/tp,
    hd] from a dense cache, all-gathered on the head axis.  The rank attends
    at the model's head count, its heads in place and zeros in the others',
    and keeps its block of the output: on the card a batched GEMM picks its
    kernel, and so its bits, by the batch count (B·Hkv here), so a call over
    fewer heads rounds a head otherwise than one device does (the paged
    kernel's heads are independent, and it takes the slice itself)."""
    r, local = tp_rank(cfg.tp_axis), k.shape[2]
    group = cfg.num_heads // cfg.num_kv_heads
    blk = slice(r * local, (r + 1) * local)
    kp = k.new_zeros((*k.shape[:2], cfg.num_kv_heads, k.shape[3]))
    vp = torch.zeros_like(kp)
    kp[:, :, blk], vp[:, :, blk] = k, v
    out = dispatch_attention(q, kp, vp, positions, causal=causal, cfg=cfg)
    return all_gather_tiled(out[:, :, r * local * group:(r + 1) * local * group], 2,
                            cfg.tp_axis)


def _paged_decode(params: dict, x: torch.Tensor, q: torch.Tensor, positions: torch.Tensor,
                  seed: int, cfg: ModelConfig, paged: PagedKV, method: str, rope):
    """Decode / batched prefill directly over the pool: quantize-scatter the
    S new tokens' K/V (``positions[b, s]`` picks page and offset), then run
    the paged-attention kernel with per-row causal bounds.  Padding tokens
    are positioned on a scratch page by the caller, so no mask is needed.
    A head-sliced pool (tensor parallelism) takes this rank's heads and
    all-gathers the outputs on the head axis."""
    hd, nkv = cfg.head_dim_, cfg.num_kv_heads
    qc = cfg.quartet
    k = _split_heads(L.dense(params["wk"], x, L.seed_fold(seed, 2), qc, method), nkv, hd)
    v = _split_heads(L.dense(params["wv"], x, L.seed_fold(seed, 3), qc, method), nkv, hd)
    if cfg.qk_norm:
        k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if rope is not None:
        k = L.apply_rope(k, *rope)
    kleaf = next(iter(paged.pool.values()))
    ps = kleaf.shape[1]
    sharded = _tp_sharded(cfg, kleaf.shape[2])
    if sharded:
        q, k, v = _tp_slice_heads(q, k, v, cfg, kleaf.shape[2])
    B = x.shape[0]
    bidx = torch.arange(B, device=x.device)[:, None]
    page_ids = paged.tables[bidx, (positions // ps).long()]
    scatter_token(paged.pool, page_ids, positions % ps, k, v)
    lengths = (positions[:, 0] + 1).to(torch.int32)
    out = paged_attention(q.contiguous(), paged.pool, paged.tables, lengths)
    return all_gather_tiled(out, 2, cfg.tp_axis) if sharded else out


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor, seed: int,
              cfg: ModelConfig, *, causal: bool = True,
              kv_source: torch.Tensor | None = None,
              kv_cache: PagedKV | tuple | None = None,
              cache_index: torch.Tensor | None = None, write_kv: bool = False,
              method: str = "quartet", rope=None):
    """x [B, S, D], positions [B, S] → (out [B, S, D], kv_cache).  A
    ``PagedKV`` pool, or a dense ``(k, v)`` cache written at
    ``cache_index`` [B], is updated in place.  ``rope`` is the forward's
    ``layers.rope_table`` of ``positions`` (built here when not given).

    Cross attention: ``kv_source`` [B, T, D] gives the keys and values (no
    rope on them, nor on q, and no causal mask); with ``write_kv`` the full
    ``(k, v)`` built from it is returned, or written in place into a given
    ``kv_cache``.  A ``kv_cache`` with no ``cache_index`` and no
    ``write_kv`` is a precomputed ``(k, v)`` (a cached cross-KV), attended
    as it is.  As in the reference, q is rotated iff ``kv_source`` is None,
    so a cross attention that reads its cache rotates its queries."""
    hd, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    qc = cfg.quartet
    if cfg.pos_embed != "rope":
        rope = None
    elif rope is None:
        rope = L.rope_table(positions, hd, cfg.rope_theta)
    q = _split_heads(L.dense(params["wq"], x, L.seed_fold(seed, 1), qc, method), nq, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
    if rope is not None and kv_source is None:
        q = L.apply_rope(q, *rope)

    new_cache = kv_cache
    if isinstance(kv_cache, PagedKV):
        out = _paged_decode(params, x, q, positions, seed, cfg, kv_cache, method, rope)
    elif kv_cache is not None and cache_index is None and not write_kv:
        k, v = kv_cache  # a precomputed (k, v): the cached cross-KV
        causal = causal and kv_source is None
        if _tp_sharded(cfg, k.shape[2]):  # this rank's heads of the cross plane
            out = _tp_dense_attend(q, k, v, positions, causal, cfg)
        else:
            out = dispatch_attention(q, k, v, positions, causal=causal, cfg=cfg)
    else:
        src = x if kv_source is None else kv_source
        k = _split_heads(L.dense(params["wk"], src, L.seed_fold(seed, 2), qc, method), nkv, hd)
        v = _split_heads(L.dense(params["wv"], src, L.seed_fold(seed, 3), qc, method), nkv, hd)
        if cfg.qk_norm:
            k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
        if rope is not None and kv_source is None:
            k = L.apply_rope(k, *rope)
        causal = causal and kv_source is None
        if write_kv:  # the full cache built from the source (cross-attention prefill)
            if kv_cache is None:
                new_cache = (k, v)
            else:
                if _tp_sharded(cfg, kv_cache[0].shape[2]):  # a head-sliced cache
                    _, k_loc, v_loc = _tp_slice_heads(q, k, v, cfg, kv_cache[0].shape[2])
                else:
                    k_loc, v_loc = k, v
                kv_cache[0].copy_(k_loc)
                kv_cache[1].copy_(v_loc)
            out = dispatch_attention(q, k, v, positions, causal=causal, cfg=cfg)
        elif kv_cache is None:
            out = dispatch_attention(q, k, v, positions, causal=causal, cfg=cfg)
        else:
            out = _dense_cache_attend(q, k, v, positions, kv_cache, cache_index,
                                      causal=causal, cfg=cfg)
    out = out.reshape(*x.shape[:-1], nq * hd)
    return L.dense(params["wo"], out, L.seed_fold(seed, 4), qc, method), new_cache
