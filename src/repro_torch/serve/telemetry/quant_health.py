"""Quantization-health gauges sampled from the packed MXFP4 KV pool.

Port of ``repro.serve.telemetry.quant_health``.  Every KV write quantizes
through ``kernels.kv_pack``'s arithmetic, so the packed pool *is* the record
of what quantization did; this module reduces it, on the pool's own device,
into three health signals per K/V stream:

* **clip fraction** — share of E2M1 codes at the saturating magnitude
  (``kv_pack.E2M1_SAT_IDX``, |x| = 6.0): rising clip means the per-group
  AbsMax scales are being overwhelmed by outliers,
* **zero fraction** — share of codes at magnitude 0: rising dead codes mean
  the scale is too coarse for the tail (underflow),
* **E8M0 scale histogram** — 256-bin histogram of the biased scale codes
  the pool actually stores (one a row of 32, or one a row of a head-wide
  block such as zamba2-7b's 112): drift or widening of this distribution is
  the earliest sign the KV value range is moving.

Only mapped pages count (the ``[n_pages]`` page mask; scratch page 0 and
unmapped pages never do).  The reductions are plain torch ops, not kernels:
the reference computes them in plain ``jnp`` outside any Pallas call.  Every
count is an int64 sum (the histogram a ``bincount``), so the counts are
exact on any device; one host read fetches them, and the fractions are
formed from the counts in float32 on the host, as the reference divides its
counts in float32.  A sample reads the pool and writes nothing; the engine
takes one at ``TelemetryConfig.quant_stride`` ticks, and the default stride
0 takes none.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.kv_pack import E2M1_SAT_IDX

N_SCALE_BINS = 256  # E8M0 biased exponent codes


def page_mask_from_tables(tables: np.ndarray, n_pages: int) -> np.ndarray:
    """Host-side [n_pages] bool mask of pages currently mapped by any slot.
    Page id 0 is the scratch sentinel — never mapped, never counted."""
    mask = np.zeros((n_pages,), bool)
    ids = np.asarray(tables).reshape(-1)
    mask[ids[ids > 0]] = True
    return mask


def _code_counts(codes: torch.Tensor) -> torch.Tensor:
    """Packed bytes → int64 [clip, zero] counts over both nibbles."""
    hi, lo = (codes >> 4) & 7, codes & 7
    return torch.stack([(hi == E2M1_SAT_IDX).sum() + (lo == E2M1_SAT_IDX).sum(),
                        (hi == 0).sum() + (lo == 0).sum()])


def _frac(count: int, n: int) -> float:
    """count / max(n, 1) in float32, as the reference divides on its device."""
    return float(np.float32(count) / np.float32(max(n, 1)))


def _pages(mask: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.nonzero(np.asarray(mask))[0]).to(device)


def pool_health(pool: dict, page_mask: np.ndarray, group=None, shards: int = 1) -> dict:
    """Packed MXFP4 pool ([L, P, ps, H, hd/2] codes, [L, P, ps, H, nb] scale
    codes per stream) + mapped-page mask → per-stream health dict of Python
    numbers: ``{"k": {"clip_frac", "zero_frac", "scale_hist" (256 ints),
    "n_elems"}, "v": {...}, "mapped_pages"}``.  A pool sharded on its head
    axis over ``shards`` ranks sums its int64 counts over their ``group``
    first, so every rank reads the whole pool's health, exactly."""
    if "k_codes" not in pool:
        raise ValueError("pool_health needs a packed (mxfp4) pool")
    ids = _pages(page_mask, pool["k_codes"].device)
    parts = []
    for s in ("k", "v"):
        codes = pool[f"{s}_codes"].index_select(1, ids)
        scales = pool[f"{s}_scales"].index_select(1, ids)
        parts += [_code_counts(codes),
                  torch.bincount(scales.reshape(-1).long(), minlength=N_SCALE_BINS)]
    counts = torch.cat(parts)
    if group is not None:
        torch.distributed.all_reduce(counts, group=group)
    counts = counts.tolist()  # the one host read
    L, _, ps, H, half = pool["k_codes"].shape
    n = len(ids) * L * ps * H * shards * half * 2
    out: dict = {"mapped_pages": len(ids)}
    for i, s in enumerate(("k", "v")):
        base = i * (2 + N_SCALE_BINS)
        clip, zero = counts[base:base + 2]
        out[s] = {"clip_frac": _frac(clip, n), "zero_frac": _frac(zero, n),
                  "scale_hist": counts[base + 2:base + 2 + N_SCALE_BINS], "n_elems": n}
    return out


def sample_pool_health(cache) -> dict | None:
    """Reduce a :class:`~repro_torch.serve.paged_cache.PagedCache` — ``None``
    when the pool is dense (nothing to measure) or no page is mapped (no
    live KV)."""
    if cache.kv_dtype != "mxfp4":
        return None
    mask = cache.page_mask()
    if not mask.any():
        return None
    return pool_health(cache.pool, mask, cache.shard_group,
                       cache.kv_heads // cache.local_heads)


def ring_health(pool: dict, page_mask: np.ndarray) -> dict:
    """One packed state-ring plane ([P, E/2] codes + [P, E/32] scale codes)
    + live-page mask → clip/zero fractions.  The block-padding tail of each
    page quantizes exact zeros, so it rides in the zero fraction as a small
    constant floor (same pages every sample — trends are unaffected)."""
    if "codes" not in pool:
        raise ValueError("ring_health needs a packed (mxfp4) ring plane")
    ids = _pages(page_mask, pool["codes"].device)
    clip, zero = _code_counts(pool["codes"].index_select(0, ids)).tolist()
    n = len(ids) * pool["codes"].shape[1] * 2
    return {"clip_frac": _frac(clip, n), "zero_frac": _frac(zero, n), "n_elems": n}


def sample_state_health(pool) -> dict | None:
    """Reduce a :class:`~repro_torch.serve.state_pool.StatePool`, per tenant
    kind: ``"kv"``/``"cross"`` through the paged-plane reduction (each is a
    :class:`PagedCache`); ``"state"`` aggregates every ring plane's clip/zero
    fractions over the pages holding each live slot's current state,
    element-weighted across planes as the reference weights them.  ``None``
    when the pool is dense or nothing is live."""
    if pool.kv_dtype != "mxfp4":
        return None
    out = {}
    if pool.kv is not None and (h := sample_pool_health(pool.kv)) is not None:
        out["kv"] = h
    if pool.cross is not None and (h := sample_pool_health(pool.cross)) is not None:
        out["cross"] = h
    if pool.rings:
        mask = pool.ring_page_mask()
        if mask.any():
            clip = zero = n = 0
            for r in pool.rings:
                h = ring_health(r.pool, mask)
                n_r = h["n_elems"]
                clip += h["clip_frac"] * n_r
                zero += h["zero_frac"] * n_r
                n += n_r
            if n:
                out["state"] = {"clip_frac": clip / n, "zero_frac": zero / n, "n_elems": n}
    return out or None
