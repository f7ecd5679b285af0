"""GQA attention directly over the paged KV pool, plus the pool helpers.

Port of ``repro.kernels.paged_attention``.  The pool is a dict of leaves —
packed MXFP4 (``k_codes``/``v_codes`` u8 [n_pages, ps, Hkv, hd/2] +
``k_scales``/``v_scales`` u8 E8M0 codes [n_pages, ps, Hkv, hd/block]) or
dense (``k``/``v`` [n_pages, ps, Hkv, hd]) — addressed through int32 page
tables [B, P].  Page 0 is the scratch page that masked writes land on.

On a CUDA tensor :func:`paged_attention` launches
``csrc/paged_attention.cu`` (bf16 queries at hd 64 / 128: the flash-decoding
body on the tensor cores, each slot's pages split across CTAs as
:func:`split_plan` says; f32 queries: the FMA body); on a CPU tensor it runs
:func:`paged_attention_plain`.  Quantize-on-write (:func:`scatter_token`)
goes through ``kernels.kv_pack.kv_quant_scatter_kv`` (B4a fused with the
page scatter: one launch for K and V); the reference quantizes there with
``kv_quantize``, which computes the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._work import counted, nbytes
from repro_torch.kernels.kv_pack import kv_quant_scatter_kv, unpack_dequant

GROUP = 32
NEG_INF = -1e30


class PagedKV(NamedTuple):
    """Paged attention state: ``pool`` leaves (one layer's slice, or with a
    leading [L] axis) and ``tables`` int32 [B, P]."""

    pool: dict
    tables: torch.Tensor


def quant_block(hd: int) -> int:
    """MXFP4 scale block clamped to the head dim (blocks never straddle heads)."""
    return GROUP if hd % GROUP == 0 else hd


def scatter_token(pool: dict, page_ids: torch.Tensor, offsets: torch.Tensor,
                  k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Write tokens into one layer's pool slice, in place (the leaves are
    views into the engine's [L, ...] pool, so no copy of the pool is made).

    ``page_ids``/``offsets`` share a leading shape ``[...]``; ``k_new`` /
    ``v_new`` are ``[..., Hkv, hd]``.  Quantize-on-write in packed mode,
    fused with the scatter (one launch of B4a for K and V).  Duplicate
    (page, offset) pairs — masked lanes redirected to scratch page 0 —
    resolve arbitrarily; scratch contents are never read."""
    page_ids, offsets = page_ids.reshape(-1), offsets.reshape(-1)
    hkv, hd = k_new.shape[-2:]
    k_new = k_new.reshape(-1, hkv, hd)
    v_new = v_new.reshape(-1, hkv, hd)
    if "k" in pool:
        idx = (page_ids.long(), offsets.long())
        pool["k"].index_put_(idx, k_new.to(pool["k"].dtype))
        pool["v"].index_put_(idx, v_new.to(pool["v"].dtype))
        return pool
    kv_quant_scatter_kv(pool["k_codes"], pool["k_scales"], pool["v_codes"], pool["v_scales"],
                        page_ids, offsets, k_new, v_new)
    return pool


def prefill_chunk_layout(tables: torch.Tensor, start: torch.Tensor,
                         n_valid: torch.Tensor, chunk: int, page_size: int,
                         mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row write masking for a ragged batched-prefill chunk.

    Returns ``(tables_ext [B, P+1], positions [B, C])``: one all-zero
    sentinel column is appended to the tables; valid tokens sit at
    ``start + s``, padding tokens of active rows at ``P · page_size`` (the
    sentinel column, so their writes go to scratch page 0), inactive lanes
    at 0 of their zeroed row.  A valid token never sees a padding position,
    because every padding position is past it."""
    B, P = tables.shape
    tables_ext = torch.cat([tables, torch.zeros((B, 1), dtype=tables.dtype,
                                                device=tables.device)], dim=1)
    s = torch.arange(chunk, dtype=torch.int32, device=tables.device)[None, :]
    valid = mask[:, None] & (s < n_valid[:, None])
    start_safe = torch.where(mask, start, torch.zeros_like(start)).to(torch.int32)
    sentinel = torch.full_like(s, P * page_size)
    positions = torch.where(valid, start_safe[:, None] + s,
                            torch.where(mask[:, None], sentinel, torch.zeros_like(s)))
    return tables_ext, positions.to(torch.int32)


def _gather_kv(pool: dict, tables: torch.Tensor):
    """Dense f32 K, V [B, P·ps, Hkv, hd] through the page tables."""
    idx = tables.long()
    if "k" in pool:
        k, v = pool["k"][idx].to(torch.float32), pool["v"][idx].to(torch.float32)
    else:
        block = quant_block(pool["k_codes"].shape[-1] * 2)
        k = unpack_dequant(pool["k_codes"][idx], pool["k_scales"][idx], block)
        v = unpack_dequant(pool["v_codes"][idx], pool["v_scales"][idx], block)
    B, P, ps = k.shape[:3]
    return k.reshape(B, P * ps, *k.shape[3:]), v.reshape(B, P * ps, *v.shape[3:])


def paged_attention_plain(q: torch.Tensor, pool: dict, tables: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather every table page,
    mask each row r past ``lengths[b] − 1 + r // group``, softmax in f32."""
    multi = q.dim() == 4
    q4 = q if multi else q[:, None]
    B, S, Hq, hd = q4.shape
    k, v = _gather_kv(pool, tables)
    T, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    qf = (q4.to(torch.float32) * scale).reshape(B, S, Hkv, group, hd)
    s = torch.einsum("bskgd,btkd->bskgt", qf, k)
    q_pos = lengths.to(torch.int64)[:, None] - 1 + torch.arange(S, device=q.device)[None, :]
    kv_pos = torch.arange(T, device=q.device)
    visible = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, :, None, None, :]
    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    out = torch.einsum("bskgt,btkd->bskgd", p, v)
    out = out / torch.clamp(torch.sum(p, dim=-1), min=1e-30)[..., None]
    out = out.reshape(B, S, Hq, hd).to(q.dtype)
    return out if multi else out[:, 0]


CHUNK_KEYS = 64  # keys per sub-block of the tensor-core body
KEY_PARTS = 4  # 16-key parts of a sub-block, one a warp
MAX_CHUNKS = 32  # chunks per (slot, head, row group) at most
MAX_TILES = 2  # 16-row query tiles a CTA walks at most (tools/b5_tiles_probe.py)


class SplitPlan(NamedTuple):
    """How the tensor-core body cuts one call: each (slot, KV head) has
    ``n_tiles`` query tiles of 16 rows and ``n_chunks`` chunks of ``blocks``
    sub-blocks of 64 keys; a CTA of 4 warps takes one chunk and ``tiles``
    query tiles one after another, warp w keys [16w, 16w + 16) of each
    sub-block with an online softmax; the four warps' partials of a row
    merge in the CTA, so a row has ``n_chunks`` partials to merge."""

    tiles: int
    blocks: int
    n_tiles: int
    n_chunks: int


def split_plan(S: int, Hq: int, Hkv: int, ps: int, n_pp: int) -> SplitPlan:
    """The tensor-core body's split for R = S·group query rows per (slot,
    head) over a table of ``n_pp`` pages of ``ps``.  A row's arithmetic
    (which keys each partial sums, in which order, and the partials' merge
    order) depends on the table width alone, never on the call's row count:
    a query row gets the same bits in a decode (R = group), a speculative
    verify (R = (k + 1)·group) and a prefill chunk (R = C·group), so a verify
    row equals its decode row and a cache written through one step shape
    equals one written through another (``tools/draft_sync_probe.py``).
    Wider tables take more sub-blocks a CTA, so that there are never more
    than ``MAX_CHUNKS`` chunks and the merge's table of partials fits the
    CTA's shared memory at any table width.  With one sub-block a chunk a
    CTA takes up to ``MAX_TILES`` tiles, which share its K/V loads; with
    more it takes one (each tile would load them again).  Sized from the
    table width, never from the lengths, so planning never reads the
    device."""
    R = S * (Hq // Hkv)
    keys = n_pp * ps
    blocks = max(1, -(-keys // (MAX_CHUNKS * CHUNK_KEYS)))
    n_chunks = -(-keys // (blocks * CHUNK_KEYS))
    n_tiles = -(-R // 16)
    tiles = min(MAX_TILES, n_tiles) if blocks == 1 else 1
    return SplitPlan(tiles, blocks, n_tiles, n_chunks)


_tickets: dict[int, torch.Tensor] = {}


def _ticket_buffer(dev: torch.device, n: int) -> torch.Tensor:
    """The combine's int32 counters on ``dev``: zeroed once, left zero by
    every launch (the last CTA of each group resets its own), so reused
    without a memset; replaced by a larger zeroed buffer when a call needs
    more.  Calls on one stream only: two streams would share counters."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _tickets.get(idx)
    if buf is None or buf.numel() < n:
        buf = _tickets[idx] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return buf


def _mma_ok(q: torch.Tensor, leaves: list, packed: bool, hd: int, ps: int) -> bool:
    """Whether the call takes the tensor-core body: bf16 queries, hd 64 or
    128, a page size dividing 64 and 16-byte aligned operands (every call of
    the engine with bf16 activations)."""
    if q.dtype != torch.bfloat16 or hd not in (64, 128) or CHUNK_KEYS % ps:
        return False
    if q.data_ptr() % 16:
        return False
    if packed:
        return (leaves[0].data_ptr() % 16 == 0 and leaves[2].data_ptr() % 16 == 0
                and leaves[1].data_ptr() % (hd // GROUP) == 0
                and leaves[3].data_ptr() % (hd // GROUP) == 0)
    return all(t.data_ptr() % 16 == 0 for t in leaves)


@functools.cache
def _entry():
    fn = _build.load("paged_attention").paged_attention
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _cost(q: torch.Tensor, pool: dict, tables: torch.Tensor, lengths: torch.Tensor):
    """This call's data, as ``chip_smoke.attention_bytes_ops`` counts it:
    q read and the output written once; a slot's lengths[b] + S − 1 visible
    positions of K and V read once, with their table entries; 4·Hq·hd
    operations a visible (row, position) pair.  Reads ``lengths`` (a host
    sync: counting is for the first call of a step's shape only)."""
    B, S, Hq, hd = q.shape if q.dim() == 4 else (q.shape[0], 1, *q.shape[1:])
    packed = "k_codes" in pool
    leaves = ([pool["k_codes"], pool["k_scales"]] if packed else [pool["k"]])
    ps, Hkv = leaves[0].shape[1:3]
    kv_tok = sum(t[0, 0].numel() * t.element_size() for t in leaves)  # one position, K
    ops, total = 0, 2 * nbytes(q)
    for n in lengths.tolist():
        seen = max(n + S - 1, 0)
        total += 2 * kv_tok * seen + 4 * -(-seen // ps)
        ops += sum(4 * Hq * hd * (n + s) for s in range(S) if n + s > 0)
    return ops, total


@counted(_cost)
def paged_attention(q: torch.Tensor, pool: dict, tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode / multi-query attention over one layer's pool slice.

    ``q`` [B, Hq, hd] (one query per slot) or [B, S, Hq, hd] (S tokens per
    slot with per-row causal bounds); ``tables`` int32 [B, P]; ``lengths``
    int32 [B], tokens visible to the first query.  Returns q's shape and
    dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernel; anything else raises."""
    dev = q.device
    if dev.type == "cpu":
        return paged_attention_plain(q, pool, tables, lengths)
    if dev.type != "cuda":
        raise RuntimeError(f"paged_attention: unsupported device {dev}")
    multi = q.dim() == 4
    q4 = q if multi else q[:, None]
    B, S, Hq, hd = q4.shape
    packed = "k_codes" in pool
    leaves = ([pool["k_codes"], pool["k_scales"], pool["v_codes"], pool["v_scales"]]
              if packed else [pool["k"], pool["v"]])
    n_pages, ps, Hkv = leaves[0].shape[:3]
    ok = (q.dtype in (torch.float32, torch.bfloat16) and q4.is_contiguous()
          and hd % GROUP == 0 and hd <= 128 and 1 <= ps <= 32
          and Hkv > 0 and Hq % Hkv == 0
          and tables.dtype == lengths.dtype == torch.int32
          and tables.is_contiguous() and lengths.is_contiguous()
          and tables.shape[0] == B and lengths.shape == (B,)
          and all(t.device == dev and t.is_contiguous() for t in leaves)
          and all(t.device == dev for t in (tables, lengths)))
    if packed:
        ok = ok and all(t.dtype == torch.uint8 for t in leaves) \
            and leaves[0].shape == (n_pages, ps, Hkv, hd // 2) \
            and leaves[1].shape == (n_pages, ps, Hkv, hd // GROUP)
    else:
        ok = ok and all(t.dtype == q.dtype and t.shape == (n_pages, ps, Hkv, hd)
                        for t in leaves)
    if not ok:
        raise ValueError(
            f"paged_attention: unsupported operands q {tuple(q.shape)} {q.dtype}, pool "
            f"{ {k: (tuple(t.shape), t.dtype) for k, t in pool.items()} }, tables "
            f"{tuple(tables.shape)} {tables.dtype}, lengths {tuple(lengths.shape)}")
    out = torch.empty_like(q4)
    kc, ks, vc, vs = (t.data_ptr() for t in leaves) if packed else (None,) * 4
    kd, vd = (None, None) if packed else (leaves[0].data_ptr(), leaves[1].data_ptr())
    n_pp = tables.shape[1]
    part = tickets = None
    tiles = blocks = 0
    if _mma_ok(q4, leaves, packed, hd, ps):
        plan = split_plan(S, Hq, Hkv, ps, n_pp)
        tiles, blocks = plan.tiles, plan.blocks
        n_rows = B * Hkv * S * (Hq // Hkv) * plan.n_chunks
        part = torch.empty(n_rows * (hd + 2), dtype=torch.float32, device=dev)
        tickets = _ticket_buffer(dev, B * Hkv * -(-plan.n_tiles // tiles))
    status = _entry()(q4.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
                      int(packed), kc, ks, vc, vs, kd, vd, tables.data_ptr(),
                      lengths.data_ptr(), B, S, Hq, Hkv, hd, ps, n_pp,
                      float(np.float32(1.0 / np.sqrt(hd))),
                      None if part is None else part.data_ptr(),
                      None if tickets is None else tickets.data_ptr(), tiles, blocks,
                      torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "paged_attention")
    paged_attention.launches += 1
    return out if multi else out[:, 0]


paged_attention.launches = 0
