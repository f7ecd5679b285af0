"""Paged KV storage for the continuous-batching engine.

Port of ``repro.serve.paged_cache`` (the attention-KV pool).  A global pool
of fixed-size pages ``[L, n_pages, page_size, Hkv, ...]`` lives on the
device, with a host-side free-list allocator and per-slot page tables.  In
``kv_dtype="mxfp4"`` mode pages hold the real 4.25-bit payload (packed E2M1
nibbles + E8M0 scale bytes, written by ``kernels.paged_attention.
scatter_token`` on the paged backend and :func:`scatter_tokens` on the
gather backend, both through B4a); ``"dense"`` stores the model's compute
dtype.

Page id 0 is the scratch page: masked decode lanes and prefill padding
redirect their writes there.  Stale page contents are never zeroed — causal
attention masks every position past the querying token's, and a sequence
writes position ``p`` before any of its queries reach ``p``.

The pool tensors are updated in place by the serving steps (PyTorch tensors
are mutable; the reference threads a new pool through each jitted step).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantizers import PackedQuant
from repro_torch.kernels.kv_pack import (
    kv_dequant_unpack,
    kv_gather_dequant_kv,
    kv_quant_pack,
    kv_quant_scatter_kv,
)
from repro_torch.kernels.paged_attention import (  # noqa: F401  (re-exports)
    PagedKV,
    prefill_chunk_layout,
    quant_block,
)


def quantize_kv(x: torch.Tensor) -> PackedQuant:
    """[..., hd] values → packed MXFP4 payload (codes [..., hd/2] u8, scale
    codes [..., hd/block] u8), through B4a on a CUDA tensor."""
    hd = x.shape[-1]
    lead = x.shape[:-1]
    codes, scales = kv_quant_pack(x.reshape(-1, hd), quant_block(hd))
    return PackedQuant(codes.reshape(*lead, -1), scales.reshape(*lead, -1))


def dequantize_kv(codes: torch.Tensor, scales: torch.Tensor, dtype) -> torch.Tensor:
    """Packed payload → [..., hd] values in ``dtype``, through B4b on a CUDA
    tensor."""
    lead = codes.shape[:-1]
    out = kv_dequant_unpack(codes.reshape(-1, codes.shape[-1]),
                            scales.reshape(-1, scales.shape[-1]), dtype)
    return out.reshape(*lead, -1)


def gather_pages(pool: dict, tables: torch.Tensor, dtype: torch.dtype):
    """Pool pages → dense stacked KV ``(k, v)`` [L, B, P·ps, Hkv, hd]
    through tables int32 [B, P]: a packed pool dequantized into ``dtype``
    (B4b fused with the gather, one launch for K and V), a dense pool
    in its own dtype (the model's compute dtype), as in the reference.  The
    ``decode_backend="gather"`` steps attend over this view; the paged
    backend never builds it."""
    if "k" in pool:
        idx = tables.long()

        def one(leaf):
            g = leaf[:, idx]  # [L, B, P, ps, H, hd]
            return g.reshape(*g.shape[:2], -1, *g.shape[4:])

        return one(pool["k"]), one(pool["v"])
    return kv_gather_dequant_kv(pool["k_codes"], pool["k_scales"], pool["v_codes"],
                                pool["v_scales"], tables, dtype)


def scatter_tokens(pool: dict, page_ids: torch.Tensor, offsets: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Write one token per (page, offset) pair into every layer of the pool,
    in place.  page_ids/offsets [N]; k_new/v_new [L, N, Hkv, hd].
    Quantize-on-write in packed mode (B4a fused with the scatter, one
    launch for K and V, strided views read in place).  Duplicate pairs
    (masked lanes redirected to the scratch page) resolve arbitrarily;
    scratch contents are never read."""
    if "k" in pool:
        pid, off = page_ids.long(), offsets.long()
        pool["k"][:, pid, off] = k_new.to(pool["k"].dtype)
        pool["v"][:, pid, off] = v_new.to(pool["v"].dtype)
        return pool
    kv_quant_scatter_kv(pool["k_codes"], pool["k_scales"], pool["v_codes"], pool["v_scales"],
                        page_ids, offsets, k_new, v_new)
    return pool


def reservation_sizing(n_slots: int, max_len: int, page_size: int) -> tuple[int, int]:
    """``(pages_per_slot, n_pages)`` under the admission-reservation contract:
    a slot's table holds ``ceil(max_len / page_size)`` pages and the pool one
    full reservation per slot plus the scratch page, so a request admitted
    with ``prompt + max_new`` pages reserved never runs out mid-flight."""
    pages_per_slot = -(-max_len // page_size)
    return pages_per_slot, 1 + n_slots * pages_per_slot


class PagedCache:
    """Fixed-size KV pages + free-list allocator + per-slot page tables."""

    def __init__(self, cfg, *, n_slots: int, pages_per_slot: int, page_size: int,
                 n_pages: int, kv_dtype: str, device):
        if kv_dtype not in ("mxfp4", "dense"):
            raise ValueError(f"kv_dtype must be 'mxfp4' or 'dense', got {kv_dtype!r}")
        L, H, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
        if hd % 2 != 0:
            raise ValueError(f"head dim {hd} must be even for nibble packing")
        self.n_slots, self.page_size = n_slots, page_size
        self.pages_per_slot, self.n_pages = pages_per_slot, n_pages
        self.kv_dtype = kv_dtype
        self.layers, self.kv_heads, self.head_dim = L, H, hd
        if kv_dtype == "dense":
            shape = (L, n_pages, page_size, H, hd)
            dtype = getattr(torch, cfg.dtype)
            self.pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)}
        else:
            cshape = (L, n_pages, page_size, H, hd // 2)
            sshape = (L, n_pages, page_size, H, hd // quant_block(hd))
            self.pool = {name: torch.zeros(shape, dtype=torch.uint8, device=device)
                         for name, shape in (("k_codes", cshape), ("k_scales", sshape),
                                             ("v_codes", cshape), ("v_scales", sshape))}
        self._free = list(range(n_pages - 1, 0, -1))  # pop() hands out low ids first
        self.tables = np.zeros((n_slots, pages_per_slot), np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_alloc(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= min(len(self._free), self.pages_per_slot)

    def alloc(self, slot: int, n_tokens: int) -> None:
        """Map enough fresh pages onto ``slot`` to hold ``n_tokens`` positions."""
        n = self.pages_needed(n_tokens)
        if n > self.pages_per_slot:
            raise ValueError(f"{n_tokens} tokens need {n} pages > "
                             f"pages_per_slot={self.pages_per_slot}")
        if self.tables[slot].any():
            self.free(slot)
        if n > len(self._free):
            raise RuntimeError(f"out of pages: need {n}, free {len(self._free)}")
        for i in range(n):
            self.tables[slot, i] = self._free.pop()

    def free(self, slot: int) -> None:
        self._free.extend(int(p) for p in self.tables[slot] if p != 0)
        # keep the free list descending so allocation stays low-ids-first
        # under any retirement order
        self._free.sort(reverse=True)
        self.tables[slot] = 0

    def check_invariants(self) -> None:
        """Page conservation: every non-scratch page is either free or mapped
        by exactly one slot, and the free list is sorted descending."""
        mapped = self.tables[self.tables != 0].tolist()
        if len(set(mapped)) != len(mapped):
            raise AssertionError("a page is mapped by two slots")
        if set(mapped) & set(self._free):
            raise AssertionError("a mapped page is on the free list")
        if len(mapped) + len(self._free) != self.n_pages - 1:
            raise AssertionError("page conservation violated")
        if self._free != sorted(self._free, reverse=True):
            raise AssertionError("free list not sorted descending")

    def cache_bytes(self) -> int:
        """Persistent KV bytes held by the pool."""
        return sum(t.numel() * t.element_size() for t in self.pool.values())
