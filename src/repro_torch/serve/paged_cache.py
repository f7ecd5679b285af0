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

Pages are reference-counted: a page may be mapped by several slots (prefix
sharing) and pinned by the radix prefix index, and a slot copies a shared
page before it writes into it (:meth:`PagedCache.cow_range`).

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
from repro_torch.models.registry import cache_leaves, cache_map
from repro_torch.train.serve import init_cache


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


def copy_page(pool: dict, src: int, dst: int) -> None:
    """Copy physical page ``src``'s whole payload onto ``dst`` in every layer
    and leaf (packed codes and scales, or dense K/V), in place: the
    copy-on-write primitive."""
    for leaf in pool.values():
        leaf[:, dst] = leaf[:, src]


def reservation_sizing(n_slots: int, max_len: int, page_size: int,
                       spec_k: int = 0) -> tuple[int, int]:
    """``(pages_per_slot, n_pages)`` under the admission-reservation contract,
    the one sizing rule of the engine's cache and the draft proposer's
    mirror cache.  The table carries ``spec_k`` positions more than
    ``max_len``, so a speculative burst's positions past the budget index
    the table in bounds (those columns are never mapped, so their writes go
    to scratch page 0); the pool holds one full reservation of
    ``ceil(max_len / page_size)`` pages per slot plus the scratch page —
    mapped pages never exceed a request's reservation, so a request
    admitted with ``prompt + max_new`` pages never runs out mid-flight."""
    pages_per_slot = -(-(max_len + spec_k) // page_size)
    n_pages = 1 + n_slots * (-(-max_len // page_size))
    return pages_per_slot, n_pages


class PagedCache:
    """Fixed-size KV pages + free-list allocator + per-slot page tables.

    The pool's tensors live on the device and are written in place by the
    serving steps; the allocator (free list, tables, refcounts) is host
    numpy.  A page may be mapped by several slot tables (prefix sharing)
    and pinned by external holders (the radix prefix index): it returns to
    the free list only when its refcount reaches zero.  With ``debug`` the
    full :meth:`check_invariants` runs after every mutation."""

    def __init__(self, cfg, *, n_slots: int, pages_per_slot: int, page_size: int,
                 n_pages: int | None = None, kv_dtype: str = "mxfp4", device="cuda",
                 debug: bool = False, geometry: tuple[int, int, int] | None = None,
                 dtype: str | torch.dtype | None = None):
        """``geometry=(layers, kv_heads, head_dim)`` with ``dtype`` sizes the
        pool explicitly instead of from ``cfg`` (which may then be None): how
        :class:`~repro_torch.serve.state_pool.StatePool` carves the
        attention-KV plane out of a family whose cache tree is not one
        stacked (K, V) pair (the hybrid's ``"attn"`` stacks)."""
        if kv_dtype not in ("mxfp4", "dense"):
            raise ValueError(f"kv_dtype must be 'mxfp4' or 'dense', got {kv_dtype!r}")
        if geometry is None:
            L, H, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
            dtype = cfg.dtype
        else:
            L, H, hd = geometry
            if dtype is None:
                raise ValueError("an explicit geometry= needs an explicit dtype=")
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        if hd % 2 != 0:
            raise ValueError(f"head dim {hd} must be even for nibble packing")
        n_pages = n_pages if n_pages is not None else 1 + n_slots * pages_per_slot
        self.n_slots, self.page_size = n_slots, page_size
        self.pages_per_slot, self.n_pages = pages_per_slot, n_pages
        self.kv_dtype = kv_dtype
        self.layers, self.kv_heads, self.head_dim = L, H, hd
        if kv_dtype == "dense":
            shape = (L, n_pages, page_size, H, hd)
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
        self.refcounts = np.zeros((n_pages,), np.int32)
        self._external = np.zeros((n_pages,), np.int32)  # pins that are not table cells
        self.debug = debug

    # -- allocator ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_alloc(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= min(len(self._free), self.pages_per_slot)

    def _take_fresh(self) -> int:
        """Pop a page off the free list with refcount 1 (sole owner)."""
        pid = self._free.pop()
        if self.refcounts[pid] != 0:
            raise RuntimeError(f"free-list page {pid} has refcount {self.refcounts[pid]} != 0")
        self.refcounts[pid] = 1
        return pid

    def _decref(self, pid: int) -> bool:
        """Drop one reference; True if the page returned to the free list.
        Callers re-sort the free list after a batch of decrefs."""
        rc = int(self.refcounts[pid]) - 1
        if rc < 0:
            raise RuntimeError(f"refcount underflow on page {pid}")
        self.refcounts[pid] = rc
        if rc == 0:
            self._free.append(pid)
            return True
        return False

    def alloc(self, slot: int, n_tokens: int, shared=()) -> None:
        """Map enough pages onto ``slot`` to hold ``n_tokens`` positions.
        ``shared`` lists live page ids (a radix-index match) aliased at the
        front of the row, each gaining a reference; only the rest come off
        the free list.  A slot that still maps pages is freed first, so page
        conservation survives a re-alloc."""
        n = self.pages_needed(n_tokens)
        if n > self.pages_per_slot:
            raise ValueError(f"{n_tokens} tokens need {n} pages > "
                             f"pages_per_slot={self.pages_per_slot}")
        shared = [int(p) for p in shared]
        if len(shared) > n:
            raise ValueError(f"{len(shared)} shared pages > {n} pages needed")
        if self.tables[slot].any():
            self.free(slot)
        if n - len(shared) > len(self._free):
            raise RuntimeError(f"out of pages: need {n - len(shared)}, free {len(self._free)}")
        for i, pid in enumerate(shared):
            if pid == 0 or self.refcounts[pid] <= 0:
                raise ValueError(f"cannot alias dead/scratch page {pid}")
            self.tables[slot, i] = pid
            self.refcounts[pid] += 1
        for i in range(len(shared), n):
            self.tables[slot, i] = self._take_fresh()
        self._check()

    def free(self, slot: int) -> None:
        for pid in self.tables[slot]:
            if pid != 0:
                self._decref(int(pid))
        # keep the free list descending so allocation stays low-ids-first
        # under any retirement order
        self._free.sort(reverse=True)
        self.tables[slot] = 0
        self._check()

    def mapped_pages(self, slot: int) -> int:
        """Pages mapped onto ``slot`` (nonzero entries form a prefix)."""
        return int(np.count_nonzero(self.tables[slot]))

    def mapped_total(self) -> int:
        """Pages mapped across all slots; an aliased page counts per slot."""
        return int(np.count_nonzero(self.tables))

    def live_pages(self) -> int:
        """Physical pages with at least one reference.  Conservation:
        ``live_pages() + free_pages == n_pages - 1`` always."""
        return int((self.refcounts > 0).sum())

    def occupancy(self) -> float:
        """Live fraction of the allocatable pool (scratch page excluded), the
        telemetry ``pool_occupancy`` gauge.  Counts physical pages, so a
        prefix-shared page counts once however many slots alias it."""
        allocatable = self.n_pages - 1
        return self.live_pages() / allocatable if allocatable else 0.0

    def page_mask(self) -> np.ndarray:
        """[n_pages] bool: True where the page is live (referenced by a slot
        table or an external pin); the operand of the telemetry pool-health
        reduction.  The scratch page 0 is never referenced, never counted."""
        return self.refcounts > 0

    def ensure(self, slot: int, n_tokens: int) -> int:
        """Extend ``slot``'s mapping to cover ``n_tokens`` positions (no-op if
        covered); returns pages added.  The engine itself never maps past a
        request's admission reservation: speculative writes past the budget
        go to the scratch page instead."""
        need = self.pages_needed(n_tokens)
        if need > self.pages_per_slot:
            raise ValueError(f"{n_tokens} tokens need {need} pages > "
                             f"pages_per_slot={self.pages_per_slot}")
        have = self.mapped_pages(slot)
        if need <= have:
            return 0
        if need - have > len(self._free):
            raise RuntimeError(f"out of pages: need {need - have} more, free {len(self._free)}")
        for i in range(have, need):
            self.tables[slot, i] = self._take_fresh()
        self._check()
        return need - have

    def truncate(self, slot: int, n_tokens: int) -> int:
        """Shrink ``slot``'s mapping to ``n_tokens`` positions, unmapping the
        pages wholly past ``ceil(n_tokens / page_size)``; their contents stay
        (causal bounds make them unreachable, and a page is written before
        it is read again).  Returns the pages released."""
        keep = self.pages_needed(n_tokens)
        released = 0
        for i in range(keep, self.pages_per_slot):
            pid = int(self.tables[slot, i])
            if pid != 0:
                self._decref(pid)
                self.tables[slot, i] = 0
                released += 1
        if released:
            self._free.sort(reverse=True)
        self._check()
        return released

    # -- prefix sharing: external pins + copy-on-write ----------------------

    def ref_page(self, pid: int) -> None:
        """Take an external reference on a live page (the prefix index's pin)."""
        if pid == 0 or self.refcounts[pid] <= 0:
            raise ValueError(f"cannot pin dead/scratch page {pid}")
        self.refcounts[pid] += 1
        self._external[pid] += 1
        self._check()

    def unref_page(self, pid: int) -> bool:
        """Drop an external reference; True if the page returned to the free
        list (no slot maps it either)."""
        if self._external[pid] <= 0:
            raise ValueError(f"page {pid} has no external reference to drop")
        self._external[pid] -= 1
        freed = self._decref(pid)
        if freed:
            self._free.sort(reverse=True)
        self._check()
        return freed

    def cow_range(self, slot: int, start_tok: int, n_tokens: int) -> int:
        """Copy-on-write guard: before ``slot`` writes positions
        ``[start_tok, start_tok + n_tokens)``, each page in that range with
        another holder (refcount > 1) is copied into a fresh page mapped by
        this slot alone; the other holders keep the original.  Returns the
        pages copied."""
        if n_tokens <= 0:
            return 0
        first = start_tok // self.page_size
        last = (start_tok + n_tokens - 1) // self.page_size
        copied = 0
        for idx in range(first, min(last + 1, self.pages_per_slot)):
            pid = int(self.tables[slot, idx])
            if pid == 0 or self.refcounts[pid] <= 1:
                continue  # unmapped (scratch-redirected) or exclusively owned
            if not self._free:
                raise RuntimeError(f"out of pages for copy-on-write of page {pid}")
            new = self._take_fresh()
            copy_page(self.pool, pid, new)
            self.tables[slot, idx] = new
            self._decref(pid)  # refcount was > 1: never frees here
            copied += 1
        self._check()
        return copied

    # -- invariants ---------------------------------------------------------

    def _check(self) -> None:
        if self.debug:
            self.check_invariants()

    def check_invariants(self) -> None:
        """Free-list hygiene (in-range ids, no duplicates, sorted descending,
        every free page at refcount 0); refcount consistency (each page's
        count equals its table cells plus its external pins, the scratch
        page never referenced, no negative counts); page conservation (live
        + free == n_pages - 1)."""
        free = self._free
        if len(set(free)) != len(free):
            raise AssertionError("free list contains duplicate pages")
        if any(p <= 0 or p >= self.n_pages for p in free):
            raise AssertionError("free list contains out-of-range/scratch ids")
        if free != sorted(free, reverse=True):
            raise AssertionError("free list not sorted descending")
        rc = self.refcounts
        if int(rc[0]) != 0 or int(self._external[0]) != 0:
            raise AssertionError("scratch page 0 acquired a reference")
        if (rc < 0).any() or (self._external < 0).any():
            raise AssertionError("negative refcount")
        counts = np.bincount(self.tables.reshape(-1), minlength=self.n_pages)
        counts[0] = 0  # table zeros mean unmapped, not scratch references
        expect = counts[:self.n_pages] + self._external
        if not (rc == expect).all():
            bad = np.nonzero(rc != expect)[0][:8].tolist()
            raise AssertionError(f"refcount mismatch on pages {bad}: rc={rc[bad].tolist()} "
                                 f"!= tables+external={expect[bad].tolist()}")
        for p in free:
            if int(rc[p]) != 0:
                raise AssertionError(f"page {p} is free but has refcount {rc[p]}")
        live = int((rc > 0).sum())
        if live + len(free) != self.n_pages - 1:
            raise AssertionError(f"page conservation violated: live {live} + free "
                                 f"{len(free)} != {self.n_pages - 1}")

    # -- accounting ---------------------------------------------------------

    def cache_bytes(self) -> int:
        """Persistent KV bytes held by the pool."""
        return sum(t.numel() * t.element_size() for t in self.pool.values())


class DenseSlotCache:
    """Per-slot dense decode state for the families without paged attention
    KV (the state-pool engine's parity oracle, ``decode_backend=
    "dense_slots"``): the model's decode cache tree (``Model.cache_spec``)
    for ``n_slots`` slots, batch on axis 1 of every leaf."""

    def __init__(self, model, *, n_slots: int, max_len: int, device):
        self.n_slots, self.max_len = n_slots, max_len
        self.caches = init_cache(model, n_slots, max_len, device)

    def slot(self, slot: int):
        """One slot's caches as batch-1 views (a step writes through them)."""
        return cache_map(lambda c: c[:, slot:slot + 1], self.caches)

    def reset_slot(self, slot: int) -> None:
        """Zero one slot's state before a new request prefills into it (a
        recurrence has no positional mask to hide its predecessor's state)."""
        for c in cache_leaves(self.caches):
            c[:, slot].zero_()

    def merge_masked(self, new, mask: torch.Tensor) -> None:
        """Take ``new``'s state for the masked-in slots, keep the others':
        one batched decode step leaves the slots that are not decoding as
        they were."""
        for c, n in zip(cache_leaves(self.caches), cache_leaves(new)):
            keep = mask.reshape(1, -1, *([1] * (c.dim() - 2)))
            c.copy_(torch.where(keep, n.to(c.dtype), c))

    def cache_bytes(self) -> int:
        return sum(int(c.numel() * c.element_size()) for c in cache_leaves(self.caches))
