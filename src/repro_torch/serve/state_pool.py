"""One packed pool for the per-slot decode state of the non-paged families.

Port of ``repro.serve.state_pool``.  An SSM's
recurrent state and conv buffer have no positional axis to page over, so
each flattened cache leaf gets a :class:`RingPlane`: one page holds a slot's
whole leaf state (every layer), and each slot owns a depth-2 ring of pages
it alternates between (read page ``r``, write page ``w``, swapped after a
step).  Page 0 is the shared zero sentinel and scratch: a fresh slot reads
id 0 (the gather substitutes exact zeros, the dense oracle's
``reset_slot``), and masked lanes write id 0, which is never read.  The
double buffer makes one batched step safe: a lane's update lands in its
write page while every other lane's read page stays as it was.

Packed state (``kv_dtype="mxfp4"``) is quantize-on-write MXFP4: per
32-element block AbsMax → E8M0-nearest scale → E2M1 round to nearest, the
KV pool's payload (4.25 bits an element).  On the card the rings are
written by B4a (``kernels.kv_pack.kv_quant_pack``) and read by B4b
(``kv_dequant_unpack``) through their 2-d entries: a ring's ``[B,
padded]`` state viewed as rows of whole blocks (:func:`ring_rows`); the
blocks are independent, so the bits do not depend on the view.  The CPU
takes their plain versions, which equal ``core.quantizers.state_quantize``
and ``state_dequantize``.  Packed state is not idempotent under
re-quantization (``quantize(dequantize(x)) != x`` for values between grid
points), which is why masked lanes write the sentinel instead of writing
back what they read.

The hybrid family's attention KV (the ``"attn"`` stacks of its cache
tree, one per application of its shared block) lives in the attention-KV
plane: a :class:`~repro_torch.serve.paged_cache.PagedCache` built with an
explicit geometry ``(n_super, Hkv, hd)``, the same pages, free list and
tables as the dense engine's pool; the gather of its pages is B4b and the
write of a step's tokens B4a (K and V in one launch each), with the whole
head as one scale block at zamba2-7b's head dim of 112.  The enc-dec and
VLM families' self-attention KV (their ``"self"`` stacks) lives in the same
kind of plane.

Their cross-attention KV is static once encoded: a second ``PagedCache``,
the cross-KV plane, holds it, written once per source at admission (the
family's ``encode_cross_kv``, its every token quantize-scattered in one B4a
launch) and only read afterwards (B4b, sliced to the source's length:
cross attention is not causal, so a page's tail would be attended).
Pages are refcounted, so requests whose conditioning is byte-identical
alias one set of cross pages: :class:`CrossIndex` is the prefix index's
counterpart for conditioning tensors (an exact match on their bytes,
:func:`cross_key`; eviction drops the pin, and the pages free once no slot
maps them).  The pool tensors are updated in place.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.kv_pack import kv_dequant_unpack, kv_quant_pack
from repro_torch.models.registry import Model, cache_leaves
from repro_torch.serve.paged_cache import PagedCache

STATE_FAMILIES = ("ssm", "hybrid", "encdec", "vlm")
RING_DEPTH = 2  # read page + write page per slot
BLOCK = 32  # MXFP4's block, the KV pool's payload
MAX_ROW = 4096  # elements a row of the 2-d kernel view holds at most


def ring_rows(padded: int) -> int:
    """Elements a row of a ring page's 2-d view: the largest power of two up
    to ``MAX_ROW`` that divides the padded extent (at least one block)."""
    return math.gcd(padded, MAX_ROW)


class RingPlane:
    """Whole-state pages for one cache leaf ([L, B, *rest]).

    Slot ``s`` owns pages ``1 + s·RING_DEPTH ..`` (static, no allocator);
    the host ring cursor of :class:`StatePool`, shared by every plane,
    decides which page a step reads and which it writes."""

    def __init__(self, leaf_shape: tuple[int, ...], dtype: torch.dtype, n_slots: int,
                 kv_dtype: str, device):
        # leaf_shape is the per-slot state shape [L, *rest] (batch removed)
        self.leaf_shape = tuple(int(d) for d in leaf_shape)
        self.dtype = dtype
        self.elems = int(np.prod(self.leaf_shape))
        self.padded = -(-self.elems // BLOCK) * BLOCK
        self.row = ring_rows(self.padded)
        self.n_pages = 1 + n_slots * RING_DEPTH
        if kv_dtype == "dense":
            self.pool = {"raw": torch.zeros((self.n_pages, self.padded), dtype=dtype,
                                            device=device)}
        else:
            self.pool = {
                "codes": torch.zeros((self.n_pages, self.padded // 2), dtype=torch.uint8,
                                     device=device),
                "scales": torch.zeros((self.n_pages, self.padded // BLOCK), dtype=torch.uint8,
                                      device=device),
            }

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B] int page ids → leaf values [L, B, *rest] in the leaf's
        dtype; id 0 reads exact zeros (fresh state), whatever page 0 holds."""
        B = ids.shape[0]
        idx = ids.long()
        if "raw" in self.pool:
            flat = self.pool["raw"][idx]
        else:
            rows = self.padded // self.row
            codes = self.pool["codes"][idx].reshape(B * rows, self.row // 2)
            scales = self.pool["scales"][idx].reshape(B * rows, self.row // BLOCK)
            flat = kv_dequant_unpack(codes, scales, self.dtype).reshape(B, self.padded)
        flat = torch.where(idx[:, None] != 0, flat, torch.zeros_like(flat))
        return flat[:, :self.elems].reshape(B, *self.leaf_shape).movedim(0, 1)

    def scatter(self, ids: torch.Tensor, leaf: torch.Tensor) -> None:
        """Write each lane's whole new state ([L, B, *rest]) into its page,
        quantized on write in packed mode.  Masked lanes carry id 0: their
        writes collide on the sentinel, which is never read."""
        B = ids.shape[0]
        idx = ids.long()
        flat = leaf.movedim(1, 0).reshape(B, self.elems)
        if self.padded > self.elems:
            flat = torch.nn.functional.pad(flat, (0, self.padded - self.elems))
        if "raw" in self.pool:
            self.pool["raw"][idx] = flat.to(self.dtype)
            return
        codes, scales = kv_quant_pack(flat.reshape(-1, self.row))
        self.pool["codes"][idx] = codes.reshape(B, self.padded // 2)
        self.pool["scales"][idx] = scales.reshape(B, self.padded // BLOCK)

    def page_bytes(self) -> int:
        """Bytes one page (one slot's state) takes in this plane."""
        return self.cache_bytes() // self.n_pages

    def dense_bytes(self) -> int:
        """Bytes the same state takes in the dense-slot oracle."""
        return self.elems * torch.empty((), dtype=self.dtype).element_size()

    def cache_bytes(self) -> int:
        return sum(int(a.numel() * a.element_size()) for a in self.pool.values())


_RAW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _raw_bytes(val) -> tuple[tuple[int, ...], bytes]:
    """(shape, raw bytes) of a tensor on any device, or of an array: a
    tensor's bits are reinterpreted as integers on the host (a bf16 tensor
    has no numpy dtype), so the bytes do not depend on the device."""
    if isinstance(val, torch.Tensor):
        t = val.detach().contiguous()
        t = t.view(_RAW[t.element_size()]) if t.dtype.is_floating_point else t
        return tuple(t.shape), t.cpu().numpy().tobytes()
    arr = np.ascontiguousarray(np.asarray(val))
    return arr.shape, arr.tobytes()


def cross_key(extra: Any) -> str | None:
    """Content key of a request's conditioning tensors (source or image
    embeddings): requests with byte-identical embeddings share one encoded
    set of cross-KV pages.  None when the request carries none."""
    if not extra:
        return None
    h = hashlib.sha1()
    found = False
    for name in sorted(extra):
        if extra[name] is None:
            continue
        shape, raw = _raw_bytes(extra[name])
        h.update(name.encode())
        h.update(str(shape).encode())
        h.update(raw)
        found = True
    return h.hexdigest() if found else None


class CrossIndex:
    """Encoded cross-KV page sets pinned under their content key.

    The cross plane's counterpart of the radix prefix index: an entry holds
    one external reference a page (``PagedCache.ref_page``), so the pages
    outlive the slot that encoded them; a warm admission aliases them
    (``alloc(shared=...)``); eviction (least recently used first, under
    pressure) drops the pins, and a page frees once no slot maps it."""

    def __init__(self):
        self._entries: dict[str, tuple[tuple[int, ...], float]] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, key: str | None, stamp: float) -> list[int]:
        if key is None or key not in self._entries:
            return []
        pages, _ = self._entries[key]
        self._entries[key] = (pages, stamp)  # touched: most recently used
        return list(pages)

    def publish(self, cache: PagedCache, key: str | None, pages, stamp: float) -> int:
        """Pin ``pages`` (a slot's cross row; zeros skipped) under ``key``;
        returns the pages pinned (0 when the key is None or already in)."""
        if key is None or key in self._entries:
            return 0
        pages = tuple(int(p) for p in pages if int(p) != 0)
        for p in pages:
            cache.ref_page(p)
        self._entries[key] = (pages, stamp)
        return len(pages)

    def _evictable(self, cache: PagedCache, key: str, pages, exclude) -> bool:
        """The entry's pin is the last reference of each of its pages."""
        return key not in exclude and all(int(cache.refcounts[p]) == 1 for p in pages)

    def evictable_pages(self, cache: PagedCache, exclude: set[str] | None = None) -> int:
        """Pages that would return to the free list if every entry whose pin
        is each page's last reference were dropped."""
        exclude = exclude or set()
        return sum(len(pages) for key, (pages, _) in self._entries.items()
                   if self._evictable(cache, key, pages, exclude))

    def evict(self, cache: PagedCache, n_pages: int, exclude: set[str] | None = None) -> int:
        """Drop least recently used entries that no slot maps until
        ``n_pages`` pages are free again (or none is left); returns the
        pages freed."""
        exclude = exclude or set()
        freed = 0
        for key, (pages, _) in sorted(self._entries.items(), key=lambda kv: kv[1][1]):
            if freed >= n_pages:
                break
            if not self._evictable(cache, key, pages, exclude):
                continue  # still mapped by a live slot
            for p in pages:
                cache.unref_page(p)
            freed += len(pages)
            del self._entries[key]
        return freed

    def cached_pages(self) -> int:
        return sum(len(pages) for pages, _ in self._entries.values())


class StatePool:
    """Every per-slot decode byte of one non-paged family, in pooled planes:

    ===========  ==================  ==============  ====================
    family       attention-KV plane  cross-KV plane  state rings
    ===========  ==================  ==============  ====================
    ``ssm``      —                   —               conv + h
    ``hybrid``   ``"attn"`` stacks   —               conv + h (Mamba2)
    ``encdec``   ``"self"``          ``"cross"``     —
    ``vlm``      ``"self"``          ``"cross"``     —
    ===========  ==================  ==============  ====================

    The engine talks to this class alone (admission, release, the ring
    cursor, accounting); the steps read and write the planes' tensors."""

    def __init__(self, model: Model, *, n_slots: int, max_len: int, page_size: int = 16,
                 kv_dtype: str = "mxfp4", device="cuda", debug: bool = False,
                 cross_headroom: int = 2):
        cfg = model.cfg
        if cfg.family not in STATE_FAMILIES:
            raise ValueError(f"StatePool covers {STATE_FAMILIES}, got {cfg.family!r} "
                             f"(dense/moe use PagedCache directly)")
        if kv_dtype not in ("mxfp4", "dense"):
            raise ValueError(f"kv_dtype must be 'mxfp4' or 'dense', got {kv_dtype!r}")
        self.family = cfg.family
        self.n_slots, self.max_len, self.page_size = n_slots, max_len, page_size
        self.kv_dtype, self.debug = kv_dtype, debug
        self._itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        spec = model.cache_spec(1, max_len)  # batch-1 shapes

        # the attention-KV plane: K [L_kv, 1, max_len, Hkv, hd]
        self.kv: PagedCache | None = None
        # the cache tree's key of the stacks this plane holds
        self.kv_key = {"hybrid": "attn", "encdec": "self", "vlm": "self"}.get(self.family)
        if self.kv_key is not None:
            (L_kv, _, _, H, hd), dtype = spec[self.kv_key][0]
            self.kv = PagedCache(None, n_slots=n_slots, pages_per_slot=-(-max_len // page_size),
                                 page_size=page_size, kv_dtype=kv_dtype, device=device,
                                 debug=debug, geometry=(L_kv, H, hd), dtype=dtype)

        # the cross-KV plane: K [L_c, 1, T_src, Hkv, hd]; the headroom beyond
        # one page set a slot keeps retired but cached sources alive
        # (CrossIndex pins) without wedging admission
        self.cross: PagedCache | None = None
        self.cross_tokens = 0
        if self.family in ("encdec", "vlm"):
            (L_c, _, T_src, H, hd), dtype = spec["cross"][0]
            cpp = -(-T_src // page_size)
            self.cross = PagedCache(None, n_slots=n_slots, pages_per_slot=cpp,
                                    page_size=page_size,
                                    n_pages=1 + (n_slots + cross_headroom) * cpp,
                                    kv_dtype=kv_dtype, device=device, debug=debug,
                                    geometry=(L_c, H, hd), dtype=dtype)
            self.cross_tokens = int(T_src)
        self.cross_index = CrossIndex()

        # the state rings over the recurrent leaves, in the tree's order
        ring_spec = {"ssm": spec, "hybrid": spec.get("mamba") if isinstance(spec, dict)
                     else None}.get(self.family)
        self.rings = tuple(RingPlane((shape[0], *shape[2:]), dtype, n_slots, kv_dtype, device)
                           for shape, dtype in cache_leaves(ring_spec or ()))
        # the host ring cursor, shared by every plane: the read page id (0 =
        # fresh, zeros) and which of the slot's RING_DEPTH pages is written next
        self.ring_read = np.zeros((n_slots,), np.int32)
        self.ring_cur = np.zeros((n_slots,), np.int32)
        self.ring_active = np.zeros((n_slots,), bool)

    def pools(self) -> dict:
        """Every plane's device tensors: ``{"kv": dict | None, "cross": dict |
        None, "rings": (dict, ...)}`` (the steps write them in place)."""
        return {"kv": self.kv.pool if self.kv else None,
                "cross": self.cross.pool if self.cross else None,
                "rings": tuple(r.pool for r in self.rings)}

    def planes(self):
        """(kind, plane) pairs."""
        if self.kv is not None:
            yield "attn_kv", self.kv
        if self.cross is not None:
            yield "cross_kv", self.cross
        for r in self.rings:
            yield "state_ring", r

    # -- admission / release (rings are mapped statically; the KV plane
    #    reserves prompt + max_new positions at admission, the cross plane
    #    one page set, aliased when the source is cached) --------------------

    def can_admit(self, n_tokens: int, cross_shared: bool = False) -> bool:
        ok = self.kv is None or self.kv.can_alloc(min(n_tokens, self.max_len))
        if self.cross is not None and not cross_shared:
            ok &= self.cross.pages_needed(self.cross_tokens) <= (
                self.cross.free_pages + self.cross_index.evictable_pages(self.cross))
        return ok

    def alloc(self, slot: int, n_tokens: int, cross_shared=()) -> None:
        """One admission: the KV plane's pages for ``n_tokens`` positions,
        one cross page set (``cross_shared``, a :class:`CrossIndex` match,
        aliased when warm; cached sets evicted first when the free list runs
        short) and a reset ring cursor (the slot reads zeros)."""
        if self.kv is not None:
            self.kv.alloc(slot, min(n_tokens, self.max_len))
        if self.cross is not None:
            need = self.cross.pages_needed(self.cross_tokens)
            shortfall = need - len(cross_shared) - self.cross.free_pages
            if shortfall > 0:
                self.cross_index.evict(self.cross, shortfall)
            self.cross.alloc(slot, self.cross_tokens, shared=cross_shared)
        self.ring_read[slot] = 0
        self.ring_cur[slot] = 0
        self.ring_active[slot] = bool(self.rings)
        self._check()

    def free(self, slot: int) -> None:
        if self.kv is not None:
            self.kv.free(slot)
        if self.cross is not None:
            self.cross.free(slot)  # a published set stays pinned by the index
        self.ring_read[slot] = 0
        self.ring_cur[slot] = 0
        self.ring_active[slot] = False
        self._check()

    # -- ring cursor ---------------------------------------------------------

    def ring_write_id(self, slot: int) -> int:
        return 1 + slot * RING_DEPTH + int(self.ring_cur[slot])

    def ring_ids(self, mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(read ids, write ids) [n_slots] of one batched step: masked-off
        lanes read the zero sentinel and write the scratch sentinel."""
        read = np.where(mask, self.ring_read, 0).astype(np.int32)
        write = np.array([self.ring_write_id(s) if mask[s] else 0
                          for s in range(self.n_slots)], np.int32)
        return read, write

    def ring_advance(self, mask: np.ndarray) -> None:
        """Commit one step of the masked slots: the page just written becomes
        the read page, the slot's other page is written next."""
        if not self.rings:
            return
        for s in np.nonzero(mask)[0]:
            self.ring_read[s] = self.ring_write_id(int(s))
            self.ring_cur[s] ^= 1
        self._check()

    # -- cross sharing -------------------------------------------------------

    def cross_match(self, key: str | None, stamp: float) -> list[int]:
        return self.cross_index.match(key, stamp) if self.cross is not None else []

    def cross_publish(self, key: str | None, slot: int, stamp: float) -> int:
        if self.cross is None:
            return 0
        return self.cross_index.publish(self.cross, key, self.cross.tables[slot], stamp)

    # -- invariants ----------------------------------------------------------

    def _check(self) -> None:
        if self.debug:
            self.check_invariants()

    def check_invariants(self) -> None:
        """The paged planes' allocator invariants and the ring-cursor contract:
        a cursor is in range; an inactive slot holds the reset cursor; an
        active slot's read page is the sentinel or the page its cursor wrote
        last."""
        for p in (self.kv, self.cross):
            if p is not None:
                p.check_invariants()
        for s in range(self.n_slots):
            cur, read = int(self.ring_cur[s]), int(self.ring_read[s])
            if cur not in range(RING_DEPTH):
                raise AssertionError(f"slot {s} ring cursor {cur} out of range")
            if not self.ring_active[s]:
                if read != 0 or cur != 0:
                    raise AssertionError(
                        f"inactive slot {s} has ring state read={read} cur={cur}")
                continue
            base = 1 + s * RING_DEPTH
            expect = 0 if read == 0 else base + ((cur - 1) % RING_DEPTH)
            if read not in (0, expect):
                raise AssertionError(f"slot {s} ring read page {read} is not the sentinel "
                                     f"or its own last-written page {expect}")

    # -- accounting ----------------------------------------------------------

    def cache_bytes(self) -> int:
        return sum(p.cache_bytes() for _, p in self.planes())

    def bits_per_element(self) -> float:
        """Storage bits per state element over every page of every plane."""
        elems = sum(r.padded * r.n_pages for r in self.rings)
        for p in (self.kv, self.cross):
            if p is not None:
                elems += p.layers * p.n_pages * p.page_size * p.kv_heads * p.head_dim * 2
        return self.cache_bytes() * 8 / elems if elems else 0.0

    def occupancy(self) -> float:
        """Live fraction over every plane's pages (rings count their active
        slots' pages)."""
        live = total = 0
        for kind, p in self.planes():
            live += (int(self.ring_active.sum()) * RING_DEPTH if kind == "state_ring"
                     else p.live_pages())
            total += p.n_pages - 1
        return live / total if total else 0.0

    def plane_stats(self) -> dict[str, dict[str, float]]:
        """Page accounting by plane kind."""
        stats: dict[str, dict[str, float]] = {}
        for kind, p in (("attn_kv", self.kv), ("cross_kv", self.cross)):
            if p is not None:
                stats[kind] = {"pages_total": p.n_pages - 1, "pages_free": p.free_pages,
                               "occupancy": p.occupancy()}
        if self.rings:
            total = sum(r.n_pages - 1 for r in self.rings)
            used = int(self.ring_active.sum()) * RING_DEPTH * len(self.rings)
            stats["state_ring"] = {"pages_total": total, "pages_free": total - used,
                                   "occupancy": used / total if total else 0.0}
        return stats

    def ring_page_mask(self) -> np.ndarray:
        """[n_pages] bool over any one ring plane's pages (every plane shares
        the static layout): True where the page holds a slot's current
        state, the quant-health sampling weight."""
        mask = np.zeros((1 + self.n_slots * RING_DEPTH,), bool)
        for s in range(self.n_slots):
            if self.ring_active[s] and int(self.ring_read[s]) != 0:
                mask[int(self.ring_read[s])] = True
        return mask

    def state_bytes_per_decode_step(self, n_tokens: int) -> int:
        """State bytes one slot's decode step moves through the pool at
        ``n_tokens`` positions: the packed KV pages read and one token
        written, the cross pages read, and per ring plane one page read and
        one written."""
        total = sum(2 * r.page_bytes() for r in self.rings)
        if self.kv is not None:
            pb = self.kv.cache_bytes() // self.kv.n_pages
            total += (self.kv.pages_needed(min(n_tokens, self.max_len)) * pb
                      + pb // self.kv.page_size)
        if self.cross is not None:
            pb = self.cross.cache_bytes() // self.cross.n_pages
            total += self.cross.pages_needed(self.cross_tokens) * pb
        return total

    def dense_state_bytes_per_decode_step(self, n_tokens: int) -> int:
        """The same step in the dense-slot oracle: the whole dense KV cache
        read (dense attention reads every position) and one token written,
        the dense cross-KV read, and the recurrent state read and rewritten
        whole (``n_tokens`` is the other method's; dense traffic does not
        depend on it)."""
        total = sum(2 * r.dense_bytes() for r in self.rings)
        if self.kv is not None:
            kv = self.kv
            row = 2 * kv.layers * kv.kv_heads * kv.head_dim * self._itemsize
            total += row * self.max_len + row
        if self.cross is not None:
            c = self.cross
            total += 2 * c.layers * self.cross_tokens * c.kv_heads * c.head_dim * self._itemsize
        return total
