"""One packed pool for the per-slot decode state of the non-paged families.

Port of the state-ring part of ``repro.serve.state_pool``.  An SSM's
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

The attention-KV and cross-KV planes (the hybrid, enc-dec and VLM
families) are not ported yet: :class:`StatePool` raises for those families
rather than serve them partly.  The pool tensors are updated in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.kv_pack import kv_dequant_unpack, kv_quant_pack
from repro_torch.models.registry import Model

STATE_FAMILIES = ("ssm", "hybrid", "encdec", "vlm")
PORTED_FAMILIES = ("ssm",)
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


class StatePool:
    """Every per-slot decode byte of one non-paged family, in pooled
    planes (this slice: the SSM family's state rings, conv and h)."""

    def __init__(self, model: Model, *, n_slots: int, max_len: int, kv_dtype: str = "mxfp4",
                 device="cuda", debug: bool = False):
        cfg = model.cfg
        if cfg.family not in STATE_FAMILIES:
            raise ValueError(f"StatePool covers {STATE_FAMILIES}, got {cfg.family!r} "
                             f"(dense/moe use PagedCache directly)")
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"StatePool for {cfg.family!r} needs its attention-KV or cross-KV plane, "
                f"which is not ported yet")
        if kv_dtype not in ("mxfp4", "dense"):
            raise ValueError(f"kv_dtype must be 'mxfp4' or 'dense', got {kv_dtype!r}")
        self.n_slots, self.debug = n_slots, debug
        self.rings = tuple(RingPlane((shape[0], *shape[2:]), dtype, n_slots, kv_dtype, device)
                           for shape, dtype in model.cache_spec(1, max_len))
        # the host ring cursor, shared by every plane: the read page id (0 =
        # fresh, zeros) and which of the slot's RING_DEPTH pages is written next
        self.ring_read = np.zeros((n_slots,), np.int32)
        self.ring_cur = np.zeros((n_slots,), np.int32)
        self.ring_active = np.zeros((n_slots,), bool)

    # -- admission / release (rings are mapped statically: a free slot can
    #    always take a request) ------------------------------------------------

    def alloc(self, slot: int) -> None:
        """One admission: the slot's ring cursor reset (it reads zeros)."""
        self.ring_read[slot] = 0
        self.ring_cur[slot] = 0
        self.ring_active[slot] = True
        self._check()

    def free(self, slot: int) -> None:
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
        for s in np.nonzero(mask)[0]:
            self.ring_read[s] = self.ring_write_id(int(s))
            self.ring_cur[s] ^= 1
        self._check()

    # -- invariants ----------------------------------------------------------

    def _check(self) -> None:
        if self.debug:
            self.check_invariants()

    def check_invariants(self) -> None:
        """The ring-cursor contract: a cursor is in range; an inactive slot
        holds the reset cursor; an active slot's read page is the sentinel
        or the page its cursor wrote last."""
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
        return sum(r.cache_bytes() for r in self.rings)

    def bits_per_element(self) -> float:
        """Storage bits per state element over every page."""
        elems = sum(r.padded * r.n_pages for r in self.rings)
        return self.cache_bytes() * 8 / elems if elems else 0.0

    def state_bytes_per_decode_step(self) -> int:
        """State bytes one slot's decode step moves through the pool: per
        plane one page read and one written."""
        return sum(2 * r.page_bytes() for r in self.rings)

    def dense_state_bytes_per_decode_step(self) -> int:
        """The same step in the dense-slot oracle: the state read and
        rewritten whole."""
        return sum(2 * r.dense_bytes() for r in self.rings)
