"""MXFP4 KV pages: quantize-pack (B4a) and unpack-dequantize (B4b).

Port of ``repro.kernels.kv_pack``.  Quantize, per 32-element group:
AbsMax → E8M0-nearest scale stored as a biased uint8 → E2M1 round to
nearest (ties to even) → 4-bit codes S|EE|M, two per byte, high nibble
first.  Unpack inverts that by arithmetic.  The functions are bit-identical
to ``core.quantizers.kv_quantize`` / ``kv_dequantize``.  A head dim that
32 does not divide takes the whole head as one block, as the reference's
``quant_block`` does (zamba2-7b's 112: 56 code bytes and one scale byte a
row); the kernels have a body for each block of :data:`HEAD_BLOCKS`.

On a CUDA tensor each wrapper launches ``csrc/kv_pack.cu``; on a CPU tensor
it runs the plain version.  Besides the 2-D forms of the reference, the
engine calls two fused forms: :func:`kv_quant_scatter_kv` quantizes a
write's new K and V rows straight into their (page, offset) slots of the
pool leaves, both in one launch (:func:`kv_quant_scatter` does the same for
one leaf pair), reading the rows through their strides; and
:func:`kv_gather_dequant_kv` reads K's and V's pages through the page tables
into the dense ``[L, B, T, Hkv, hd]`` views in the compute dtype, both in one
launch (:func:`kv_gather_dequant` does the same for one leaf pair; bf16 is
written directly: every dequantized value has at most 2 significant bits, so
it equals the f32 result cast to bf16).  The fused forms count as launches
of their kernel: ``kv_quant_pack.launches`` and
``kv_dequant_unpack.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import formats as F
from repro_torch.core import quantizers as Q
from repro_torch.kernels import _build
from repro_torch.kernels._work import counted, nbytes

GROUP = 32
# magnitude index of ±6.0: a quantized element on this code was at (or
# clipped to) the top of the E2M1 grid; the share of such codes in a pool is
# the clip-rate gauge of ``serve.telemetry.quant_health``
E2M1_SAT_IDX = 7
# head-wide blocks (one scale a row of K values, 32 not dividing K) the
# kernels are built for: zamba2-7b's attention head (kHeadBlock in
# csrc/kv_pack.cu)
HEAD_BLOCKS = (112,)


def split_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Packed bytes [..., K/2] u8 → nibble codes [..., K] u8, high nibble
    first (the pack order)."""
    *lead, kh = packed.shape
    return torch.stack([(packed >> 4) & 0xF, packed & 0xF], dim=-1).reshape(*lead, kh * 2)


def unpack_dequant(packed: torch.Tensor, scale_codes: torch.Tensor,
                   block: int = GROUP) -> torch.Tensor:
    """Packed nibbles [..., K/2] u8 + E8M0 codes [..., K/block] u8 → f32
    [..., K], by arithmetic: |v| = 2^((i−2)>>1)·(1 + (i&1)/2) for i ≥ 2,
    i/2 below."""
    *lead, kh = packed.shape
    k = kh * 2
    nib = split_nibbles(packed)
    idx = (nib & 7).to(torch.int32)
    mag = torch.where(idx >= 2,
                      F.exp2i(torch.clamp(idx - 2, min=0) >> 1) * (1.0 + 0.5 * (idx & 1)),
                      0.5 * idx)
    val = torch.where((nib & 8) > 0, -mag, mag)
    scale = F.exp2i(scale_codes.to(torch.int32) - 127)
    return (val.reshape(*lead, k // block, block) * scale[..., None]).reshape(*lead, k)


def kv_quant_pack_plain(x: torch.Tensor, block: int = GROUP):
    """x [M, K] f32/bf16 → (packed codes u8 [M, K/2], E8M0 codes u8
    [M, K/block]): the kernel's function in plain PyTorch."""
    if x.shape[-1] % block != 0:
        raise ValueError(f"K={x.shape[-1]} not divisible by block {block}")
    pq = Q.kv_quantize(x, dataclasses.replace(F.MXFP4, block=block))
    return pq.codes, pq.scales


def kv_dequant_unpack_plain(codes: torch.Tensor, scales: torch.Tensor,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(packed codes [M, K/2], E8M0 codes [M, K/block]) → [M, K] in
    ``dtype``, computed in f32 and cast."""
    block = codes.shape[-1] * 2 // scales.shape[-1]
    return unpack_dequant(codes, scales, block).to(dtype)


@functools.cache
def _entries():
    lib = _build.load("kv_pack")
    quant = lib.kv_quant_scatter
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    quant.argtypes = [ctypes.c_int, ptrs, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ptrs,
                      ptrs, ctypes.c_void_p]
    quant.restype = ctypes.c_int
    deq = lib.kv_gather_dequant
    deq.argtypes = [ctypes.c_int, ptrs, ptrs, ptrs, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_void_p]
    deq.restype = ctypes.c_int
    quant_rows = lib.kv_quant_scatter_rows
    quant_rows.argtypes = quant.argtypes
    quant_rows.restype = ctypes.c_int
    deq_rows = lib.kv_gather_dequant_rows
    deq_rows.argtypes = deq.argtypes[:10] + [ctypes.c_int] + deq.argtypes[10:]
    deq_rows.restype = ctypes.c_int
    return quant, deq, quant_rows, deq_rows


def _device(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {t.device}")
    return True


def _check_block(name: str, k: int, n_scales: int) -> int:
    """The scale block of rows of ``k`` values with ``n_scales`` scales each,
    if the kernels take it: 32 (K % 32 == 0), or the whole row for a
    head-wide block of :data:`HEAD_BLOCKS`."""
    if k % GROUP == 0 and n_scales == k // GROUP:
        return GROUP
    if n_scales == 1 and k in HEAD_BLOCKS:
        return k
    raise ValueError(f"{name}: the kernel takes K % 32 == 0 with one scale per 32 "
                     f"elements, or one scale a row of K in {HEAD_BLOCKS}, got K={k} with "
                     f"{n_scales} scales per row")


_PTRS = ctypes.c_void_p * 2
_STRIDES = ctypes.c_longlong * 6


def _as_i32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int32 and t.is_contiguous() else t.to(torch.int32).contiguous()


def _launch_quant(name, sources, lead, page_ids, offsets, n_pages, ps):
    """One launch quantizing each (x, codes, scales) of ``sources`` (one or
    two, alike in shape and dtype).  ``lead`` = (L, N, H): x is [L, N, H, K]
    or, with L = 1, [N, H, K]; with page ids [N] row (l, n, h) lands at (l,
    page_ids[n], offsets[n], h) of pool leaves [L, n_pages, ps, H, ..], else
    at row (l·N + n)·H + h of [L·N·H, ..].  Builds no tensor views: this
    runs once a layer on every serving step."""
    L, N, H = lead
    x0 = sources[0][0]
    if x0.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: need f32/bf16 input, got {x0.dtype}")
    k = x0.shape[-1]
    xs, strides = [], []  # xs holds any contiguous copy until the launch
    block = GROUP
    for x, codes, scales in sources:
        if x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError(f"{name}: K and V rows differ: {tuple(x.shape)} {x.dtype} vs "
                             f"{tuple(x0.shape)} {x0.dtype}")
        if not (codes.dtype == scales.dtype == torch.uint8 and codes.is_contiguous()
                and scales.is_contiguous() and codes.device == scales.device == x.device) \
                or codes.data_ptr() % 16:
            raise ValueError(f"{name}: the outputs must be contiguous uint8 on {x.device}, "
                             f"the codes 16-byte aligned")
        block = _check_block(name, k, scales.shape[-1])
        xs.append(x if x.stride(-1) == 1 else x.contiguous())
        st = xs[-1].stride()
        # element strides of (l, n, h); a dimension of size 1 is never stepped
        strides += (st[0] if L > 1 else 0, st[-3] if N > 1 else 0, st[-2] if H > 1 else 0)
    if L * N * H == 0:
        return
    ptrs = [x.data_ptr() for x in xs]
    es = x0.element_size()
    vec = not any(p % 16 for p in ptrs) and not any(st * es % 16 for st in strides)
    pid = off = None
    if page_ids is not None:
        pid, off = _as_i32(page_ids), _as_i32(offsets)
        if pid.device != x0.device or off.device != x0.device or pid.numel() != N \
                or off.numel() != N:
            raise ValueError(f"{name}: page ids and offsets must be [N] tensors on {x0.device}")
    status = _entries()[0 if block == GROUP else 2](
        len(ptrs), _PTRS(*ptrs), _STRIDES(*strides), int(x0.dtype == torch.bfloat16), int(vec),
        L, N, H, k, None if pid is None else pid.data_ptr(),
        None if off is None else off.data_ptr(), n_pages, ps,
        _PTRS(*(c.data_ptr() for _, c, _ in sources)),
        _PTRS(*(s.data_ptr() for _, _, s in sources)),
        torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(status, name)
    kv_quant_pack.launches += 1


def _quant_cost(x: torch.Tensor, block: int = GROUP):
    """x read; half a code byte an element and a scale byte a block written."""
    return 0, nbytes(x) + x.numel() // 2 + x.numel() // block


def _scatter_cost(leaves, page_ids: torch.Tensor) -> tuple[int, int]:
    """Each (codes, scales, x) source read and its codes and scale codes
    written, 8 bytes of page id and offset a token."""
    return 0, 8 * page_ids.numel() + sum(
        _quant_cost(x, 2 * codes.shape[-1] // scales.shape[-1])[1] for codes, scales, x in leaves)


def _gather_cost(leaves, tables: torch.Tensor, dtype: torch.dtype) -> tuple[int, int]:
    """Each (codes, scales) leaf's pages that ``tables`` names read once
    (per layer) and the dense values written in ``dtype``; the tables read."""
    B, P = tables.shape
    out = 0
    for codes, scales in leaves:
        L, _, ps, H, kh = codes.shape
        rows = L * B * P * ps * H
        out += rows * (kh + scales.shape[-1]) + rows * 2 * kh * torch.empty(
            (), dtype=dtype).element_size()
    return 0, out + 4 * tables.numel()


@counted(_quant_cost)
def kv_quant_pack(x: torch.Tensor, block: int = GROUP):
    """x [M, K] (f32 or bf16) → (codes u8 [M, K/2], scales u8 [M, K/block]).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (blocks of 32, or a head-wide block of :data:`HEAD_BLOCKS` with block ==
    K); anything else raises."""
    if not _device("kv_quant_pack", x):
        return kv_quant_pack_plain(x, block)
    if x.dim() != 2 or not (block == GROUP or block == x.shape[-1] in HEAD_BLOCKS):
        raise ValueError(f"kv_quant_pack: the kernel takes a 2-d input and blocks of "
                         f"{GROUP} or a whole row of K in {HEAD_BLOCKS}, got "
                         f"{tuple(x.shape)} with block {block}")
    m, k = x.shape
    codes = torch.empty((m, k // 2), dtype=torch.uint8, device=x.device)
    scales = torch.empty((m, k // block), dtype=torch.uint8, device=x.device)
    _launch_quant("kv_quant_pack", [(x[:, None], codes, scales)], (1, m, 1), None, None, 0, 0)
    return codes, scales


kv_quant_pack.launches = 0


def _scatter(name: str, leaves, page_ids: torch.Tensor, offsets: torch.Tensor) -> None:
    """Quantize each (codes, scales, x) of ``leaves`` into its pool leaves, in
    place; on the card all of them in one launch."""
    shape = leaves[0][0].shape
    one_layer = len(shape) == 4
    L, n_pages, ps, H, kh = (1, *shape) if one_layer else shape
    n = page_ids.numel()
    want = (n, H, 2 * kh) if one_layer else (L, n, H, 2 * kh)
    for codes, scales, x in leaves:
        if codes.shape != shape or scales.shape[:-1] != shape[:-1] or x.shape != want:
            raise ValueError(f"{name}: x {tuple(x.shape)} does not fit the pool leaves "
                             f"{tuple(codes.shape)} / {tuple(scales.shape)} with {n} page ids")
    if not _device(name, leaves[0][2]):
        pid, off = page_ids.reshape(-1).long(), offsets.reshape(-1).long()
        idx = (pid, off) if one_layer else (slice(None), pid, off)
        for codes, scales, x in leaves:
            c, s = kv_quant_pack_plain(x.reshape(-1, 2 * kh), 2 * kh // scales.shape[-1])
            codes[idx] = c.reshape(*want[:-1], -1)
            scales[idx] = s.reshape(*want[:-1], -1)
        return
    _launch_quant(name, [(x, c, s) for c, s, x in leaves], (L, n, H), page_ids, offsets,
                  n_pages, ps)


@counted(lambda pool_codes, pool_scales, page_ids, offsets, x:
         _scatter_cost([(pool_codes, pool_scales, x)], page_ids))
def kv_quant_scatter(pool_codes: torch.Tensor, pool_scales: torch.Tensor,
                     page_ids: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> None:
    """Quantize ``x`` and write each row in place at (page_ids[n],
    offsets[n], head) of a pool leaf.

    One layer: leaves [n_pages, ps, H, K/2] and [n_pages, ps, H, K/block],
    x [N, H, K].  All layers: leaves with a leading [L] axis and x
    [L, N, H, K].  page_ids/offsets [N].  ``x`` may be any strided view.
    Duplicate (page, offset) pairs resolve arbitrarily (only the scratch
    page takes them).

    The package's KV writes all take :func:`kv_quant_scatter_kv` (K and V
    in one launch); this one-leaf form is what the tests and
    ``chip_smoke.py`` hold that form against, one call per leaf."""
    _scatter("kv_quant_scatter", [(pool_codes, pool_scales, x)], page_ids, offsets)


@counted(lambda k_codes, k_scales, v_codes, v_scales, page_ids, offsets, k, v:
         _scatter_cost([(k_codes, k_scales, k), (v_codes, v_scales, v)], page_ids))
def kv_quant_scatter_kv(k_codes: torch.Tensor, k_scales: torch.Tensor, v_codes: torch.Tensor,
                        v_scales: torch.Tensor, page_ids: torch.Tensor, offsets: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor) -> None:
    """:func:`kv_quant_scatter` of ``k`` into the K leaves and of ``v`` into
    the V leaves (both one layer's, or both all layers'), in one launch on
    the card."""
    _scatter("kv_quant_scatter_kv", [(k_codes, k_scales, k), (v_codes, v_scales, v)],
             page_ids, offsets)


TILE = 8192  # code bytes a CTA dequantizes at most (kTile in csrc/kv_pack.cu)


def tile_bytes(block: int) -> int:
    """Code bytes of a dequantize CTA's tile: ``TILE``, or for a head-wide
    block ``TILE`` rounded down to whole rows of block / 2 bytes."""
    row = block // 2
    return TILE if block == GROUP else TILE // row * row


def row_chunks(m: int, kh: int) -> tuple[int, int, int]:
    """(chunks, chunk bytes, total bytes) of the 2-d form over [m, kh] codes:
    whole rows, as many as fit in ``TILE`` bytes (one row if it is longer;
    the kernel then splits it into tiles), the last chunk short."""
    rows = max(1, TILE // kh) if kh else 1
    return -(-m // rows), rows * kh, m * kh


def _launch_dequant(name, sources, tables, n_out_chunks, chunk, total, n_tbl, n_pages, dtype,
                    out_shape):
    """One launch dequantizing each (codes, scales) of ``sources`` (one or
    two, alike) into a new ``out_shape`` tensor each; output chunk c reads
    source chunk c, or with ``tables`` [n_tbl] int32 source chunk (c //
    n_tbl)·n_pages + tables[c % n_tbl] (chunks of ``chunk`` code bytes, the
    output ending after ``total``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: output dtype must be f32 or bf16, got {dtype}")
    dev = sources[0][0].device
    ptrs = []  # codes 4-byte aligned for the kernel's word loads; a copy lives until the launch
    block = GROUP
    for codes, scales in sources:
        if not all(t.dtype == torch.uint8 and t.is_contiguous() and t.device == dev
                   for t in (codes, scales)):
            raise ValueError(f"{name}: codes and scales must be contiguous uint8 on {dev}")
        block = _check_block(name, codes.shape[-1] * 2, scales.shape[-1])
        ptrs.append((codes if codes.data_ptr() % 4 == 0 else codes.clone(), scales))
    if tables is not None and (tables.dtype != torch.int32 or tables.device != dev):
        raise ValueError(f"{name}: tables must be int32 on {dev}")
    outs = [torch.empty(out_shape, dtype=dtype, device=dev) for _ in sources]
    if total == 0:
        return outs
    args = (len(sources), _PTRS(*(c.data_ptr() for c, _ in ptrs)),
            _PTRS(*(s.data_ptr() for _, s in ptrs)), _PTRS(*(o.data_ptr() for o in outs)),
            None if tables is None else tables.data_ptr(), n_out_chunks, chunk, total, n_tbl,
            n_pages)
    tail = (int(dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    if block == GROUP:
        status = _entries()[1](*args, *tail)
    else:  # the head-wide body: rows of block / 2 code bytes
        status = _entries()[3](*args, block // 2, *tail)
    _build.check(status, name)
    kv_dequant_unpack.launches += 1
    return outs


def _dequant_cost(codes: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype = torch.float32):
    """Codes and scale codes read; two values a code byte written in
    ``dtype``."""
    return 0, nbytes(codes) + nbytes(scales) + codes.numel() * 2 * torch.empty(
        (), dtype=dtype).element_size()


@counted(_dequant_cost)
def kv_dequant_unpack(codes: torch.Tensor, scales: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(codes u8 [M, K/2], scales u8 [M, K/32], or [M, 1] for a head-wide
    block) → [M, K] in ``dtype``.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (chunks of whole rows, :func:`row_chunks`); anything else raises."""
    if not _device("kv_dequant_unpack", codes):
        return kv_dequant_unpack_plain(codes, scales, dtype)
    if codes.dim() != 2 or scales.dim() != 2 or codes.shape[0] != scales.shape[0]:
        raise ValueError(f"kv_dequant_unpack: bad operands {tuple(codes.shape)} / "
                         f"{tuple(scales.shape)}")
    m, kh = codes.shape
    return _launch_dequant("kv_dequant_unpack", [(codes, scales)], None, *row_chunks(m, kh), 1,
                           0, dtype, (m, 2 * kh))[0]


kv_dequant_unpack.launches = 0


def _gather(name: str, leaves, tables: torch.Tensor, dtype: torch.dtype):
    """Each (codes, scales) of ``leaves`` read through ``tables`` into a dense
    [L, B, P·ps, H, K] tensor; on the card all of them in one launch."""
    shape = leaves[0][0].shape
    L, n_pages, ps, H, kh = shape
    B, P = tables.shape
    for codes, scales in leaves:
        if codes.shape != shape or scales.shape[:4] != shape[:4]:
            raise ValueError(f"{name}: codes {tuple(codes.shape)} and scales "
                             f"{tuple(scales.shape)} do not match the leaves {tuple(shape)}")
    if not _device(name, leaves[0][0]):
        idx = tables.long()
        return [kv_dequant_unpack_plain(c[:, idx], s[:, idx], dtype).reshape(
            L, B, P * ps, H, 2 * kh) for c, s in leaves]
    n_out, chunk = L * B * P, ps * H * kh
    return _launch_dequant(name, leaves, tables.contiguous(), n_out, chunk, n_out * chunk, B * P,
                           n_pages, dtype, (L, B, P * ps, H, 2 * kh))


@counted(lambda codes, scales, tables, dtype: _gather_cost([(codes, scales)], tables, dtype))
def kv_gather_dequant(codes: torch.Tensor, scales: torch.Tensor, tables: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """Pool leaves [L, n_pages, ps, H, K/2] and [L, n_pages, ps, H,
    K/block] read through ``tables`` int32 [B, P] → dense [L, B, P·ps, H,
    K] in ``dtype``.

    The package's gathers all take :func:`kv_gather_dequant_kv` (K and V in
    one launch); this one-leaf form is what the tests and ``chip_smoke.py``
    hold that form against, one call per leaf."""
    return _gather("kv_gather_dequant", [(codes, scales)], tables, dtype)[0]


@counted(lambda k_codes, k_scales, v_codes, v_scales, tables, dtype:
         _gather_cost([(k_codes, k_scales), (v_codes, v_scales)], tables, dtype))
def kv_gather_dequant_kv(k_codes: torch.Tensor, k_scales: torch.Tensor, v_codes: torch.Tensor,
                         v_scales: torch.Tensor, tables: torch.Tensor, dtype: torch.dtype):
    """(:func:`kv_gather_dequant` of the K leaves, of the V leaves), both
    alike in shape, in one launch on the card."""
    k, v = _gather("kv_gather_dequant_kv", [(k_codes, k_scales), (v_codes, v_scales)], tables,
                   dtype)
    return k, v
