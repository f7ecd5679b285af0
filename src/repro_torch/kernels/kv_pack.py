"""MXFP4 KV pages: quantize-pack (B4a) and unpack-dequantize (B4b).

Port of ``repro.kernels.kv_pack``.  Quantize, per 32-element group:
AbsMax → E8M0-nearest scale stored as a biased uint8 → E2M1 round to
nearest (ties to even) → 4-bit codes S|EE|M, two per byte, high nibble
first.  Unpack inverts that by arithmetic.  The functions are bit-identical
to ``core.quantizers.kv_quantize`` / ``kv_dequantize``.

On a CUDA tensor each wrapper launches ``csrc/kv_pack.cu``; on a CPU tensor
it runs the plain version.  Besides the 2-D forms of the reference, the
engine calls two fused forms: :func:`kv_quant_scatter` quantizes new K or V
rows straight into their (page, offset) slots of a pool leaf, and
:func:`kv_gather_dequant` reads pages through the page tables into the dense
``[L, B, T, Hkv, hd]`` view in the compute dtype (bf16 is written directly:
every dequantized value has at most 2 significant bits, so it equals the f32
result cast to bf16).  Both fused forms count as launches of their kernel:
``kv_quant_pack.launches`` and ``kv_dequant_unpack.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import formats as F
from repro_torch.core import quantizers as Q
from repro_torch.kernels import _build

GROUP = 32


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
    quant.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p]
    quant.restype = ctypes.c_int
    deq = lib.kv_gather_dequant
    deq.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p]
    deq.restype = ctypes.c_int
    return quant, deq


def _device(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {t.device}")
    return True


def _check_block(name: str, k: int, n_scales: int) -> None:
    if k % GROUP != 0 or n_scales != k // GROUP:
        raise ValueError(f"{name}: the kernel takes K % 32 == 0 with one scale per 32 "
                         f"elements, got K={k} with {n_scales} scales per row")


def _launch_quant(name, x, page_ids, offsets, n, h, n_pages, ps, codes, scales):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: need f32/bf16 input, got {x.dtype}")
    if not all(t.dtype == torch.uint8 and t.is_contiguous() and t.device == x.device
               for t in (codes, scales)):
        raise ValueError(f"{name}: the outputs must be contiguous uint8 on {x.device}")
    x = x.contiguous()
    k = x.shape[-1]
    _check_block(name, k, scales.shape[-1])
    rows = x.numel() // k
    if rows == 0:
        return
    pid = off = None
    if page_ids is not None:
        pid, off = page_ids.to(torch.int32).contiguous(), offsets.to(torch.int32).contiguous()
        if pid.device != x.device or off.device != x.device or pid.shape != off.shape:
            raise ValueError(f"{name}: page ids and offsets must be [N] tensors on {x.device}")
    status = _entries()[0](x.data_ptr(), int(x.dtype == torch.bfloat16), rows, k,
                           None if pid is None else pid.data_ptr(),
                           None if off is None else off.data_ptr(), n, h, n_pages, ps,
                           codes.data_ptr(), scales.data_ptr(),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, name)
    kv_quant_pack.launches += 1


def kv_quant_pack(x: torch.Tensor, block: int = GROUP):
    """x [M, K] (f32 or bf16) → (codes u8 [M, K/2], scales u8 [M, K/block]).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (block 32 only); anything else raises."""
    if not _device("kv_quant_pack", x):
        return kv_quant_pack_plain(x, block)
    if x.dim() != 2 or block != GROUP:
        raise ValueError(f"kv_quant_pack: the kernel takes a 2-d input and blocks of "
                         f"{GROUP}, got {tuple(x.shape)} with block {block}")
    m, k = x.shape
    codes = torch.empty((m, k // 2), dtype=torch.uint8, device=x.device)
    scales = torch.empty((m, k // GROUP), dtype=torch.uint8, device=x.device)
    _launch_quant("kv_quant_pack", x, None, None, m, 1, 0, 0, codes, scales)
    return codes, scales


kv_quant_pack.launches = 0


def kv_quant_scatter(pool_codes: torch.Tensor, pool_scales: torch.Tensor,
                     page_ids: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> None:
    """Quantize ``x`` and write each row in place at (page_ids[n],
    offsets[n], head) of a pool leaf.

    One layer: leaves [n_pages, ps, H, K/2] and [n_pages, ps, H, K/block],
    x [N, H, K].  All layers: leaves with a leading [L] axis and x
    [L, N, H, K].  page_ids/offsets [N].  Duplicate (page, offset) pairs
    resolve arbitrarily (only the scratch page takes them)."""
    one_layer = pool_codes.dim() == 4
    pc = pool_codes.unsqueeze(0) if one_layer else pool_codes
    ps_ = pool_scales.unsqueeze(0) if one_layer else pool_scales
    xs = x.unsqueeze(0) if one_layer else x
    L, n_pages, ps, H, kh = pc.shape
    n, k = page_ids.numel(), 2 * kh
    if xs.shape != (L, n, H, k) or ps_.shape[:4] != (L, n_pages, ps, H):
        raise ValueError(f"kv_quant_scatter: x {tuple(x.shape)} does not fit the pool leaves "
                         f"{tuple(pool_codes.shape)} / {tuple(pool_scales.shape)} with "
                         f"{n} page ids")
    if not _device("kv_quant_scatter", x):
        block = k // ps_.shape[-1]
        codes, scales = kv_quant_pack_plain(xs.reshape(-1, k), block)
        pid, off = page_ids.reshape(-1).long(), offsets.reshape(-1).long()
        pc[:, pid, off] = codes.reshape(L, n, H, kh)
        ps_[:, pid, off] = scales.reshape(L, n, H, -1)
        return
    _launch_quant("kv_quant_scatter", xs, page_ids.reshape(-1), offsets.reshape(-1), n, H,
                  n_pages, ps, pc, ps_)


def _launch_dequant(name, codes, scales, tables, n_out_chunks, chunk, n_tbl, n_pages, dtype,
                    out_shape):
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: output dtype must be f32 or bf16, got {dtype}")
    if not all(t.dtype == torch.uint8 and t.is_contiguous() for t in (codes, scales)):
        raise ValueError(f"{name}: codes and scales must be contiguous uint8")
    if tables is not None and (tables.dtype != torch.int32 or tables.device != codes.device):
        raise ValueError(f"{name}: tables must be int32 on {codes.device}")
    _check_block(name, codes.shape[-1] * 2, scales.shape[-1])
    out = torch.empty(out_shape, dtype=dtype, device=codes.device)
    if out.numel() == 0:
        return out
    status = _entries()[1](codes.data_ptr(), scales.data_ptr(),
                           None if tables is None else tables.data_ptr(), n_out_chunks, chunk,
                           n_tbl, n_pages, out.data_ptr(), int(dtype == torch.bfloat16),
                           torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check(status, name)
    kv_dequant_unpack.launches += 1
    return out


def kv_dequant_unpack(codes: torch.Tensor, scales: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(codes u8 [M, K/2], scales u8 [M, K/32]) → [M, K] in ``dtype``.
    CPU tensors take the plain version; CUDA tensors launch the kernel;
    anything else raises."""
    if not _device("kv_dequant_unpack", codes):
        return kv_dequant_unpack_plain(codes, scales, dtype)
    if codes.dim() != 2 or scales.dim() != 2 or codes.shape[0] != scales.shape[0] \
            or scales.device != codes.device:
        raise ValueError(f"kv_dequant_unpack: bad operands {tuple(codes.shape)} / "
                         f"{tuple(scales.shape)}")
    m, kh = codes.shape
    return _launch_dequant("kv_dequant_unpack", codes, scales, None, 1, m * kh, 1, 0, dtype,
                           (m, 2 * kh))


kv_dequant_unpack.launches = 0


def kv_gather_dequant(codes: torch.Tensor, scales: torch.Tensor, tables: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """Pool leaves [L, n_pages, ps, H, K/2] and [L, n_pages, ps, H,
    K/block] read through ``tables`` int32 [B, P] → dense [L, B, P·ps, H,
    K] in ``dtype``."""
    L, n_pages, ps, H, kh = codes.shape
    B, P = tables.shape
    if not _device("kv_gather_dequant", codes):
        g = codes[:, tables.long()]  # [L, B, P, ps, H, K/2]
        vals = kv_dequant_unpack_plain(g, scales[:, tables.long()], dtype)
        return vals.reshape(L, B, P * ps, H, 2 * kh)
    if scales.shape[:4] != (L, n_pages, ps, H):
        raise ValueError(f"kv_gather_dequant: scales {tuple(scales.shape)} do not match "
                         f"codes {tuple(codes.shape)}")
    return _launch_dequant("kv_gather_dequant", codes, scales, tables.contiguous(), L * B * P,
                           ps * H * kh, B * P, n_pages, dtype, (L, B, P * ps, H, 2 * kh))
