"""Forward-only GQA flash attention (B6).

Port of ``repro.kernels.flash_attention``: one pass per (query block,
batch·head) streaming key blocks with an online softmax, causal key blocks
wholly in the future skipped, a padding mask for a key count that is not a
block multiple, and the GQA row map ``(b // Hq)·Hkv + (b % Hq) // group``
(no KV head is repeated).  It has no backward, as the reference has none:
with grad mode on and an input that requires grad it raises.

On CUDA tensors :func:`flash_attention` and :func:`mha_flash` launch
``csrc/flash_attention.cu``, which reads every operand in place through its
strides (``mha_flash`` makes no transpose copy); on CPU tensors they run
:func:`flash_attention_plain`, which repeats the kernel's arithmetic block
by block in f32.  Both launch forms count in ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._work import counted, nbytes

NEG_INF = -1e30
BLOCK = 64  # the kernel's query and key block


def _scale(hd: int) -> float:
    return float(np.float32(1.0 / np.sqrt(hd)))


def _no_grad(*ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError("flash attention has no backward (as in the reference); "
                                  "training uses blocked attention")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, block_q: int = BLOCK, block_k: int = BLOCK,
                          q_heads: int = 1, kv_heads: int = 1) -> torch.Tensor:
    """q [B·Hq, S, hd], k/v [B·Hkv, T, hd] → [B·Hq, S, hd] in q's dtype.

    Block by block in f32: ``q · fl32(1/√hd)`` before the product; scores
    masked to −1e30 for key positions ≥ T (the keys are zero-padded to a
    block multiple) and, if causal, for q_pos < k_pos; key blocks starting
    past a query block's last row skipped; running (m, l, acc), then
    ``acc / max(l, 1e-30)``."""
    bh, s, hd = q.shape
    t = k.shape[1]
    group = q_heads // kv_heads
    if bh % q_heads or k.shape[0] != (bh // q_heads) * kv_heads:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"fit q_heads={q_heads}, kv_heads={kv_heads}")
    rows = torch.arange(bh, device=q.device)
    kv_row = (rows // q_heads) * kv_heads + (rows % q_heads) // group
    bq, bk = min(block_q, s), min(block_k, t)
    nk = -(-t // bk)
    pad = nk * bk - t
    kf = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, pad))[kv_row]
    vf = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, pad))[kv_row]
    qf = q.to(torch.float32) * _scale(hd)
    out = torch.empty_like(q)
    for q0 in range(0, s, bq):
        qb = qf[:, q0:q0 + bq]
        n = qb.shape[1]
        q_pos = torch.arange(q0, q0 + n, device=q.device)[:, None]
        m = torch.full((bh, n), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((bh, n, hd), dtype=torch.float32, device=q.device)
        for j in range(nk):
            k0 = j * bk
            if causal and k0 > q0 + bq - 1:
                break
            sc = torch.einsum("bqd,bkd->bqk", qb, kf[:, k0:k0 + bk])
            k_pos = torch.arange(k0, k0 + bk, device=q.device)[None, :]
            mask = k_pos < t
            if causal:
                mask = mask & (q_pos >= k_pos)
            sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, torch.amax(sc, dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bqk,bkd->bqd", p, vf[:, k0:k0 + bk])
            m = m_new
        out[:, q0:q0 + n] = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, out, B, Hq, Hkv, S, T, hd, strides, causal: bool) -> None:
    """Launch the kernel over [B, S, Hq, hd]-indexed operands given by their
    (batch, sequence, head) strides, in elements, for q, k, v and out."""
    dev = q.device
    ok = (q.dtype in (torch.float32, torch.bfloat16)
          and all(t.dtype == q.dtype and t.device == dev and t.stride(-1) == 1
                  for t in (q, k, v, out))
          and hd % 8 == 0 and 0 < hd <= 128 and Hkv > 0 and Hq % Hkv == 0
          and 0 < B * Hq <= 65535 and S > 0 and T > 0)
    if not ok:
        raise ValueError(
            f"flash_attention: unsupported operands q {tuple(q.shape)} {q.dtype} "
            f"(strides {q.stride()}), k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)}: "
            f"the kernel takes f32/bf16 with a contiguous last axis, hd <= 128 with "
            f"hd % 8 == 0 and Hq % Hkv == 0")
    st = (ctypes.c_longlong * 12)(*strides)
    status = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      int(q.dtype == torch.bfloat16), B, Hq, Hkv, S, T, hd, st, _scale(hd),
                      int(causal), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "flash_attention")
    flash_attention.launches += 1


def _device(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    return True


def _cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
          q_heads: int = 1, kv_heads: int = 1):
    """q, k, v read and the output written once; 4·S·T·hd operations a
    (batch, query head), half of them when causal, as ``chip_smoke.py``'s
    times phase counts them.  [B·Hq, S, hd] or [B, S, Hq, hd] alike."""
    S, hd = (q.shape[1], q.shape[2]) if q.dim() == 3 else (q.shape[1], q.shape[3])
    T = k.shape[1]
    bh = q.numel() // (S * hd)
    return (4 * bh * S * T * hd * (0.5 if causal else 1.0),
            2 * nbytes(q) + nbytes(k) + nbytes(v))


@counted(_cost)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    q_heads: int = 1, kv_heads: int = 1) -> torch.Tensor:
    """q [B·Hq, S, hd], k/v [B·Hkv, T, hd] (any strides with a contiguous
    last axis) → [B·Hq, S, hd] in q's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel; anything else raises."""
    _no_grad(q, k, v)
    if not _device(q):
        return flash_attention_plain(q, k, v, causal, q_heads=q_heads, kv_heads=kv_heads)
    bh, s, hd = q.shape
    hq, hkv = q_heads, kv_heads
    if bh % hq or k.shape[0] != (bh // hq) * hkv or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"fit q_heads={hq}, kv_heads={hkv}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = []
    for t, h in ((q, hq), (k, hkv), (v, hkv), (out, hq)):
        strides += [h * t.stride(0), t.stride(1), t.stride(0)]
    _launch(q, k, v, out, bh // hq, hq, hkv, s, k.shape[1], hd, strides, causal)
    return out


flash_attention.launches = 0


@counted(_cost)
def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """[B, S, Hq, hd] × [B, T, Hkv, hd] (GQA) → [B, S, Hq, hd] in q's dtype."""
    _no_grad(q, k, v)
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if not _device(q):
        o = flash_attention_plain(q.transpose(1, 2).reshape(B * Hq, S, hd),
                                  k.transpose(1, 2).reshape(B * Hkv, T, hd),
                                  v.transpose(1, 2).reshape(B * Hkv, T, hd), causal,
                                  q_heads=Hq, kv_heads=Hkv)
        return o.reshape(B, Hq, S, hd).transpose(1, 2)
    if k.shape != (B, T, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"mha_flash: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit [B, S, Hq, hd] x [B, T, Hkv, hd]")
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    _launch(q, k, v, out, B, Hq, Hkv, S, T, hd, strides, causal)
    return out
