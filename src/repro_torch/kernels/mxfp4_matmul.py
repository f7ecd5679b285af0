"""Stage 2: MXFP4 block-scaled GEMM over int8 half-codes + per-32 scales.

Port of ``repro.kernels.mxfp4_matmul``.  On a CUDA tensor the wrapper
launches ``csrc/mxfp4_matmul.cu``; on a CPU tensor it runs
:func:`mxfp4_matmul_plain`, which sums exactly as the kernel does: the
integer partial product of each 32-group, scaled by its two power-of-two
scales, added in f32 in group order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

GROUP = 32


def mxfp4_matmul_plain(a_codes, a_scales, b_codes, b_scales) -> torch.Tensor:
    """(A [M, K] int8, [M, K/32] f32) × (B [K, N] int8, [K/32, N] f32) →
    f32 [M, N] = Σ_g (Σ_{k∈g} a·b) · sa · sb · ¼, groups added in order.

    The per-group product is a matrix product of small integers (|Σ| ≤
    4608), exact in f32 in any summation order; TF32 must be off (it is
    off by default, and the callers that time this on the card say so)."""
    m, k = a_codes.shape
    n = b_codes.shape[1]
    a = a_codes.to(torch.float32).reshape(m, k // GROUP, GROUP)
    b = b_codes.to(torch.float32).reshape(k // GROUP, GROUP, n)
    acc = torch.zeros((m, n), dtype=torch.float32, device=a_codes.device)
    for g in range(k // GROUP):
        isum = a[:, g] @ b[g]
        acc = acc + isum * a_scales[:, g, None] * b_scales[None, g, :] * 0.25
    return acc


@functools.cache
def _entry():
    fn = _build.load("mxfp4_matmul").mxfp4_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mxfp4_matmul(a_codes, a_scales, b_codes, b_scales) -> torch.Tensor:
    """(A codes [M, K], scales [M, K/32]) × (B codes [K, N], scales
    [K/32, N]) → f32 [M, N].  On the card B must be K-major (the transposed
    view of [N, K] codes, as every call site passes it: no copy) with a
    16-byte aligned base and row stride, and A contiguous and 16-byte
    aligned; its scales may be any strided view.  CPU tensors take the
    plain version; CUDA tensors launch the kernel; anything else raises."""
    dev = a_codes.device
    if dev.type == "cpu":
        return mxfp4_matmul_plain(a_codes, a_scales, b_codes, b_scales)
    if dev.type != "cuda":
        raise RuntimeError(f"mxfp4_matmul: unsupported device {dev}")
    m, k = a_codes.shape
    k2, n = b_codes.shape
    ok = (k == k2 and k % GROUP == 0 and m > 0 and n > 0
          and a_scales.shape == (m, k // GROUP) and b_scales.shape == (k // GROUP, n)
          and a_codes.dtype == b_codes.dtype == torch.int8
          and a_scales.dtype == b_scales.dtype == torch.float32
          and all(t.device == dev for t in (a_scales, b_codes, b_scales))
          and a_codes.is_contiguous() and a_scales.is_contiguous()
          and a_codes.data_ptr() % 16 == 0
          and b_codes.stride(0) == 1 and b_codes.stride(1) % 16 == 0
          and b_codes.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(
            f"mxfp4_matmul: bad operands A {tuple(a_codes.shape)} {a_codes.dtype} "
            f"{tuple(a_scales.shape)}, B {tuple(b_codes.shape)} {b_codes.dtype} "
            f"{tuple(b_scales.shape)} (B strides {b_codes.stride()}): the kernel takes int8 "
            f"codes with K % 32 == 0, A contiguous and B K-major, both 16-byte aligned")
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    status = _entry()(a_codes.data_ptr(), a_scales.data_ptr(), m, k,
                      b_codes.data_ptr(), b_codes.stride(1),
                      b_scales.data_ptr(), b_scales.stride(0), b_scales.stride(1), n,
                      c.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "mxfp4_matmul")
    mxfp4_matmul.launches += 1
    return c


mxfp4_matmul.launches = 0
