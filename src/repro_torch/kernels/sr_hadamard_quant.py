"""Backward Stage 1: randomized grouped Hadamard + stochastic rounding → MXFP4.

Port of ``repro.kernels.sr_hadamard_quant``: per 32-group of a row,
xh = ¾·(x ⊙ ξ)·H₃₂, scale = E8M0-ceil(absmax(xh)/6), codes = int8(2·SR(xh /
scale)) with unbiased stochastic rounding onto the E2M1 grid.  On a CUDA
tensor the wrapper launches ``csrc/sr_hadamard_quant.cu`` — its vector body
(one thread per whole 32-group, 16-byte loads and stores) when
:func:`~repro_torch.kernels.hadamard_quant.vector_ok` holds, as it does for
all four operands of the training path, else its tile body; on a CPU tensor
it runs :func:`sr_hadamard_quantize_plain`, which performs the kernel's
arithmetic in the kernel's order (butterfly Hadamard, bit-derived
exponents), so the two agree bit for bit on the card.  The kernel divides
only once a group (absmax / 6); its divisions by powers of two are
multiplies by exact reciprocals, which give the plain version's bits.

The uniforms are not an operand, as they are in the reference's kernel: the
kernel hashes (seed, salt, row · K + col) in registers with
``core.fastrng``'s hash, where (row, col) is the element's place in the
*logical* [M, K] operand, whatever its strides.  The plain version draws
the same bits with ``fastrng.uniform(seed, (M, K), salt)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import fastrng
from repro_torch.core import formats as F
from repro_torch.kernels import _build
from repro_torch.kernels.hadamard_quant import _H_SCALE, _butterfly32, vector_ok

GROUP = 32
_E2M1_MAX = 6.0


def _exponent(a: torch.Tensor) -> torch.Tensor:
    """floor(log2(a)) of a positive normal f32, from its exponent field."""
    return (a.view(torch.int32) >> 23) - 127


def e2m1_stochastic_round(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Unbiased SR onto the E2M1 grid for |v| ≤ 6 (the reference kernel's
    arithmetic form): step = 2^(floor(log2 max(|v|, 1)) − 1), round |v| down
    to a multiple of step, go up one step with probability (|v| − lo)/step,
    saturate at 6, put the sign back.  Every operation is exact (divisions
    by powers of two), and the exponent comes from the bits."""
    a = torch.abs(v)
    step = F.exp2i(_exponent(torch.clamp(a, min=1.0)) - 1)
    lo = torch.floor(a / step) * step
    p_up = (a - lo) / step
    q = torch.clamp(torch.where(u < p_up, lo + step, lo), max=_E2M1_MAX)
    return torch.copysign(q, v)


def sr_hadamard_quantize_plain(x: torch.Tensor, signs: torch.Tensor, seed: int,
                               prescale: float = 0.75, salt: int = 0):
    """x [M, K] f32/bf16, signs [K] ±1 → (codes int8 [M, K], scales f32
    [M, K/32]): the kernel's arithmetic in plain PyTorch."""
    m, k = x.shape
    if k % GROUP != 0:
        raise ValueError(f"K={k} not divisible by group {GROUP}")
    xs = x.to(torch.float32) * signs.to(torch.float32)[None, :]
    xh = _butterfly32(xs.reshape(m, k // GROUP, GROUP)) * _H_SCALE * prescale
    absmax = torch.amax(torch.abs(xh), dim=-1)
    raw = torch.clamp(F.div_exact(absmax, _E2M1_MAX), min=2.0 ** F.E8M0_MIN_EXP)
    scale = F.round_scale_e8m0(raw, "ceil")
    u = fastrng.uniform(seed, (m, k), salt, x.device).reshape(m, k // GROUP, GROUP)
    q = e2m1_stochastic_round(xh / scale[..., None], u)
    codes = torch.round(q * 2.0).to(torch.int8)
    return codes.reshape(m, k), scale


@functools.cache
def _entry():
    fn = _build.load("sr_hadamard_quant").sr_hadamard_quantize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sr_hadamard_quantize(x: torch.Tensor, signs: torch.Tensor, seed: int,
                         prescale: float = 0.75, salt: int = 0):
    """x [M, K] (any strides; f32 or bf16), signs [K] → (codes int8 [M, K],
    scales f32 [M, K/32], both contiguous).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (``.launches`` counts every
    launch, ``.vector_launches`` those of the vector body); anything else
    raises."""
    if x.device.type == "cpu":
        return sr_hadamard_quantize_plain(x, signs, seed, prescale, salt)
    if x.device.type != "cuda":
        raise RuntimeError(f"sr_hadamard_quantize: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sr_hadamard_quantize: need 2-d f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    m, k = x.shape
    if k % GROUP != 0 or m == 0 or signs.shape != (k,):
        raise ValueError(f"sr_hadamard_quantize: bad shapes x {tuple(x.shape)}, "
                         f"signs {tuple(signs.shape)}")
    signs = signs.to(device=x.device, dtype=torch.float32).contiguous()
    if signs.data_ptr() % 16:  # the vector body reads the signs 16 bytes at a time
        signs = signs.clone()
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, k // GROUP), dtype=torch.float32, device=x.device)
    vector = vector_ok(x)
    status = _entry()(x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, x.stride(0),
                      x.stride(1), signs.data_ptr(), seed & 0xFFFFFFFF, salt & 0xFFFFFFFF,
                      prescale, codes.data_ptr(), scales.data_ptr(), int(vector),
                      torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "sr_hadamard_quantize")
    sr_hadamard_quantize.launches += 1
    sr_hadamard_quantize.vector_launches += vector
    return codes, scales


sr_hadamard_quantize.launches = 0
sr_hadamard_quantize.vector_launches = 0
