"""Forward Stage 1: fused grouped Hadamard + QuEST → MXFP4 half-codes.

Port of ``repro.kernels.hadamard_quant``.  On a CUDA tensor the wrapper
launches ``csrc/hadamard_quant.cu`` — its vector body (one thread per whole
32-group, 16-byte loads and stores) when :func:`vector_ok` holds, as it does
at every call site of the serving, training and evaluation paths, else its
tile body; on a CPU tensor it runs :func:`hadamard_quest_quantize_plain`, which
performs the kernel's arithmetic in the kernel's order (butterfly Hadamard,
halving sums), so the two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import formats as F
from repro_torch.kernels import _build

GROUP = 32
_E2M1_MAX = 6.0
# the reference's Hadamard matrix entry, fl32(1/sqrt(32))
_H_SCALE = 0.1767766922712326


@functools.cache
def _clip_c() -> float:
    """c* for MXFP4 rounded to f32 (the kernels multiply in f32)."""
    return float(torch.tensor(F.gaussian_optimal_clip("mxfp4"), dtype=torch.float32))


def _butterfly32(xg: torch.Tensor) -> torch.Tensor:
    """Unnormalized Walsh–Hadamard of the last axis (32), in the kernel's
    stage order: at stage h, lane i pairs with lane i ^ h; the lane with
    bit h clear keeps a + b, the other a − b."""
    lead = xg.shape[:-1]
    h = 1
    while h < GROUP:
        pairs = xg.reshape(*lead, GROUP // (2 * h), 2, h)
        a, b = pairs[..., 0, :], pairs[..., 1, :]
        xg = torch.stack([a + b, a - b], dim=-2).reshape(*lead, GROUP)
        h *= 2
    return xg


def _halving_sum32(v: torch.Tensor) -> torch.Tensor:
    """Sum of the last axis (32) as the warp's xor-butterfly reduction adds:
    fold the upper half onto the lower half five times."""
    n = GROUP
    while n > 1:
        n //= 2
        v = v[..., :n] + v[..., n:]
    return v[..., 0]


def hadamard_quest_quantize_plain(x: torch.Tensor):
    """x [M, K] f32/bf16 → (codes int8 [M, K], scales f32 [M, K/32],
    mask bool [M, K]): the kernel's arithmetic in plain PyTorch."""
    m, k = x.shape
    if k % GROUP != 0:
        raise ValueError(f"K={k} not divisible by group {GROUP}")
    xh = _butterfly32(x.to(torch.float32).reshape(m, k // GROUP, GROUP)) * _H_SCALE
    rms = torch.sqrt(_halving_sum32(xh * xh) * (1.0 / GROUP))
    raw = torch.clamp(F.div_exact(rms * _clip_c(), _E2M1_MAX), min=2.0 ** F.E8M0_MIN_EXP)
    scale = F.round_scale_e8m0(raw)
    v = xh / scale[..., None]
    mask = torch.abs(v) <= _E2M1_MAX
    q = F.rtn_e2m1(torch.clamp(v, -_E2M1_MAX, _E2M1_MAX))
    codes = torch.round(q * 2.0).to(torch.int8)
    return codes.reshape(m, k), scale, mask.reshape(m, k)


def vector_ok(x: torch.Tensor) -> bool:
    """Whether the kernel's vector body can read ``x`` [M, K] with 16-byte
    runs: a 16-byte aligned base, and either unit stride along K with
    16-byte aligned rows (activations) or unit stride along M with M % 8 == 0
    and 16-byte aligned columns (the transposed weight view Wᵀ)."""
    m, _ = x.shape
    sm, sk = x.stride()
    es = x.element_size()
    if x.data_ptr() % 16:
        return False
    if sk == 1:
        return m == 1 or sm * es % 16 == 0
    if sm == 1:
        return m % 8 == 0 and sk * es % 16 == 0
    return False


@functools.cache
def _entry():
    fn = _build.load("hadamard_quant").hadamard_quest_quantize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hadamard_quest_quantize(x: torch.Tensor):
    """x [M, K] (any strides; f32 or bf16) → (codes int8 [M, K], scales f32
    [M, K/32], mask bool [M, K]).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``.launches`` counts every launch,
    ``.vector_launches`` those of the vector body); anything else raises."""
    if x.device.type == "cpu":
        return hadamard_quest_quantize_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"hadamard_quest_quantize: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hadamard_quest_quantize: need 2-d f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    m, k = x.shape
    if k % GROUP != 0 or m == 0:
        raise ValueError(f"hadamard_quest_quantize: bad shape {tuple(x.shape)}")
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, k // GROUP), dtype=torch.float32, device=x.device)
    mask = torch.empty((m, k), dtype=torch.bool, device=x.device)
    vector = vector_ok(x)
    status = _entry()(x.data_ptr(), int(x.dtype == torch.bfloat16), m, k,
                      x.stride(0), x.stride(1), codes.data_ptr(), scales.data_ptr(),
                      mask.data_ptr(), _clip_c(), int(vector),
                      torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "hadamard_quest_quantize")
    hadamard_quest_quantize.launches += 1
    hadamard_quest_quantize.vector_launches += vector
    return codes, scales, mask


hadamard_quest_quantize.launches = 0
hadamard_quest_quantize.vector_launches = 0
