"""Shape-flexible wrappers over the 2-D kernels, and their launch counters.

Port of ``repro.kernels.ops`` for the serving path.  Device dispatch lives
in each kernel wrapper: a CPU tensor runs the plain PyTorch version, a CUDA
tensor launches the hand-written kernel (or raises).  Each wrapper counts
its own launches in ``<wrapper>.launches``; :func:`launch_counts` reads them
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.hadamard_quant import hadamard_quest_quantize as _hq_fn
from repro_torch.kernels.mxfp4_matmul import mxfp4_matmul as _mm_fn
from repro_torch.kernels.paged_attention import paged_attention

GROUP = 32

KERNELS = {
    "hadamard_quest_quantize": _hq_fn,
    "mxfp4_matmul": _mm_fn,
    "paged_attention": paged_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def hadamard_quest_quantize(x: torch.Tensor, group: int = GROUP):
    """[..., K] → (codes [..., K] int8, scales [..., K/32] f32, mask [..., K] bool)."""
    if group != GROUP:
        raise ValueError("kernels are specialized to the MXFP4 group of 32")
    lead = x.shape[:-1]
    codes, scales, mask = _hq_fn(x.reshape(-1, x.shape[-1]))
    return codes.reshape(*lead, -1), scales.reshape(*lead, -1), mask.reshape(*lead, -1)


def mxfp4_matmul(a_codes, a_scales, b_codes, b_scales) -> torch.Tensor:
    """[..., K] codes × [K, N] codes → f32 [..., N] (scales along K)."""
    lead = a_codes.shape[:-1]
    out = _mm_fn(a_codes.reshape(-1, a_codes.shape[-1]),
                 a_scales.reshape(-1, a_scales.shape[-1]), b_codes, b_scales)
    return out.reshape(*lead, -1)
