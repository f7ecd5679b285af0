"""Quartet linear layer, forward pass (Algorithm 1, serving).

Forward: fixed block-32 Hadamard on X and on W along the contraction dim K
→ QuEST (RMSE clip + RTN, E8M0 nearest scales) → MXFP4 GEMM with f32
accumulation.  ``use_kernels=True`` runs the two stages as the Hopper
kernels (``kernels.hadamard_quant``, ``kernels.mxfp4_matmul``); ``False``
runs the reference's dequantize-then-multiply formulation in PyTorch.

Serving never differentiates: the Algorithm-1 backward (randomized Hadamard,
stochastic rounding, its ``torch.autograd.Function``) arrives with the
training slice, and until then :func:`quartet_linear` refuses inputs that
require gradients.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import formats as F
from repro_torch.core import quantizers as Q
from repro_torch.core.hadamard import hadamard_transform


@dataclasses.dataclass(frozen=True)
class QuartetConfig:
    """Static configuration of the Quartet linear layer (the forward's
    fields; the backward's arrive with the training slice)."""

    fwd_format: str = "mxfp4"
    group: int = 32  # Hadamard group == MXFP4 scale block
    fwd_quantizer: str = "quest"  # "quest" | "none" (bf16 passthrough)
    use_kernels: bool = False

    @property
    def fwd_fmt(self) -> F.Format:
        return F.get_format(self.fwd_format)


BF16_CONFIG = QuartetConfig(fwd_quantizer="none")
QUARTET_CONFIG = QuartetConfig()


def _gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] with f32 accumulation (f32 operands: bf16
    inputs are exact in f32, and the f32 product is what the reference's
    ``preferred_element_type=f32`` contraction returns)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def quartet_linear(x: torch.Tensor, w: torch.Tensor, seed: int,
                   cfg: QuartetConfig) -> torch.Tensor:
    """y = Quartet(x) @ Quartet(w), forward only.  x [..., K], w [K, N];
    ``seed`` feeds only the backward's stochastic rounding (unused here)."""
    del seed
    if (x.requires_grad or w.requires_grad) and torch.is_grad_enabled():
        raise NotImplementedError(
            "quartet_linear: the Algorithm-1 backward is not ported yet; "
            "call under torch.no_grad() / torch.inference_mode()")
    if cfg.fwd_quantizer == "none":
        return _gemm(x, w).to(x.dtype)
    if cfg.fwd_quantizer != "quest":
        raise NotImplementedError(f"fwd_quantizer {cfg.fwd_quantizer!r} is not ported yet")

    if cfg.use_kernels:
        from repro_torch.kernels import ops as K

        # Stage 1 (fused Hadamard + QuEST) on x and on Wᵀ (a strided view:
        # the kernel reads it in place), then Stage 2 (block-scaled GEMM)
        xc, xs, _ = K.hadamard_quest_quantize(x, group=cfg.group)
        wtc, wts, _ = K.hadamard_quest_quantize(w.t(), group=cfg.group)
        return K.mxfp4_matmul(xc, xs, wtc.t(), wts.t()).to(x.dtype)

    xh = hadamard_transform(x.to(torch.float32), g=cfg.group, dim=-1)
    wh = hadamard_transform(w.to(torch.float32), g=cfg.group, dim=0)
    xq = Q.quest(xh, cfg.fwd_fmt)
    wq = Q.quest(wh.t(), cfg.fwd_fmt)  # blocks along K
    return _gemm(xq.values, wq.values.t()).to(x.dtype)
