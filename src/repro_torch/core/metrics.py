"""Gradient-quality metrics: MSE, cosine similarity, and the paper's
projection magnitude alignment (PMA, §4.3).

Port of ``repro.core.metrics``.

    S(X, ξ) = ⟨X, X⟩ / ⟨Ĥ(X, ξ), Q(Ĥ(X, ξ))⟩
    PMA misalignment = 1 − E_ξ[1/S]

E[1/S] = 1 means the quantizer keeps magnitudes in expectation; SR is
aligned, RTN ≈ 9.3e−3 and QuEST ≈ 1.3e−2 misaligned (Table 2).  The
expectation is a Monte-Carlo mean over ξ, drawn as the reference draws it:
``split(key, num_samples)``, then each sample's key split into the signs'
key and the quantizer's, the signs ``rademacher`` (``core.threefry``, bit
for bit with ``jax.random``).
"""

from __future__ import annotations

import torch

from repro_torch.core import formats as F
from repro_torch.core import quantizers as Q
from repro_torch.core import threefry
from repro_torch.core.hadamard import randomized_hadamard_transform


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def relative_mse(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - q) ** 2) / torch.clamp(torch.mean(x ** 2), min=1e-30)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a.reshape(-1) * b.reshape(-1))


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _vdot(a, b) / torch.clamp(torch.linalg.norm(a) * torch.linalg.norm(b), min=1e-30)


def _quantize_by_name(name: str, x: torch.Tensor, key, fmt: F.Format) -> torch.Tensor:
    if name == "rtn_absmax":
        return Q.rtn_absmax(x, fmt).values
    if name == "sr_absmax":
        return Q.sr_absmax(x, key, fmt).values
    if name == "quest":
        return Q.quest(x, fmt).values
    if name == "rtn_absmax_pma":
        return Q.rtn_absmax_pma(x, fmt).values
    raise ValueError(name)


def pma(x: torch.Tensor, quantizer: str, key: tuple[int, int], fmt: F.Format = F.MXFP4,
        num_samples: int = 64, group: int = 32) -> torch.Tensor:
    """Monte-Carlo estimate of E_ξ[1/S] for a quantizer, pre-rotated by Ĥ:
    1/S = ⟨Ĥ(X), Q(Ĥ(X))⟩ / ⟨X, X⟩ (= ⟨X, Ĥ⁻¹ Q(Ĥ X)⟩ / ⟨X, X⟩)."""
    x = x.to(torch.float32).reshape(-1)
    n = x.shape[0]
    xx = _vdot(x, x)
    inv_s = []
    for k in threefry.split(key, num_samples):
        k_sign, k_q = threefry.split(k)
        signs = threefry.rademacher(k_sign, (n,), x.device)
        xh = randomized_hadamard_transform(x, signs, g=group, dim=0)
        inv_s.append(_vdot(xh, _quantize_by_name(quantizer, xh, k_q, fmt)) / xx)
    return torch.mean(torch.stack(inv_s))


def pma_misalignment(x, quantizer, key, fmt=F.MXFP4, num_samples=64, group=32):
    """1 − E[1/S]; 0 = aligned in magnitude (unbiased)."""
    return 1.0 - pma(x, quantizer, key, fmt, num_samples, group)


def gradient_alignment_by_depth(grads_q: list[torch.Tensor],
                                grads_ref: list[torch.Tensor]) -> dict[str, list[float]]:
    """Fig. 2(a, b): per layer, the cosine similarity and the magnitude ratio
    ⟨g_q, g_ref⟩ / ⟨g_ref, g_ref⟩ of activation gradients against the
    unquantized run's."""
    cos, mag = [], []
    for gq, gr in zip(grads_q, grads_ref):
        cos.append(float(cosine_similarity(gq, gr)))
        mag.append(float(_vdot(gq, gr) / torch.clamp(_vdot(gr, gr), min=1e-30)))
    return {"cosine": cos, "magnitude": mag}
