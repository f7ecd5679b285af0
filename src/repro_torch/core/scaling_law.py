"""The paper's quantized-training scaling law (Eq. 1) and its two-stage fit.

A copy of ``repro.core.scaling_law`` (numpy only): the port imports
nothing of the reference.

    L(N, D, Pf, Pb) = ( A/(N·effN(Pf))^α + B/(D·effD(Pb))^β )^γ + E

Stage 1 fits (A, α, B, β, γ, E) on unquantized baseline runs with a Huber loss
(δ = 1e-4) on log L — identical to Busbridge et al. [8] / Appendix A.2.
Stage 2 freezes those and fits (effN, effD) per quantized method.

Also implements Ingredient 2: the speedup model (Table 1) and the optimality
regions of Fig. 1(b,c) — given a forward compute budget and a training budget,
which (Pf, Pb) pair reaches the lowest loss.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

import numpy as np

# Paper's fitted stage-1 coefficients (Table 6) — used as reference/init.
PAPER_COEFFS = dict(A=1.52e5, alpha=0.589, B=5.25e5, beta=0.544, E=1.35, gamma=0.274)

# Paper's Table 1 speedup model, relative to FP8 (FORWARD:BACKWARD labels).
SPEEDUPS = {
    ("fp4", "fp8"): dict(spfw=2.0, spbw=1.0, sptr=1.2),
    ("fp8", "fp4"): dict(spfw=1.0, spbw=2.0, sptr=1.5),
    ("fp4", "fp4"): dict(spfw=2.0, spbw=2.0, sptr=2.0),
    ("fp8", "fp8"): dict(spfw=1.0, spbw=1.0, sptr=1.0),
}


def harmonic_training_speedup(spfw: float, spbw: float) -> float:
    """sptr = harmonic mean of (spfw, spbw) with weights (1/3, 2/3)."""
    return 1.0 / ((1.0 / 3.0) / spfw + (2.0 / 3.0) / spbw)


@dataclasses.dataclass
class ScalingLaw:
    A: float
    alpha: float
    B: float
    beta: float
    E: float
    gamma: float

    def loss(self, N, D, eff_n: float = 1.0, eff_d: float = 1.0):
        N = np.asarray(N, np.float64)
        D = np.asarray(D, np.float64)
        core = self.A / (N * eff_n) ** self.alpha + self.B / (D * eff_d) ** self.beta
        return core**self.gamma + self.E

    def params(self) -> dict:
        return dataclasses.asdict(self)


def _huber(r: np.ndarray, delta: float) -> np.ndarray:
    a = np.abs(r)
    return np.where(a <= delta, 0.5 * r**2, delta * (a - 0.5 * delta))


def _objective(law: ScalingLaw, runs, eff_n=1.0, eff_d=1.0, delta=1e-4) -> float:
    pred = law.loss(runs[:, 0], runs[:, 1], eff_n, eff_d)
    r = np.log(pred) - np.log(runs[:, 2])
    return float(np.sum(_huber(r, delta)))


def _nelder_mead(f, x0: np.ndarray, iters: int = 4000, scale: float = 0.15) -> np.ndarray:
    """Dependency-free Nelder–Mead in log-ish parameter space."""
    n = len(x0)
    simplex = [x0]
    for i in range(n):
        p = x0.copy()
        p[i] = p[i] + (abs(p[i]) + 1e-3) * scale
        simplex.append(p)
    simplex = np.array(simplex)
    vals = np.array([f(p) for p in simplex])
    for _ in range(iters):
        order = np.argsort(vals)
        simplex, vals = simplex[order], vals[order]
        c = simplex[:-1].mean(axis=0)
        xr = c + (c - simplex[-1])
        fr = f(xr)
        if fr < vals[0]:
            xe = c + 2.0 * (c - simplex[-1])
            fe = f(xe)
            simplex[-1], vals[-1] = (xe, fe) if fe < fr else (xr, fr)
        elif fr < vals[-2]:
            simplex[-1], vals[-1] = xr, fr
        else:
            xc = c + 0.5 * (simplex[-1] - c)
            fc = f(xc)
            if fc < vals[-1]:
                simplex[-1], vals[-1] = xc, fc
            else:
                simplex[1:] = simplex[0] + 0.5 * (simplex[1:] - simplex[0])
                vals[1:] = [f(p) for p in simplex[1:]]
        if np.max(np.abs(vals - vals[0])) < 1e-14:
            break
    return simplex[np.argmin(vals)]


def fit_baseline(runs: Sequence[tuple[float, float, float]], init: Mapping | None = None) -> ScalingLaw:
    """Stage 1: fit (A, α, B, β, E, γ) on (N, D, loss) triples of FP runs."""
    runs = np.asarray(runs, np.float64)
    p0 = dict(PAPER_COEFFS)
    if init:
        p0.update(init)
    # parameterize A, B in log space; squash E, gamma, alpha, beta positive
    x0 = np.array([np.log(p0["A"]), p0["alpha"], np.log(p0["B"]), p0["beta"],
                   p0["E"], p0["gamma"]])

    def unpack(x):
        return ScalingLaw(A=float(np.exp(x[0])), alpha=float(abs(x[1])),
                          B=float(np.exp(x[2])), beta=float(abs(x[3])),
                          E=float(abs(x[4])), gamma=float(abs(x[5])))

    xbest = _nelder_mead(lambda x: _objective(unpack(x), runs), x0)
    return unpack(xbest)


def fit_efficiencies(
    law: ScalingLaw,
    runs: Sequence[tuple[float, float, float]],
    fit_n: bool = True,
    fit_d: bool = True,
) -> tuple[float, float]:
    """Stage 2: fit (effN, effD) ∈ (0, 1] for one quantized method."""
    runs = np.asarray(runs, np.float64)

    def unpack(x):
        en = 1.0 / (1.0 + np.exp(-x[0])) if fit_n else 1.0  # sigmoid -> (0,1)
        ed = 1.0 / (1.0 + np.exp(-x[1])) if fit_d else 1.0
        return en, ed

    def f(x):
        en, ed = unpack(x)
        return _objective(law, runs, en, ed)

    xbest = _nelder_mead(f, np.array([1.0, 1.0]), iters=2000)
    return unpack(xbest)


# ---------------------------------------------------------------------------
# Ingredient 2: optimal-precision regions under a compute budget (Fig. 1 b,c)
# ---------------------------------------------------------------------------


def effective_loss(
    law: ScalingLaw,
    N_max: float,
    D_max: float,
    eff_n: float,
    eff_d: float,
    spfw: float,
    sptr: float,
) -> float:
    """Loss(N_max·spfw, D_max·sptr/spfw, Pf, Pb) — §4.2's budgeted loss.

    A faster forward lets us serve a model `spfw×` larger at equal inference
    cost; a faster training step buys `sptr/spfw×` more data under the fixed
    training budget N·D.
    """
    return float(law.loss(N_max * spfw, D_max * sptr / spfw, eff_n, eff_d))


def optimality_region(
    law: ScalingLaw,
    methods: Mapping[str, dict],
    n_grid: np.ndarray,
    dn_ratio_grid: np.ndarray,
) -> np.ndarray:
    """For each (N, D/N) cell return the argmin method name (Fig. 1 b,c).

    ``methods``: name -> dict(eff_n, eff_d, spfw, sptr).
    """
    names = list(methods)
    out = np.empty((len(n_grid), len(dn_ratio_grid)), dtype=object)
    for i, n in enumerate(n_grid):
        for j, r in enumerate(dn_ratio_grid):
            losses = [
                effective_loss(law, n, n * r, m["eff_n"], m["eff_d"], m["spfw"], m["sptr"])
                for m in methods.values()
            ]
            out[i, j] = names[int(np.argmin(losses))]
    return out
