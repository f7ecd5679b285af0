"""Figure 1 on the port: the scaling-law fit and the FP4/FP8 optimality
regions.

The twin of ``benchmarks/fig1_scaling_law.py`` over the port's copy of the
scaling law (numpy only, so it runs on the host whatever the device):
(a) the stage-1 and stage-2 fits recover the paper's coefficients (Table 6)
from points on their own surface; (b, c) the optimality regions under the
Table-1 speedup model with the paper's efficiencies (effN 0.64, effD 0.94):
the FP4-forward region grows when the backward drops from FP8 to FP4.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig1_scaling_law
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.scaling_law import (
    PAPER_COEFFS,
    SPEEDUPS,
    ScalingLaw,
    fit_baseline,
    fit_efficiencies,
    optimality_region,
)


def run(grid: int = 24) -> list[tuple]:
    """The original's rows over a ``grid`` × ``grid`` region (24 there)."""
    rows = []
    law = ScalingLaw(**PAPER_COEFFS)

    # (a) fit recovery on the paper-coefficient surface
    t0 = time.perf_counter()
    runs = [(n, n * r, float(law.loss(n, n * r)))
            for n in [30e6, 50e6, 100e6, 200e6]
            for r in [25, 50, 100, 200, 400, 800]]
    fitted = fit_baseline(runs)
    err = max(abs(fitted.loss(n, d) - l) / l for n, d, l in runs)
    rows.append(("fig1a/stage1_fit_max_rel_err", (time.perf_counter() - t0) * 1e6,
                 f"{err:.2e}"))

    t0 = time.perf_counter()
    qruns = [(n, n * r, float(law.loss(n, n * r, 0.64, 0.94)))
             for n in [30e6, 100e6] for r in [25, 100, 400, 800]]
    en, ed = fit_efficiencies(law, qruns)
    rows.append(("fig1a/stage2_effN_effD", (time.perf_counter() - t0) * 1e6,
                 f"effN={en:.3f} effD={ed:.3f} (paper 0.64/0.94)"))

    # (b, c) optimality regions
    def region(backward):
        methods = {}
        for fwd in ("fp4", "fp8"):
            sp = SPEEDUPS[(fwd, backward)]
            methods[fwd] = dict(
                eff_n=0.64 if fwd == "fp4" else 1.0,
                eff_d=(0.94 if fwd == "fp4" else 1.0) if backward == "fp4" else 1.0,
                spfw=sp["spfw"], sptr=sp["sptr"])
        ns = np.logspace(8, 11.5, grid)  # 100M .. 300B params
        rs = np.logspace(1, 3.3, grid)  # D/N 10 .. 2000
        return optimality_region(law, methods, ns, rs), ns, rs

    r8, ns, rs = region("fp8")
    r4, _, _ = region("fp4")
    f8 = float((r8 == "fp4").mean())
    f4 = float((r4 == "fp4").mean())
    rows.append(("fig1b/fp4_region_frac_fp8bwd", 0.0, f"{f8:.3f}"))
    rows.append(("fig1c/fp4_region_frac_fp4bwd", 0.0, f"{f4:.3f}"))
    rows.append(("fig1c/region_grows_with_fp4_bwd", 0.0, "PASS" if f4 > f8 else "FAIL"))
    # a Llama-3-8B-class point: N = 8e9, D/N ~ 2000, inside the FP4 regime
    i = int(np.argmin(abs(ns - 8e9)))
    j = len(rs) - 1
    rows.append(("fig1c/llama3_8b_class_point", 0.0,
                 f"optimal={r4[i, j]} at N=8e9, D/N~2000"))
    return rows


if __name__ == "__main__":
    for row in run():
        print(*row, sep="\t")
