"""Table 2 on the port: the error-bias trade-off of the quantizer schemes.

The twin of ``benchmarks/table2_quantizer_metrics.py``: per scheme the
relative MSE on Gaussian data and the PMA misalignment 1 − E[1/S], beside
the paper's values, and the headline ordering QuEST < RTN < SR in MSE.
The data are numpy Gaussians from seeds 0 and 1 (the original draws them
with ``jax.random.normal``); the keys are the original's.

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_quantizer_metrics [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import metrics as M
from repro_torch.core import quantizers as Q
from repro_torch.core import threefry

PAPER = {  # (MSE, misalignment) from Table 2
    "sr_absmax": (2.84e-2, 0.0),
    "rtn_absmax": (1.40e-2, 9.3e-3),
    "quest": (1.35e-2, 1.3e-2),
    "rtn_absmax_pma": (1.42e-2, 2.8e-5),
}


def _quantize(name: str, x: torch.Tensor, key) -> Q.QuantResult:
    if name == "sr_absmax":
        return Q.sr_absmax(x, key)
    if name == "rtn_absmax":
        return Q.rtn_absmax(x)
    if name == "quest":
        return Q.quest(x)
    return Q.rtn_absmax_pma(x)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(device="cuda", rows: int = 2048, flat: int = 8192, num_samples: int = 48) -> list[tuple]:
    """The original's rows: (name, microseconds, value beside the paper's)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((rows, 32))
                         .astype(np.float32)).to(device)
    xflat = torch.from_numpy(np.random.default_rng(1).standard_normal(flat)
                             .astype(np.float32)).to(device)
    out = []
    for name in PAPER:
        _sync(device)
        t0 = time.perf_counter()
        r = _quantize(name, x, threefry.prng_key(2))
        mse = float(torch.mean((r.values - x) ** 2) / torch.mean(x ** 2))
        mis = float(M.pma_misalignment(xflat, name, threefry.prng_key(3),
                                       num_samples=num_samples))
        us = (time.perf_counter() - t0) * 1e6
        out.append((f"table2/{name}/mse", us, f"{mse:.3e} (paper {PAPER[name][0]:.2e})"))
        out.append((f"table2/{name}/misalignment", us,
                    f"{mis:.3e} (paper {PAPER[name][1]:.1e})"))
    # the headline ordering must reproduce
    m = {n: float(torch.mean((q.values - x) ** 2)) for n, q in [
        ("quest", Q.quest(x)), ("rtn", Q.rtn_absmax(x)),
        ("sr", Q.sr_absmax(x, threefry.prng_key(4)))]}
    ok = m["quest"] < m["rtn"] < m["sr"]
    out.append(("table2/ordering_quest<rtn<sr", 0.0, "PASS" if ok else "FAIL"))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    for row in run(args.device):
        print(*row, sep="\t")
