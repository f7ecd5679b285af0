"""Does B6's plain version give the same bits every time on a host CPU?

    python3 tools/flash_host_probe.py [--procs 6] [--reps 40]

Evaluates ``flash_attention_plain`` (through ``mha_flash`` on CPU tensors)
on one fixed f32 input (2 x 130 queries, GQA 4/2, head dim 64, causal: the
case of the ``cuda`` test that once failed) ``--reps`` times in each of
``--procs`` fresh processes, under five settings: one torch thread or the
default, with or without JAX imported (and run once) before the
evaluations, and, as the ``cuda`` test ran it, the default threads with JAX
imported and CUDA initialized (one product on the card first) where a card
is present.  Prints, per setting, the number of distinct results (by their
bytes) and each one's max |Δ| from a float64 evaluation of the same
attention.  The evaluations run on the CPU; JAX is imported only in the
settings that ask for it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def inputs(np):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 130, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 130, 2, 64)).astype(np.float32) for _ in range(2))
    return q, k, v


def attention_f64(np, q, k, v):
    """Causal GQA softmax attention in float64 over [B, S, H, hd]."""
    q, k, v = (t.astype(np.float64) for t in (q, k, v))
    k, v = (np.repeat(t, q.shape[2] // t.shape[2], axis=2) for t in (k, v))
    s = np.einsum("bshd,bthd->bhst", q, k) / np.sqrt(q.shape[-1])
    s = np.where(np.triu(np.ones(s.shape[-2:], bool), 1), -np.inf, s)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhst,bthd->bshd", p / p.sum(-1, keepdims=True), v)


def worker(threads: str, with_jax: bool, with_cuda: bool, reps: int) -> None:
    import numpy as np

    if with_jax:
        import jax.numpy as jnp

        float(jnp.ones(8).sum())  # start its runtime and thread pools
    sys.path.insert(0, SRC)
    import torch

    if with_cuda:
        a = torch.ones((256, 256), device="cuda")
        float((a @ a).sum())

    from repro_torch.kernels.flash_attention import mha_flash

    if threads == "1":
        torch.set_num_threads(1)
    q, k, v = inputs(np)
    ref = attention_f64(np, q, k, v)
    seen = {}
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for _ in range(reps):
        out = mha_flash(tq, tk, tv, causal=True).numpy()
        key = hashlib.sha256(out.tobytes()).hexdigest()[:16]
        seen.setdefault(key, float(np.abs(out - ref).max()))
    print(json.dumps({"threads": torch.get_num_threads(), "results": seen}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--worker", nargs=3, metavar=("THREADS", "JAX", "CUDA"))
    args = ap.parse_args()
    if args.worker:
        worker(args.worker[0], args.worker[1] == "1", args.worker[2] == "1", args.reps)
        return 0
    import torch

    settings = [(t, j, "0") for t in ("default", "1") for j in ("0", "1")]
    if torch.cuda.is_available():
        settings.append(("default", "1", "1"))
    for threads, with_jax, with_cuda in settings:
        results, n_threads = {}, None
        for _ in range(args.procs):
            out = subprocess.run([sys.executable, __file__, "--reps", str(args.reps),
                                  "--worker", threads, with_jax, with_cuda],
                                 capture_output=True, text=True, check=True, timeout=600)
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            n_threads = rec["threads"]
            results.update(rec["results"])
        print(json.dumps({"torch_threads": n_threads, "jax_imported": with_jax == "1",
                          "cuda_initialized": with_cuda == "1",
                          "evaluations": args.procs * args.reps,
                          "distinct_results": len(results),
                          "max_abs_vs_float64": sorted(results.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
