"""Does B6's plain version give the same bits every time on a host CPU?

    python3 tools/flash_host_probe.py [--procs 6] [--reps 40] [--ops]

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

``--cuda-test N`` runs the ``cuda`` test that once failed,
``tests/test_torch_kernels.py::test_kernels_match_plain_on_card``, N times,
each in a fresh process as the ``cuda`` tests run (``JAX_PLATFORMS=cpu``,
JAX imported by the test file, CUDA initialized, the default threads), with
a recorder around ``flash_attention_plain``:
every call's inputs and result are hashed, and the probe prints the
passes and failures and, per input, the number of distinct results.

``--ops`` cuts the plain version down to one op at a time: each of its ops
(:data:`OPS`: the scores' product, the mask, the row max, the exponentials,
the row sum, the probabilities' product with V, the final division) on
fixed inputs of its shape in the plain version's first query block,
evaluated alone in the setting that wanders (the default threads, JAX
imported, CUDA initialized where a card is present), and the whole plain
version beside them.  An op that gives more than one result there is one
whose order changes with the threads.
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


def op_inputs(np, torch):
    """Fixed f32 operands of the plain version's ops in its first query
    block: B·Hq = 8 rows of 64 queries, 64 keys, head dim 64."""
    rng = np.random.default_rng(1)
    t = {name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         for name, shape in (("q", (8, 64, 64)), ("k", (8, 64, 64)), ("v", (8, 64, 64)),
                             ("s", (8, 64, 64)), ("acc", (8, 64, 64)), ("l", (8, 64)))}
    t["l"] = t["l"].abs() + 1.0
    t["mask"] = torch.from_numpy(np.tril(np.ones((64, 64), bool)))
    return t


OPS = {
    "scores_einsum": lambda torch, t: torch.einsum("bqd,bkd->bqk", t["q"], t["k"]),
    "mask_where": lambda torch, t: torch.where(t["mask"], t["s"], torch.full_like(t["s"],
                                                                                  -1e30)),
    "row_amax": lambda torch, t: torch.amax(t["s"], dim=-1),
    "exp": lambda torch, t: torch.exp(t["s"] - torch.amax(t["s"], dim=-1, keepdim=True)),
    "row_sum": lambda torch, t: torch.sum(torch.exp(t["s"] - 3.0), dim=-1),
    "pv_einsum": lambda torch, t: torch.einsum("bqk,bkd->bqd", torch.exp(t["s"] - 3.0),
                                               t["v"]),
    "divide": lambda torch, t: t["acc"] / torch.clamp(t["l"], min=1e-30)[..., None],
}


def worker(threads: str, with_jax: bool, with_cuda: bool, reps: int, op: str = "all") -> None:
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
    if op == "all":
        def fn():
            return mha_flash(tq, tk, tv, causal=True).numpy()
    else:
        t = op_inputs(np, torch)
        first = OPS[op](torch, t).numpy()

        def fn():
            return OPS[op](torch, t).numpy()
    for _ in range(reps):
        out = fn()
        key = hashlib.sha256(out.tobytes()).hexdigest()[:16]
        seen.setdefault(key, float(np.abs(out - (ref if op == "all" else first)).max()))
    print(json.dumps({"threads": torch.get_num_threads(), "results": seen}))


def _digest(*ts) -> str:
    """A hash of tensors' dtypes and values (bf16 widened to f32 exactly)."""
    h = hashlib.sha256()
    for t in ts:
        h.update(str(t.dtype).encode())
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def recording(plain, seen: dict):
    """``plain`` (``flash_attention_plain``) wrapped: each call's result
    digest recorded in ``seen`` under its inputs' digest."""
    def recorded(q, k, v, causal=True, **kw):
        out = plain(q, k, v, causal, **kw)
        seen[_digest(q, k, v) + repr((causal, sorted(kw.items())))] = _digest(out)
        return out

    return recorded


def record_pytest(out_path: str) -> int:
    """One run of the ``cuda`` test with ``flash_attention_plain`` wrapped:
    {inputs' hash: result's hash} written to ``out_path`` as JSON."""
    import pytest

    sys.path.insert(0, SRC)
    from repro_torch.kernels import flash_attention as FA

    seen = {}
    FA.flash_attention_plain = recording(FA.flash_attention_plain, seen)
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "cuda",
                      os.path.join(os.path.dirname(HERE), "tests", "test_torch_kernels.py")
                      + "::test_kernels_match_plain_on_card"])
    with open(out_path, "w") as f:
        json.dump({"rc": int(rc), "results": seen}, f)
    return 0


def cuda_test_loop(n: int) -> int:
    """``n`` fresh runs of :func:`record_pytest`; prints the passes and
    failures and the inputs whose plain result was not always the same."""
    import tempfile

    # as the cuda tests run: the reference's JAX on the CPU
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(filter(None, [SRC, os.environ.get("PYTHONPATH")]))}
    rcs, by_input, first_failure = [], {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(n):
            path = os.path.join(tmp, f"run{i}.json")
            run = subprocess.run([sys.executable, __file__, "--record-pytest", path],
                                 capture_output=True, text=True, timeout=900, env=env)
            rec = json.load(open(path)) if os.path.exists(path) else {"rc": -1, "results": {}}
            rcs.append(rec["rc"])
            if rec["rc"] != 0 and first_failure is None:
                first_failure = (run.stdout + run.stderr)[-3000:]
            for key, res in rec["results"].items():
                by_input.setdefault(key, set()).add(res)
    print(json.dumps({"runs": n, "passed": rcs.count(0), "failed": n - rcs.count(0),
                      "rcs": rcs, "plain_calls_recorded": len(by_input),
                      "inputs_with_more_than_one_result":
                          sum(len(v) > 1 for v in by_input.values())}), flush=True)
    if first_failure:
        print(f"first failing run's output:\n{first_failure}", flush=True)
    return 0 if rcs.count(0) == n else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--ops", action="store_true",
                    help="each op of the plain version alone, in the setting that wanders")
    ap.add_argument("--worker", nargs=4, metavar=("THREADS", "JAX", "CUDA", "OP"))
    ap.add_argument("--cuda-test", type=int, default=0, metavar="N",
                    help="run the cuda test that once failed N times, recording B6's plain "
                         "results")
    ap.add_argument("--record-pytest", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.record_pytest:
        return record_pytest(args.record_pytest)
    if args.cuda_test:
        return cuda_test_loop(args.cuda_test)
    if args.worker:
        worker(args.worker[0], args.worker[1] == "1", args.worker[2] == "1", args.reps,
               args.worker[3])
        return 0
    import torch

    cuda = "1" if torch.cuda.is_available() else "0"
    if args.ops:
        settings = [("default", "1", cuda, op) for op in ("all", *OPS)]
    else:
        settings = [(t, j, "0", "all") for t in ("default", "1") for j in ("0", "1")]
        if torch.cuda.is_available():
            settings.append(("default", "1", "1", "all"))
    for threads, with_jax, with_cuda, op in settings:
        results, n_threads = {}, None
        for _ in range(args.procs):
            out = subprocess.run([sys.executable, __file__, "--reps", str(args.reps),
                                  "--worker", threads, with_jax, with_cuda, op],
                                 capture_output=True, text=True, check=True, timeout=600)
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            n_threads = rec["threads"]
            results.update(rec["results"])
        print(json.dumps({"op": op, "torch_threads": n_threads,
                          "jax_imported": with_jax == "1",
                          "cuda_initialized": with_cuda == "1",
                          "evaluations": args.procs * args.reps,
                          "distinct_results": len(results),
                          "max_abs_vs_reference": sorted(results.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
