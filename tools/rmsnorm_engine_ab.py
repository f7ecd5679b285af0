"""The serving engine's tok/s with rmsnorm's fixed summation order and with
the order it replaced, in turns, on the card.

    python3 tools/rmsnorm_engine_ab.py [--rounds 3]

``models.layers.rmsnorm`` sums a row's squares in a pairwise tree of
elementwise adds (about log2(d) launches a norm) and takes 1/√ in float64,
so a row normalizes to the same bits on the card and on the CPU.  The
version it replaced summed the row in 32-wide partials on the card
(``torch.mean`` on the CPU) and took the f32 ``rsqrt``.  This runs
``chip_smoke.py``'s engine traffic (full-width qwen3-1.7b, random weights
from seed 0, 8 requests of 128-512 prompt tokens and 32 new tokens each,
MXFP4 pool, paged backend, Quartet linears on the kernels) once to warm up
and then ``--rounds`` times in the order new, old, old, new, and prints
each run's tok/s, its median decode and prefill tick, and whether the two
versions produce the same tokens.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)


def previous_rmsnorm(torch):
    """rmsnorm as it was: 32-wide partial sums on the card, ``torch.mean``
    on the CPU, the f32 ``rsqrt``."""
    def rmsnorm(params, x, eps=1e-5):
        xf = x.to(torch.float32)
        d = xf.shape[-1]
        if xf.is_cuda and d % 32 == 0:
            part = (xf * xf).reshape(*xf.shape[:-1], d // 32, 32).sum(-1)
            var = part.sum(-1, keepdim=True) / d
        else:
            var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps)
        return (out * params["scale"].to(torch.float32)).to(x.dtype)
    return rmsnorm


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rmsnorm_engine_ab.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.serve import Engine, EngineConfig

    print(f"device: {CS.nvidia_smi_line()}", flush=True)
    cfg = kernel_config(get_config("qwen3-1.7b"))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(CS.SEED), "cuda")
    rng = np.random.default_rng(CS.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(CS.MIN_PROMPT,
                                                                CS.MAX_PROMPT + 1)))
               .astype(np.int32) for _ in range(CS.N_REQUESTS)]
    versions = {"new": L.rmsnorm, "old": previous_rmsnorm(torch)}

    def run(version: str) -> dict:
        L.rmsnorm = versions[version]
        eng = Engine(model, params, EngineConfig(
            n_slots=CS.N_SLOTS, max_len=CS.MAX_LEN, page_size=CS.PAGE_SIZE, kv_dtype="mxfp4",
            prefill_chunk=CS.PREFILL_CHUNK))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, CS.MAX_NEW, arrival_time=0.0) for p in prompts]
        ticks = {"prefill": [], "decode": []}
        while eng.sched.pending:
            kind = "prefill" if eng.sched.queue or eng.sched.prefilling() else "decode"
            s0 = time.perf_counter()
            eng.step(now=s0 - t0)
            ticks[kind].append(time.perf_counter() - s0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks = sum(len(r.tokens) for r in reqs)
        return {"version": version, "tok_per_s": toks / wall, "wall_s": wall,
                "decode_tick_ms_median": 1e3 * statistics.median(ticks["decode"]),
                "prefill_tick_ms_median": 1e3 * statistics.median(ticks["prefill"]),
                "tokens": [list(r.tokens) for r in reqs]}

    run("new")  # warm-up: first-use costs (kernel builds, allocator, library handles)
    runs = []
    for _ in range(args.rounds):
        for version in ("new", "old", "old", "new"):
            r = run(version)
            print(json.dumps({k: v for k, v in r.items() if k != "tokens"}), flush=True)
            runs.append(r)
    L.rmsnorm = versions["new"]
    out = {"device": torch.cuda.get_device_name(0), "power": CS.nvidia_smi_line(),
           "rounds": args.rounds, "order": "new, old, old, new"}
    for version in versions:
        tps = [r["tok_per_s"] for r in runs if r["version"] == version]
        dec = [r["decode_tick_ms_median"] for r in runs if r["version"] == version]
        out[version] = {"tok_per_s": tps, "tok_per_s_median": statistics.median(tps),
                        "decode_tick_ms_median": statistics.median(dec)}
    toks = {v: next(r["tokens"] for r in runs if r["version"] == v) for v in versions}
    out["same_tokens"] = toks["new"] == toks["old"]
    out["each_version_deterministic"] = all(
        r["tokens"] == toks[r["version"]] for r in runs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
