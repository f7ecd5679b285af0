"""B5's query tiles a CTA, timed at the serving shapes on the card.

    python3 tools/b5_tiles_probe.py

The paged kernel (``csrc/paged_attention.cu``) walks up to ``MAX_TILES``
16-row query tiles a CTA, which share the chunk's K/V loads, when a chunk
is one sub-block (``split_plan``).  For one layer of qwen3-1.7b (group 2)
and of qwen3-moe-235b-a22b (group 16) at a decode (S = 1), a verify (S = 5)
and a prefill chunk (S = 64), over ``chip_smoke.py``'s pools and slot
lengths, every tiles value the call can take is timed (device time: the
launch replayed from a CUDA graph, L2 flushed before each replay, median
of 15) and its output held bit-identical to the plan's own: a row's
arithmetic does not depend on the tiles.  Prints the card's name and power limit and
one JSON line; exits 1 if an output differs.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("b5_tiles_probe.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as PA

    print(CS.nvidia_smi_line())
    timer = CS.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(CS.SEED)
    plan_of = PA.split_plan
    out, same = {}, True
    try:
        for name, cfg in (("qwen3-1.7b", get_config("qwen3-1.7b")), ("moe", CS.moe_config())):
            for tag, S in (("decode", 1), ("verify", CS.SPEC_K + 1),
                           ("prefill", CS.PREFILL_CHUNK)):
                lengths = [CS.MIN_PROMPT + (CS.MAX_PROMPT + CS.MAX_NEW - CS.MIN_PROMPT) * i
                           // (CS.N_SLOTS - 1) for i in range(CS.N_SLOTS)]
                lens = [max(n - S + 1, 1) for n in lengths]
                n_pp = CS.MAX_LEN // CS.PAGE_SIZE + 1
                pool, tables = CS.make_pool(torch, cfg, [n + S - 1 for n in lens], True,
                                            torch.bfloat16, gen, "cuda", n_pp)
                q = torch.randn((CS.N_SLOTS, S, cfg.num_heads, cfg.head_dim_), generator=gen,
                                device="cuda").to(torch.bfloat16)
                ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
                plan = plan_of(S, cfg.num_heads, cfg.num_kv_heads, CS.PAGE_SIZE, n_pp)
                want = PA.paged_attention(q, pool, tables, ln)
                rec = {"plan_tiles": plan.tiles, "n_tiles": plan.n_tiles}
                for t in range(1, min(PA.MAX_TILES, plan.n_tiles) + 1):
                    PA.split_plan = lambda *a, t=t: plan_of(*a)._replace(tiles=t)
                    got = PA.paged_attention(q, pool, tables, ln)
                    rec[f"tiles_{t}_equal"] = bool(torch.equal(got, want))
                    same = same and rec[f"tiles_{t}_equal"]
                    rec[f"tiles_{t}_device_ms"] = timer.device(
                        lambda: PA.paged_attention(q, pool, tables, ln))
                    PA.split_plan = plan_of
                out[f"{name} {tag}"] = rec
    finally:
        PA.split_plan = plan_of
    print(json.dumps(out))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
