"""Whether the draft proposer's cache holds the target cache's bits, on the card.

    python3 tools/draft_sync_probe.py
    python3 tools/draft_sync_probe.py --reduced --device cpu   # a rehearsal

The features phase's ``draft`` case of ``chip_smoke.py``: full-width
qwen3-1.7b (random weights from seed 0, Quartet linears on the kernels,
MXFP4 pools), the draft proposer with the target's own weights (the same
arch at the same seed), k = 4, the engine phase's 8 prompts, 32 new tokens
each.  After every ``_sync_all`` the draft pool's pages are compared with the
target pool's, position by position, for every decoding slot over the
positions the draft holds as synced.  The draft syncs through ``prefill_all``
chunks (``serve/spec/proposers.py``) what the target wrote through decode
and verify steps, so the pages agree only while the paged kernel's per-row
arithmetic does not depend on the call's row count
(``kernels.paged_attention.split_plan``).

It prints the acceptance, the syncs and positions compared, and the first
differing (request, position, layer, leaf), with whether the position lies in
the prompt or among the generated tokens.  For that position the run is
repeated with every model op (norms, rope, the Quartet linears, paged
attention, the head) recorded for its row in the call that wrote it on each
side (the draft's sync or draft step, the target's prefill or verify), and
the probe names the first op whose output differs although its inputs are
equal, and its layer.  One JSON line; about a minute of command time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

OPS_PER_LAYER = 14  # attn norm, q k v, q/k norms, 2 ropes, attention, o, mlp norm, 3 mlp


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="reduced qwen3-1.7b, short prompts (a rehearsal of the probe)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("draft_sync_probe.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import attention as A
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.serve import Engine, EngineConfig, SpecConfig
    from repro_torch.serve.spec import aggregate_stats

    dev, B, k = args.device, 8, 4
    ps, chunk, max_len, max_new, lens = ((4, 8, 64, 8, (16, 41)) if args.reduced
                                         else (16, 64, 640, 32, (128, 513)))
    cfg = kernel_config(get_reduced_config("qwen3-1.7b") if args.reduced
                        else get_config("qwen3-1.7b"))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(*lens))).astype(np.int32)
               for _ in range(B)]
    spec = SpecConfig(k=k, proposer="draft", draft_arch="qwen3-1.7b",
                      draft_reduced=args.reduced, draft_seed=0)
    sync_device = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    def engine():
        eng = Engine(model, params, EngineConfig(n_slots=B, max_len=max_len, page_size=ps,
                                                 kv_dtype="mxfp4", prefill_chunk=chunk,
                                                 spec=spec))
        return eng, eng.proposer

    def compare(eng, prop, decoding):
        """The first (position, layer, leaf) whose draft pages differ from the
        target's, by request, over each slot's synced positions."""
        found = {}
        for r in decoding:
            n = int(prop.synced[r.slot])
            pos = torch.arange(n, device=dev)
            pt = torch.from_numpy(eng.cache.tables[r.slot]).to(dev)[pos // ps].long()
            pd = torch.from_numpy(prop.cache.tables[r.slot]).to(dev)[pos // ps].long()
            for leaf, v in eng.cache.pool.items():
                x, y = v[:, pt, pos % ps], prop.cache.pool[leaf][:, pd, pos % ps]
                diff = (x != y).reshape(x.shape[0], n, -1).any(-1)  # [L, positions]
                if diff.any():
                    q, layer = (int(i) for i in torch.nonzero(diff.T)[0])
                    if r.rid not in found or q < found[r.rid][0]:
                        found[r.rid] = (q, layer, leaf)
        return found

    out = {"device": torch.cuda.get_device_name(0) if dev == "cuda" else "cpu",
           "arch": cfg.name, "layers": cfg.num_layers}
    eng, prop = engine()
    stats = {"syncs": 0, "positions_compared": 0, "first": None}
    base_sync = prop._sync_all

    def checked_sync(decoding):
        base_sync(decoding)
        sync_device()
        stats["syncs"] += 1
        stats["positions_compared"] += sum(int(prop.synced[r.slot]) for r in decoding)
        if stats["first"] is None:
            found = compare(eng, prop, decoding)
            if found:
                rid, (q, layer, leaf) = min(found.items(), key=lambda kv: kv[1][0])
                req = next(r for r in decoding if r.rid == rid)
                stats["first"] = {"request": rid, "slot": req.slot, "position": q,
                                  "layer": layer, "leaf": leaf, "sync": stats["syncs"],
                                  "in": "prompt" if q < req.prompt_len else "generated",
                                  "prompt_len": req.prompt_len}

    prop._sync_all = checked_sync
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.drain()
    agg = aggregate_stats(reqs)
    out.update(stats, acceptance=agg["acceptance_rate"],
               tokens_per_verify_call=agg["tokens_per_decode_call"])
    del eng, prop
    if dev == "cuda":
        torch.cuda.empty_cache()
    if stats["first"] is not None:
        out["ops_at_first_difference"] = trace(engine, stats["first"], prompts, max_new,
                                               torch, L, A)
    print(json.dumps(out))
    return 0


def trace(engine, first, prompts, max_new, torch, L, A):
    """Run the engine again; record every op for the first differing
    position's row in the last call that wrote it on each side, and name the
    ops whose output differs between the two."""
    slot, q = first["slot"], first["position"]
    eng, prop = engine()
    state = {"row": None, "record": []}
    last = {}

    def hook(side, kind, fn):
        def hooked(params_, tokens, start, *rest):
            st, m = int(start[slot]), bool(rest[-1][slot])
            state["row"] = q - st if m and st <= q < st + tokens.shape[1] else None
            state["record"] = []
            res = fn(params_, tokens, start, *rest)
            if state["row"] is not None:
                last[side] = (kind, state["record"])
            state["row"] = None
            return res
        return hooked

    for side, owner in (("target", eng), ("draft", prop)):
        st = owner._steps
        owner._steps = st._replace(**{kind: hook(side, kind, getattr(st, kind))
                                      for kind in ("decode_all", "prefill_all", "verify_all")})
    originals = {}

    def wrap(mod, name):
        f = getattr(mod, name)

        def rec(*args, **kw):
            res = f(*args, **kw)
            if state["row"] is not None:
                x = args[1] if name in ("dense", "rmsnorm", "unembed") else args[0]
                y = res[0] if isinstance(res, tuple) else res
                r = state["row"] if x.dim() > 2 and x.shape[1] > 1 else 0
                state["record"].append((name, x[slot, r].float().cpu(), y[slot, r].float().cpu()))
            return res
        setattr(mod, name, rec)
        originals[(mod, name)] = f

    for mod, name in ((L, "dense"), (L, "rmsnorm"), (L, "apply_rope"), (L, "unembed"),
                      (A, "paged_attention")):
        wrap(mod, name)
    try:
        for p in prompts:
            eng.submit(p, max_new)
        eng.drain()
    finally:
        for (mod, name), f in originals.items():
            setattr(mod, name, f)
    (kt, rt), (kd, rd) = last["target"], last["draft"]
    diffs = []
    for i, ((name, xt, yt), (_, xd, yd)) in enumerate(zip(rt, rd)):
        if not torch.equal(yt, yd):
            diffs.append({"call": i, "layer": i // OPS_PER_LAYER, "op": name,
                          "inputs_equal": bool(torch.equal(xt, xd)),
                          "max_abs": float((yt - yd).abs().max())})
    introduced = next((d for d in diffs if d["inputs_equal"]), None)
    return {"target_call": kt, "draft_call": kd, "ops_recorded": [len(rt), len(rd)],
            "first_op_differing_on_equal_inputs": introduced, "first_differing_ops": diffs[:4]}


if __name__ == "__main__":
    sys.exit(main())
