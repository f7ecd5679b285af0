"""Which op makes a speculative verify row differ from the decode row of the
same token, on the card.

    python3 tools/verify_row_probe.py

Full-width qwen3-1.7b (random weights from seed 0, Quartet linears on the
kernels, MXFP4 pool): the 8 prompts of ``chip_smoke.py``'s engine phase are
prefilled with ``prefill_all``; then, each on its own copy of the pool, one
``decode_all`` call (S = 1) and two verifies of S = 5 (the same token at
the same position in row 0, four more after it): the engine's
``verify_all``, which applies the head one ``[B, 1]`` column at a time, and
``make_verify_step``'s forward, which applies it to all ``[B, 5]`` rows at
once.  Row 0 of a verify sees exactly the decode row's inputs, so any
difference in its logits comes from an op whose arithmetic depends on the
call's shape.  Every call of the model's ops (the norms, rope, the Quartet
linears, paged attention, the tied head) is recorded for row 0, and the
probe prints, for each verify, the ops whose output differs although their
inputs are equal — the ops that introduce the difference — and the logits'
max |Δ| and argmax agreement.  Then, beside it, the whole burst: the
verify's rows s = 0..4 against five sequential decode steps over the same
tokens (each the previous step's argmax), on the verify's table (41 pages:
``MAX_LEN + k`` positions) and on the non-speculative engine's (40 pages);
slot 3 decoded (and verified) alone, the other lanes masked, against the
same call with every lane active; and the engines themselves, non-spec and
self-spec on the 8 requests, each slot's K/V compared at retirement up to
the first token where the two streams part.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("verify_row_probe.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import attention as A
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.serve.paged_cache import PagedCache, PagedKV, reservation_sizing
    from repro_torch.serve.steps import build_paged_steps, marshal_prefill_batch
    from repro_torch.train.serve import make_verify_step

    dev, B, ps, chunk, k = "cuda", 8, 16, 64, 4
    cfg = kernel_config(get_config("qwen3-1.7b"))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(128, 513))).astype(np.int32)
               for _ in range(B)]
    pps, n_pages = reservation_sizing(B, 640, ps, k)
    cache = PagedCache(cfg, n_slots=B, pages_per_slot=pps, page_size=ps, n_pages=n_pages,
                       kv_dtype="mxfp4", device=dev)
    for b, p in enumerate(prompts):
        cache.alloc(b, p.size + 32)
    steps = build_paged_steps(model, method="quartet", page_size=ps)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    tables = t(cache.tables)
    pos = [0] * B
    while any(pos[b] < p.size for b, p in enumerate(prompts)):
        items = [(b, pos[b], p[pos[b]:pos[b] + chunk]) for b, p in enumerate(prompts)
                 if pos[b] < p.size]
        toks, start, n_valid, mask = marshal_prefill_batch(B, chunk, items)
        logits = steps.prefill_all(params, t(toks), t(start), t(n_valid), cache.pool, tables,
                                   t(mask))
        for b, s0, x in items:
            pos[b] = s0 + len(x)
    first = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
    position = np.asarray([p.size for p in prompts], np.int32)
    mask = np.ones((B,), bool)

    record: list = []

    def wrap(mod, name):
        fn = getattr(mod, name)

        def rec(*args, **kw):
            out = fn(*args, **kw)
            x = args[1] if name in ("dense", "rmsnorm", "unembed") else args[0]
            y = out[0] if isinstance(out, tuple) else out
            record.append((name, x.reshape(B, -1, *x.shape[2:])[:, :1].float().cpu()
                           if x.dim() > 2 else x.float().cpu(),
                           y.reshape(B, -1, *y.shape[2:])[:, :1].float().cpu()
                           if y.dim() > 2 else y.float().cpu()))
            return out
        setattr(mod, name, rec)
        return fn

    def run(call):
        pool = {n: v.clone() for n, v in cache.pool.items()}
        record.clear()
        with torch.inference_mode():
            out = call(pool)
        torch.cuda.synchronize()
        return out, list(record)

    originals = [(mod, name, wrap(mod, name)) for mod, name in (
        (L, "dense"), (L, "rmsnorm"), (L, "apply_rope"), (L, "unembed"),
        (A, "paged_attention"))]
    dec, rec_d = run(lambda pool: steps.decode_all(
        params, t(first[:, None]), t(position), pool, tables, t(mask)))
    drafts = t(np.repeat(first[:, None], k + 1, axis=1))
    joint_verify = make_verify_step(model, method="quartet")
    runs = {"verify_all (head by column)": run(lambda pool: steps.verify_all(
                params, drafts, t(position), pool, tables, t(mask))),
            "joint head over [B, 5]": run(lambda pool: joint_verify(
                params, drafts, t(position), PagedKV(pool, tables))[0])}
    for mod, name, fn in originals:
        setattr(mod, name, fn)

    out = {"device": torch.cuda.get_device_name(0), "ops_recorded": len(rec_d)}
    for tag, (ver, rec_v) in runs.items():
        introduced = {}
        for i, ((name, xd, yd), (_, xv, yv)) in enumerate(zip(rec_d, rec_v)):
            if not torch.equal(yd, yv) and torch.equal(xd, xv):
                introduced.setdefault(name, []).append((i, float((yd - yv).abs().max())))
        ld, lv = dec.float(), ver[:, 0].float()
        out[tag] = {
            # the by-column head calls the norm and the head once a column
            "decode_ops_lead_its_ops": ([n for n, _, _ in rec_d]
                                        == [n for n, _, _ in rec_v][:len(rec_d)]),
            "ops_that_introduce_a_difference": {
                n: {"calls": len(v), "first_call": v[0][0], "max_abs": max(d for _, d in v)}
                for n, v in introduced.items()},
            "logits_max_abs": float((ld - lv).abs().max()),
            "argmax_equal": (ld.argmax(-1) == lv.argmax(-1)).tolist()}

    # the burst: sequential decodes vs one verify, tables of 41 and 40 pages
    def decode_burst(tbl):
        pool = {n: v.clone() for n, v in cache.pool.items()}
        cur, rows = first.copy(), []
        with torch.inference_mode():
            for s in range(k + 1):
                lg = steps.decode_all(params, t(cur[:, None]), t(position + s), pool, tbl,
                                      t(mask))
                rows.append(lg.float())
                cur = torch.argmax(lg, -1).to(torch.int32).cpu().numpy()
        return torch.stack(rows, 1), pool

    seq41, pool41 = decode_burst(tables)
    seq40, pool40 = decode_burst(tables[:, :-1].contiguous())
    burst = torch.cat([t(first[:, None]), seq41[:, :-1].argmax(-1).to(torch.int32)], 1)
    pool = {n: v.clone() for n, v in cache.pool.items()}
    with torch.inference_mode():
        ver = steps.verify_all(params, burst, t(position), pool, tables, t(mask)).float()
    out["burst"] = {
        "verify_vs_decode_41_max_abs_by_row": [float((ver[:, s] - seq41[:, s]).abs().max())
                                               for s in range(k + 1)],
        "verify_vs_decode_41_argmax_equal_by_row": [
            bool((ver[:, s].argmax(-1) == seq41[:, s].argmax(-1)).all()) for s in range(k + 1)],
        "decode_40_vs_41_max_abs_by_step": [float((seq40[:, s] - seq41[:, s]).abs().max())
                                            for s in range(k + 1)],
        "pool_after_verify_equals_decodes_41": all(
            torch.equal(pool[n], pool41[n]) for n in pool),
        "pool_after_decodes_40_equals_41": all(
            torch.equal(pool40[n], pool41[n]) for n in pool)}

    # other lanes masked: slot 3 alone against all 8 slots active, for a
    # decode and for a verify; the ops recorded for slot 3's row 0
    def lanes(call_with_mask):
        res = {}
        wrapped = [(mod, name, wrap(mod, name)) for mod, name in (
            (L, "dense"), (L, "rmsnorm"), (L, "apply_rope"), (L, "unembed"),
            (A, "paged_attention"))]
        for tag, m in (("all", mask), ("alone", np.arange(B) == 3)):
            res[tag] = run(lambda pool, m=m: call_with_mask(pool, t(m)))
        for mod, name, fn in wrapped:
            setattr(mod, name, fn)
        (la, ra), (lb, rb) = res["all"], res["alone"]
        introduced = {}
        for i, ((name, xa, ya), (_, xb, yb)) in enumerate(zip(ra, rb)):
            if not torch.equal(ya[3], yb[3]) and torch.equal(xa[3], xb[3]):
                introduced.setdefault(name, []).append(
                    (i, float((ya[3] - yb[3]).abs().max())))
        la, lb = la.float()[3], lb.float()[3]
        return {"logits_max_abs": float((la - lb).abs().max()),
                "ops_that_introduce_a_difference": {
                    n: {"calls": len(v), "first_call": v[0][0], "max_abs": max(d for _, d in v)}
                    for n, v in introduced.items()}}

    out["slot 3 alone vs all lanes"] = {
        "decode": lanes(lambda pool, m: steps.decode_all(
            params, t(first[:, None]), t(position), pool, tables, m)),
        "verify": lanes(lambda pool, m: steps.verify_all(
            params, burst, t(position), pool, tables, m))}

    # the engines themselves: the 8 requests x 32 tokens, non-spec and
    # self-spec (k = 4); each slot's K/V snapshotted at retirement; the first
    # consumed position whose K/V differ between the two, by request
    from repro_torch.serve import Engine, EngineConfig, SpecConfig

    def engine(spec):
        eng = Engine(model, params, EngineConfig(n_slots=B, max_len=640, page_size=ps,
                                                 kv_dtype="mxfp4", prefill_chunk=chunk,
                                                 spec=spec))
        snaps, free, reqs = {}, eng.cache.free, []

        def snapshot_then_free(slot):
            req = next(r for r in reqs if r.slot == slot and r.done and r.rid not in snaps)
            n = req.prompt_len + len(req.tokens) - 1  # consumed positions
            pos_ = torch.arange(n, device=dev)
            pages = t(eng.cache.tables[slot])[pos_ // ps].long()
            snaps[req.rid] = {leaf: v[:, pages, pos_ % ps].cpu() for leaf, v in
                              eng.cache.pool.items()}
            free(slot)

        eng.cache.free = snapshot_then_free
        reqs += [eng.submit(p, 32) for p in prompts]
        eng.drain()
        return reqs, snaps

    (ra, sa), (rb, sb) = engine(None), engine(SpecConfig(k=k, proposer="self"))
    first_kv = {}
    for a, b in zip(ra, rb):
        div = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y), None)
        n = a.prompt_len + (len(a.tokens) - 1 if div is None else div)
        bad = None
        for leaf in sa[a.rid]:
            x, y = sa[a.rid][leaf][:, :n], sb[b.rid][leaf][:, :n]
            diff = (x != y).reshape(x.shape[0], n, -1).any(-1)  # [L, positions]
            if diff.any():
                layer, q = (int(i) for i in torch.nonzero(diff.T)[0].flip(0))
                if bad is None or q < bad[0]:
                    bad = (q, layer, leaf)
        first_kv[a.rid] = {"prompt": a.prompt_len, "token_divergence": div,
                           "first_kv_difference (position, layer, leaf)": bad}
    out["engines: first K/V difference"] = first_kv
    out["engines: first K/V difference"] = first_kv

    # the first such position, again: every op of the call that wrote its
    # K/V last (the non-spec engine's decode, the spec engine's verify)
    # recorded for that row, and the ops whose output differs although their
    # inputs are equal
    hits = [(v["first_kv_difference (position, layer, leaf)"][0], int(r))
            for r, v in first_kv.items() if v["first_kv_difference (position, layer, leaf)"]]
    if hits:
        q, rid = min(hits)
        slot = rid  # 8 requests admitted at once into slots 0..7

        def traced(spec, kind):
            eng = Engine(model, params, EngineConfig(n_slots=B, max_len=640, page_size=ps,
                                                     kv_dtype="mxfp4", prefill_chunk=chunk,
                                                     spec=spec))
            target = {"row": None}
            calls = []
            fn = getattr(eng._steps, kind)

            def hooked(params_, tokens, start, *rest):
                st, m = int(start[slot]), bool(rest[-1][slot])
                target["row"] = q - st if m and st <= q < st + tokens.shape[1] else None
                record.clear()
                res = fn(params_, tokens, start, *rest)
                if target["row"] is not None:
                    calls.append([(n, x[slot].clone(), y[slot].clone()) for n, x, y in record])
                target["row"] = None
                return res

            eng._steps = eng._steps._replace(**{kind: hooked})
            row_of = {}

            def wrap_row(mod, name):
                f = getattr(mod, name)

                def rec(*args, **kw):
                    res = f(*args, **kw)
                    if target["row"] is not None:
                        x = args[1] if name in ("dense", "rmsnorm", "unembed") else args[0]
                        y = res[0] if isinstance(res, tuple) else res
                        r = target["row"] if x.dim() > 2 and x.shape[1] > 1 else 0
                        record.append((name, x[:, r].float().cpu(), y[:, r].float().cpu()))
                    return res
                setattr(mod, name, rec)
                row_of[(mod, name)] = f

            for mod, name in ((L, "dense"), (L, "rmsnorm"), (L, "apply_rope"), (L, "unembed"),
                              (A, "paged_attention")):
                wrap_row(mod, name)
            for p in prompts:
                eng.submit(p, 32)
            eng.drain()
            for (mod, name), f in row_of.items():
                setattr(mod, name, f)
            return calls[-1]

        rd, rv = traced(None, "decode_all"), traced(SpecConfig(k=k, proposer="self"), "verify_all")
        ops_diff = []
        for i, ((name, xd, yd), (_, xv, yv)) in enumerate(zip(rd, rv)):
            if not torch.equal(yd, yv):
                ops_diff.append({"call": i, "layer": i // 14, "op": name,
                                 "inputs_equal": bool(torch.equal(xd, xv)),
                                 "max_abs": float((yd - yv).abs().max())})
        out["engines: ops at the first differing K/V"] = {
            "request": rid, "position": q, "ops_recorded": len(rd),
            "first_differing_ops": ops_diff[:6]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
