"""Why reduced MoE training differs between the card and the CPU at step 0.

    python3 tools/moe_route_tie_probe.py [--device cpu]

``chip_smoke.py``'s ``train_moe_reduced_card_vs_cpu`` holds reduced
qwen3-moe (f32 compute, bf16 master, the 8-bit AdamW, aux weight 0.01,
Quartet linears on the kernels) on the card against the same step on the
CPU (the kernels' plain versions) from equal states, at loss, aux and nll
rtol 1e-3 and grad-norm 3e-2.  Its docstring names a cause: a token whose
two best experts nearly tie takes the other one on the card, and a
stochastic rounding flips.  This probe logs it.  From the same state and
batch (the check's step 0), it runs one train step on each device and
records every router call (its input and f32 logits, in call order: the
forward, then the forward again under remat) and every backward Stage-1
call (B2, 2-d and expert axis: its input, codes and scales).  It prints:

* the step's loss, aux, nll and grad-norm on both and their relative
  differences;
* per router call, whether its input is bit-equal on the two devices, the
  logits' max |Δ| in ulps, and each token whose selected experts differ,
  with the k-th and (k+1)-th softmax probabilities on the CPU and their
  gap in ulps (a near tie is a gap of a few ulps);
* the first B2 call whose codes differ: whether its input is bit-equal,
  how many codes and scales differ and the first differing position;
* the forward's ops in call order (the norms, rope, the dense and expert
  linears, blocked attention, the router): each op whose output differs
  between the devices although its inputs are bit-equal (the op that
  brings a difference in), with the output's max relative difference.

If no token's choice differs and no B2 code differs on equal inputs, the
difference comes from elsewhere and the probe says so.  The last line is
one JSON object.  ``--device cpu`` runs both sides on the CPU (a rehearsal:
everything equal).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

ARCH, SEED = "qwen3-moe-235b-a22b", 0


def _to_device(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(torch, v, dev) for v in tree))
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _ulps(torch, a, b):
    """|a − b| in f32 ulps (ordered bit patterns)."""
    def key(t):
        i = t.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (key(a) - key(b)).abs()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("moe_route_tie_probe.py: no CUDA device (--device cpu rehearses)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import attention as A
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import moe as TM
    from repro_torch.optim import adamw8bit, cosine_warmup
    from repro_torch.train.state import make_train_state
    from repro_torch.train.steps import make_train_step

    cfg = kernel_config(get_reduced_config(ARCH, dtype="float32"))
    k = cfg.experts_per_token
    model = build_model(cfg)
    opt = adamw8bit(cosine_warmup(1e-3, 3))
    step = make_train_step(model, opt, aux_weight=0.01)
    cpu = make_train_state(init_params(cfg, torch.Generator().manual_seed(SEED), "cpu"), opt,
                           "bfloat16")
    batch = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), 8, 64).batch(0)

    records = {}
    router = TM._router_logits
    b2, b2e = ops.sr_hadamard_quantize, ops.sr_hadamard_quantize_experts

    def rec_router(w, x):
        out = router(w, x)
        records["router"].append((x.detach().cpu(), out.detach().cpu()))
        return out

    def rec_b2(fn):
        def wrapped(x, *a, **kw):
            codes, scales = fn(x, *a, **kw)
            records["b2"].append((x.detach().cpu(), codes.cpu(), scales.cpu()))
            return codes, scales
        return wrapped

    def rec_op(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            tensors = [t.detach().cpu() for t in a if isinstance(t, torch.Tensor)]
            y = out[0] if isinstance(out, tuple) else out
            records["ops"].append((name, tensors, y.detach().cpu()))
            return out
        setattr(mod, name, wrapped)
        return mod, name, fn

    TM._router_logits = rec_router
    ops.sr_hadamard_quantize, ops.sr_hadamard_quantize_experts = rec_b2(b2), rec_b2(b2e)
    patched = [rec_op(mod, name) for mod, name in (
        (L, "rmsnorm"), (L, "rope_table"), (L, "apply_rope"), (L, "dense"),
        (L, "dense_experts"),
        (A, "blocked_attention"))]
    runs = {}
    try:
        for side, dev in (("card", args.device), ("cpu", "cpu")):
            records = runs[side] = {"router": [], "b2": [], "ops": []}
            state = _to_device(torch, cpu, dev)
            _, m = step(state, {n: torch.from_numpy(v).to(dev) for n, v in batch.items()})
            records["metrics"] = {n: float(v) for n, v in m.items()}
    finally:
        TM._router_logits = router
        ops.sr_hadamard_quantize, ops.sr_hadamard_quantize_experts = b2, b2e
        for mod, name, fn in patched:
            setattr(mod, name, fn)

    card, host = runs["card"], runs["cpu"]
    rel = {n: abs(card["metrics"][n] - host["metrics"][n]) / abs(host["metrics"][n])
           for n in ("loss", "aux", "nll", "grad_norm")}
    print(f"[step 0] card {json.dumps(card['metrics'])}")
    print(f"[step 0] cpu  {json.dumps(host['metrics'])}")
    print(f"[step 0] relative differences {json.dumps(rel)}")

    flips, first_input_diff, calls = [], None, []
    for i, ((xc, lc), (xh, lh)) in enumerate(zip(card["router"], host["router"])):
        same_in = torch.equal(xc, xh)
        if not same_in and first_input_diff is None:
            first_input_diff = i
        pc, ph = torch.softmax(lc, -1), torch.softmax(lh, -1)
        top_c = torch.sort(torch.sort(pc, dim=-1, descending=True, stable=True)[1][..., :k])[0]
        sorted_h, order_h = torch.sort(ph, dim=-1, descending=True, stable=True)
        top_h = torch.sort(order_h[..., :k])[0]
        gaps = _ulps(torch, sorted_h[..., k - 1], sorted_h[..., k])
        differ = (top_c != top_h).any(-1)
        calls.append({"call": i, "input_equal": same_in,
                      "logits_max_ulps": int(_ulps(torch, lc, lh).max()),
                      "tokens_differ": int(differ.sum()),
                      "min_gap_ulps": int(gaps.min())})
        for tok in differ.nonzero().tolist():
            t = tuple(tok)
            flips.append({"call": i, "token": list(t), "card": top_c[t].tolist(),
                          "cpu": top_h[t].tolist(),
                          "cpu_probs_k_k1": [float(sorted_h[t][k - 1]), float(sorted_h[t][k])],
                          "gap_ulps": int(gaps[t]), "input_equal": same_in})
    for c in calls:
        print(f"[router] {json.dumps(c)}")
    for f in flips:
        print(f"[router] choice differs: {json.dumps(f)}")

    first_sr = None
    for i, ((xc, cc, sc), (xh, ch, sh)) in enumerate(zip(card["b2"], host["b2"])):
        if torch.equal(cc, ch) and torch.equal(sc, sh):
            continue
        pos = (cc != ch).nonzero()
        first_sr = {"call": i, "shape": list(cc.shape), "input_equal": torch.equal(xc, xh),
                    "input_max_abs_diff": float((xc.float() - xh.float()).abs().max()),
                    "codes_differ": int((cc != ch).sum()),
                    "scales_differ": int((sc != sh).sum()),
                    "first_position": pos[0].tolist() if len(pos) else None}
        break
    print(f"[b2] calls {len(card['b2'])} / {len(host['b2'])}; first call whose codes differ: "
          f"{json.dumps(first_sr)}")
    introduced = []
    for i, ((name, ins_c, yc), (_, ins_h, yh)) in enumerate(zip(card["ops"], host["ops"])):
        if torch.equal(yc, yh) or not all(torch.equal(a, b) for a, b in zip(ins_c, ins_h)):
            continue
        d = (yc.float() - yh.float()).abs()
        introduced.append({"op": i, "name": name, "shape": list(yc.shape),
                           "max_rel": float(d.max() / yh.float().abs().max().clamp_min(1e-30)),
                           "differ": int((d > 0).sum())})
    first_diff = next((i for i, (a, b) in enumerate(zip(card["ops"], host["ops"]))
                       if not torch.equal(a[2], b[2])), None)
    print(f"[ops] {len(card['ops'])} forward ops recorded; first output that differs: op "
          f"{first_diff} ({card['ops'][first_diff][0] if first_diff is not None else '-'})")
    for r in introduced[:12]:
        print(f"[ops] differs on equal inputs: {json.dumps(r)}")
    near = [f for f in flips if f["gap_ulps"] <= 16]
    if not flips and (first_sr is None or not first_sr["input_equal"]):
        verdict = ("no routing choice differs and no SR code differs on equal inputs: the "
                   "difference comes from elsewhere (inputs differ first at router call "
                   f"{first_input_diff})")
    elif flips and len(near) == len(flips):
        verdict = f"{len(flips)} routing choice(s) differ, all at near ties (gap <= 16 ulps)"
    elif flips:
        verdict = f"{len(flips) - len(near)} routing choice(s) differ with no near tie: a fault"
    else:
        verdict = "an SR code differs on equal inputs: a fault"
    print(f"[verdict] {verdict}")
    print(json.dumps({"relative": rel, "router_calls": calls, "flips": flips,
                      "ops_introducing": introduced[:12], "first_op_difference": first_diff,
                      "first_sr_difference": first_sr, "first_router_input_difference":
                      first_input_diff, "verdict": verdict}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
