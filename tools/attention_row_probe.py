"""Which op makes a state-pool prefill row differ from the teacher-forced
forward's row, on the card.

    python3 tools/attention_row_probe.py [--device cpu]

A state-pool prefill chunk attends over its slot's whole cache view
(``max_len`` positions, the tail past the prompt masked), the teacher-forced
forward over the prompt's keys alone.  For the self-attention shapes of the
VLM (GQA 32/8, head dim 128), the hybrid's shared block (32/32, 112) and
whisper's decoder (6/6, 64), one [1, 64] chunk of q/k/v rows goes through
blocked attention once with the 64 prompt keys and once with a view of
``max_len`` keys whose tail holds other values.  Each op of one chunk of the
online softmax is fed equal inputs at the two widths (the former chunking:
one chunk of ``min(kv_chunk, T)`` keys) — the scores' product, the mask,
the row max, the exponentials, the row sum, the probabilities' product with
V — and the probe prints, per op, how many of the 64 rows' outputs differ
and by how much: an op that differs on equal inputs is one whose arithmetic
follows T.  Then the whole attention at both widths, with the former
chunking and with ``models.attention.blocked_attention``'s fixed chunk
width.  Last, the forward and backward of both versions timed (CUDA events,
median) at llama-paper-200m's training shape (16 x 512 tokens, 10 heads of
128, causal) and at the VLM's cross attention (1 x 64 queries over 1600
image tokens).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

# (name, Hq, Hkv, hd, view length of the state pool's slot)
CASES = (("vlm", 32, 8, 128, 144), ("hybrid", 32, 32, 112, 224), ("whisper", 6, 6, 64, 144))
S = 64


def former_blocked_attention(torch, q, k, v, q_positions, causal, kv_chunk):
    """Blocked attention as it was: chunks of min(kv_chunk, T) keys, the
    last one narrower."""
    import numpy as np

    NEG = -1e30
    B, Sq, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    ck = min(kv_chunk, T)
    qf = (q.float() * float(np.float32(1.0 / np.sqrt(hd)))).reshape(B, Sq, Hkv, g, hd)
    m = torch.full((B, Sq, Hkv, g), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Sq, Hkv, g, hd), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, ck):
        kj, vj = k[:, t0:t0 + ck].float(), v[:, t0:t0 + ck].float()
        s = torch.einsum("bskgd,bckd->bskgc", qf, kj)
        if causal:
            kv_pos = torch.arange(t0, t0 + kj.shape[1], device=q.device)
            s = torch.where(q_positions[:, :, None, None, None] >= kv_pos, s,
                            torch.full_like(s, NEG))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgc,bckd->bskgd", p, vj)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, Sq, Hq, hd).to(q.dtype)


def diff(torch, a, b) -> dict:
    a, b = a.float(), b.float()
    ne = a != b
    return {"differ": int(ne.sum()), "of": a.numel(),
            "max_abs": float((a - b).abs().max()) if ne.any() else 0.0}


def ops_at_two_widths(torch, q, k, v, pos, T):
    """Each op of one chunk fed equal inputs with 64 keys and with T keys
    (the rows past 64 masked): its 64-key outputs compared."""
    import numpy as np

    NEG = -1e30
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qf = (q.float() * float(np.float32(1.0 / np.sqrt(hd)))).reshape(B, Sq, Hkv, g, hd)
    out = {}
    s_n = torch.einsum("bskgd,bckd->bskgc", qf, k[:, :S].float())
    s_w = torch.einsum("bskgd,bckd->bskgc", qf, k.float())
    out["scores_einsum"] = diff(torch, s_n, s_w[..., :S])
    s_w = torch.cat([s_n, s_w[..., S:]], dim=-1)  # equal inputs from here on
    kv_n, kv_w = (torch.arange(n, device=q.device) for n in (S, T))
    m_n = torch.where(pos[:, :, None, None, None] >= kv_n, s_n, torch.full_like(s_n, NEG))
    m_w = torch.where(pos[:, :, None, None, None] >= kv_w, s_w, torch.full_like(s_w, NEG))
    out["mask_where"] = diff(torch, m_n, m_w[..., :S])
    mx_n, mx_w = torch.amax(m_n, dim=-1), torch.amax(m_w, dim=-1)
    out["row_amax"] = diff(torch, mx_n, mx_w)
    p_n, p_w = torch.exp(m_n - mx_n[..., None]), torch.exp(m_w - mx_n[..., None])
    out["exp"] = diff(torch, p_n, p_w[..., :S])
    out["row_sum"] = diff(torch, torch.sum(p_n, dim=-1), torch.sum(p_w, dim=-1))
    out["pv_einsum"] = diff(torch, torch.einsum("bskgc,bckd->bskgd", p_n, v[:, :S].float()),
                            torch.einsum("bskgc,bckd->bskgd", p_w, v.float()))
    return out


def timed(torch, fn, reps):
    """Median ms of ``fn`` (forward and backward) over ``reps`` CUDA-event
    timings after one warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("attention_row_probe.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.models.attention import KV_CHUNK_MAX, blocked_attention

    dev = args.device
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = []
    for name, hq, hkv, hd, T in CASES:
        q = torch.randn((1, S, hq, hd), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((1, T, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        rec = {"case": name, "heads": [hq, hkv], "hd": hd, "keys": [S, T],
               "ops_on_equal_inputs": ops_at_two_widths(torch, q, k, v, pos, T)}
        for tag, fn in (("former", lambda *a: former_blocked_attention(torch, *a)),
                        ("fixed_width", blocked_attention)):
            a = fn(q, k[:, :S], v[:, :S], pos, True, 1024)
            b = fn(q, k, v, pos, True, 1024)
            rec[f"whole_{tag}"] = diff(torch, a, b)
        print(json.dumps(rec), flush=True)
        if rec["whole_fixed_width"]["differ"]:
            failed.append(name)
    if dev == "cuda":
        for name, (B, Sq, T, hq, hkv, hd, causal) in (
                ("train llama-paper-200m", (16, 512, 512, 10, 10, 128, True)),
                ("vlm cross", (1, 64, 1600, 32, 8, 128, False))):
            q = torch.randn((B, Sq, hq, hd), generator=gen, device=dev).to(torch.bfloat16)
            k, v = (torch.randn((B, T, hkv, hd), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            leaves = [t.requires_grad_() for t in (q, k, v)]
            pos = torch.arange(Sq, dtype=torch.int32, device=dev).expand(B, Sq)
            rec = {"shape": name, "B_S_T_heads_hd": [B, Sq, T, hq, hkv, hd],
                   "kv_chunk": 1024, "fixed_width": KV_CHUNK_MAX}
            for tag, fn in (("former", lambda *a: former_blocked_attention(torch, *a)),
                            ("fixed_width", blocked_attention)):
                def fwd_bwd():
                    out = fn(q, k, v, pos, causal, 1024)
                    torch.autograd.grad(out.float().square().sum(), leaves)
                rec[f"{tag}_fwd_bwd_ms"] = timed(torch, fwd_bwd, 10)
            print(json.dumps(rec), flush=True)
    if failed:
        print(f"attention_row_probe.py: rows differ with the fixed width: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
