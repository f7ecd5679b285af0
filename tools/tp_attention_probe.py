"""Blocked attention over a tensor-parallel rank's KV heads against one
device's, on the card.

    python3 tools/tp_attention_probe.py [--device cpu]

For the dense-cache attention shapes of the serving steps (the VLM's self-
and cross-KV at a decode tick and a prefill chunk, qwen3-1.7b's and
qwen3-moe's gathered caches) and tp 2, 4 and 8 it prints, per rank, the
elements whose bits differ from the one-device call's head block when the
rank attends (a) over its heads alone, as ``blocked_attention`` of a head
slice, with the two einsums apart; (b) at the model's head count with
zeros in the other ranks' heads (``models.attention._tp_dense_attend``'s
layout); (c) a head at a time, with the host time of a call against the
whole call's.  On the card a batched GEMM picks its kernel by the batch
count (B·Hkv), so (a) differs there while (b) and (c) agree.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import torch  # noqa: E402

from repro_torch.models.attention import blocked_attention  # noqa: E402

SHAPES = [  # (name, B, S, T, Hkv, group, hd, causal)
    ("vlm self decode", 8, 1, 208, 8, 4, 128, True),
    ("vlm cross decode", 8, 1, 1600, 8, 4, 128, False),
    ("vlm self prefill", 1, 64, 208, 8, 4, 128, True),
    ("vlm cross prefill", 1, 64, 1600, 8, 4, 128, False),
    ("qwen3 gather decode", 8, 1, 640, 8, 2, 128, True),
    ("qwen3 gather prefill", 1, 64, 640, 8, 2, 128, True),
    ("moe gather decode", 8, 1, 640, 4, 16, 128, True),
]


def _differ(a, b) -> int:
    return int((a.view(torch.int16) != b.view(torch.int16)).sum())


def _per_head(q, k, v, pos, causal):
    hkv = k.shape[2]
    g = q.shape[2] // hkv
    return torch.cat([blocked_attention(q[:, :, h * g:(h + 1) * g], k[:, :, h:h + 1],
                                        v[:, :, h:h + 1], pos, causal, 1024)
                      for h in range(hkv)], dim=2)


def _host_ms(dev, fn, *args, reps=20):
    for _ in range(3):
        fn(*args)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    sync()
    return 1e3 * (time.perf_counter() - t) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, B, S, T, hkv, g, hd, causal in SHAPES:
        q = torch.randn((B, S, hkv * g, hd), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, T, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, T, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
        pos = (torch.arange(S, device=dev) + T - S)[None].expand(B, S).contiguous()
        full = blocked_attention(q, k, v, pos, causal, 1024)
        for tp in (2, 4, 8):
            if hkv % tp:
                continue
            hl = hkv // tp
            sliced, padded, heads = [], [], []
            for r in range(tp):
                kv, qs = slice(r * hl, (r + 1) * hl), slice(r * hl * g, (r + 1) * hl * g)
                want = full[:, :, qs]
                sliced.append(_differ(blocked_attention(q[:, :, qs], k[:, :, kv].contiguous(),
                                                        v[:, :, kv].contiguous(), pos, causal,
                                                        1024), want))
                kp, vp = torch.zeros_like(k), torch.zeros_like(v)
                kp[:, :, kv], vp[:, :, kv] = k[:, :, kv], v[:, :, kv]
                padded.append(_differ(blocked_attention(q, kp, vp, pos, causal, 1024)[:, :, qs],
                                      want))
                heads.append(_differ(_per_head(q[:, :, qs], k[:, :, kv], v[:, :, kv], pos,
                                               causal), _per_head(q, k, v, pos, causal)[:, :, qs]))
            print(f"{name} tp {tp}: bits differing a rank: head slice {sliced}, padded "
                  f"{padded}, a head at a time {heads}", flush=True)
        print(f"{name}: host ms a call, whole {_host_ms(dev, blocked_attention, q, k, v, pos, causal, 1024):.3f}, "
              f"a head at a time {_host_ms(dev, _per_head, q, k, v, pos, causal):.3f}", flush=True)


if __name__ == "__main__":
    main()
