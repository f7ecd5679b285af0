"""The ops of a llama-paper-200m training step on B rows against the same
ops on their first B/n rows, on the card.

    python3 tools/dp_row_probe.py

A data-parallel rank runs every op of the step on its B/n rows of a
microbatch of B; its layers see one device's bits only if each op rounds
a row alike at either row count.  For rmsnorm, blocked attention, the
SwiGLU MLP and a whole layer (Quartet linears on the kernels), the grouped
Hadamard and the bf16 LM head (its dx over the 32000-long vocabulary at
full size), it prints whether the forward output and the backward's dx of
the first rows are bit for bit equal at B = 16 and B = 4 rows of 512.
"""

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.core.hadamard import hadamard_transform
    from repro_torch.kernels import _build
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import layers as L
    from repro_torch.models.attention import attention
    from repro_torch.models.transformer import dense_block, layer_slice, mlp

    _build.build_all()
    dev = "cuda"
    cfg = kernel_config(dataclasses.replace(get_config("llama-paper-200m"), num_layers=1))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    B, b, S, D = 16, 4, 512, cfg.d_model
    x = torch.randn((B, S, D), generator=g, device=dev).to(torch.bfloat16)
    dy = (torch.randn((B, S, D), generator=g, device=dev) * 1e-3).to(torch.bfloat16)
    lp = layer_slice(params["layers"], 0)
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    rope = L.rope_table(pos, cfg.head_dim_, cfg.rope_theta)
    _, norm = L.make_norm(cfg.norm)

    def rows(r):
        return pos[:r], (rope[0][:r], rope[1][:r])

    def fwd_bwd(fn, r, grad):
        xs = x[:r].clone().requires_grad_()
        out = fn(xs, r)
        return out.detach(), torch.autograd.grad(out, xs, grad[:r])[0]

    ops = {
        "rmsnorm": lambda xs, r: norm(lp["attn_norm"], xs, 1e-5),
        "attention": lambda xs, r: attention(lp["attn"], xs, rows(r)[0], 7, cfg, causal=True,
                                             rope=rows(r)[1])[0],
        "mlp": lambda xs, r: mlp(lp["mlp"], xs, 9, cfg),
        "hadamard": lambda xs, r: hadamard_transform(xs.float(), 32, -1),
        "layer": lambda xs, r: dense_block(lp, xs, rows(r)[0], 5, cfg, None, "quartet", None,
                                           None, rows(r)[1])[0],
    }
    out = {}
    for name, fn in ops.items():
        ya, da = fwd_bwd(fn, B, dy)
        yb, db = fwd_bwd(fn, b, dy)
        out[name] = {"fwd_equal": bool(torch.equal(ya[:b], yb)),
                     "bwd_equal": bool(torch.equal(da[:b], db)),
                     "bwd_max_abs_diff": float((da[:b].float() - db.float()).abs().max())}
    dlogits = torch.randn((B, S, cfg.vocab_size), generator=g, device=dev) * 1e-5

    def head(xs, r):
        return L.dense(params["lm_head"], xs, 0, cfg.quartet, "bf16").float()

    ya, da = fwd_bwd(head, B, dlogits)
    yb, db = fwd_bwd(head, b, dlogits)
    out["lm_head"] = {"fwd_equal": bool(torch.equal(ya[:b], yb)),
                      "bwd_equal": bool(torch.equal(da[:b], db)),
                      "bwd_max_abs_diff": float((da[:b].float() - db.float()).abs().max())}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
