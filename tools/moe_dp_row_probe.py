"""The ops of a qwen3-moe-235b-a22b training step (full width) on a data
rank's rows against one device's, on the card.

    python3 tools/moe_dp_row_probe.py

A data-parallel rank runs each op on its share of the rows, and a rank
of a shared MoE group runs each expert op on its block of the experts; its
layers see one device's bits only if every op rounds a row (an expert)
alike at either count.  For rmsnorm, attention (q/k norms, GQA 64/4), the
f32 LM head over the 151936-long vocabulary (forward; dx), and the MoE
layer's expert ops (the grouped Hadamard over an expert block, and the
experts' Quartet backward on the kernels for a block of 32 of the 128
experts), it prints whether the outputs and dx of the first rows (or
experts) are bit for bit equal at 32 against 8 and 8 against 2 rows of 512,
or at 128 against 32 experts, with the count of elements that differ.
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
    from repro_torch.core import quartet as Q
    from repro_torch.core.hadamard import hadamard_transform
    from repro_torch.kernels import _build
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import layers as L
    from repro_torch.models.attention import attention
    from repro_torch.models.transformer import layer_slice

    _build.build_all()
    dev = "cuda"
    cfg = kernel_config(dataclasses.replace(get_config("qwen3-moe-235b-a22b"), num_layers=1))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    lp = layer_slice(params["layers"], 0)
    g = torch.Generator(device=dev).manual_seed(1)
    S, D = 512, cfg.d_model
    out = {}

    def differ(a, b):
        return int((a != b).sum())

    for B, b in ((32, 8), (8, 2)):
        x = torch.randn((B, S, D), generator=g, device=dev).to(torch.bfloat16)
        dy = (torch.randn((B, S, D), generator=g, device=dev) * 1e-3).to(torch.bfloat16)
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        rope = L.rope_table(pos, cfg.head_dim_, cfg.rope_theta)

        def attn(xs, r):
            return attention(lp["attn"], xs, pos[:r], 7, cfg, causal=True, method="quartet",
                             rope=(rope[0][:r], rope[1][:r]))[0]

        def norm(xs, r):
            return L.rmsnorm(lp["mlp_norm"], xs, cfg.norm_eps)

        for name, fn in (("rmsnorm", norm), ("attention", attn)):
            res = []
            for r in (B, b):
                xs = x[:r].clone().requires_grad_()
                y = fn(xs, r)
                res.append((y.detach(), torch.autograd.grad(y, xs, dy[:r])[0]))
            out[f"{name} {B} vs {b} rows"] = {"out_differ": differ(res[0][0][:b], res[1][0]),
                                              "dx_differ": differ(res[0][1][:b], res[1][1])}
        # the LM head (f32, the MoE config's untied head) on a loss chunk of
        # 128 positions
        w = params["lm_head"]["w"].to(torch.float32)
        xh = x[:, :128].to(torch.float32)
        gh = (torch.randn((B, 128, w.shape[1]), generator=g, device=dev) * 1e-6)
        res = []
        for r in (B, b):
            xs = xh[:r].clone().requires_grad_()
            y = L.head_product(xs, w)
            res.append((y.detach(), torch.autograd.grad(y, xs, gh[:r])[0]))
        out[f"head {B} vs {b} rows"] = {"out_differ": differ(res[0][0][:b], res[1][0]),
                                        "dx_differ": differ(res[0][1][:b], res[1][1])}
        del x, dy, xh, gh, res
        torch.cuda.empty_cache()

    # the expert ops over all 128 experts against a block of 32
    E, c, K, N, El = cfg.num_experts, 320, D, cfg.d_ff, 32
    xe = (torch.randn((E, c, K), generator=g, device=dev) * 1.9).to(torch.bfloat16)
    w = (torch.randn((E, K, N), generator=g, device=dev) / K**0.5).to(torch.bfloat16)
    dye = (torch.randn((E, c, N), generator=g, device=dev) * 1e-3).to(torch.bfloat16)
    h = torch.randn((E, c, K), generator=g, device=dev)
    out["hadamard_transform [E, c, K] 128 vs 32 experts"] = differ(
        hadamard_transform(h, g=32, dim=-1)[:El], hadamard_transform(h[:El], g=32, dim=-1))
    hw = torch.randn((E, K, N), generator=g, device=dev)
    out["hadamard_transform [E, K, N] dim -2, 128 vs 32 experts"] = differ(
        hadamard_transform(hw, g=32, dim=-2)[:El], hadamard_transform(hw[:El], g=32, dim=-2))
    qc = Q.QuartetConfig(use_kernels=True)
    seeds = (torch.arange(E, device=dev, dtype=torch.int64) * 1000003 + 12345) & 0xFFFFFFFF
    _, res = Q._forward_experts_kernels(xe, w, qc)
    dx, dw = Q._backward_experts_kernels(qc, seeds, res, dye)
    _, res_b = Q._forward_experts_kernels(xe[:El], w[:El], qc)
    dx_b, dw_b = Q._backward_experts_kernels(qc, seeds[:El], res_b, dye[:El])
    out["experts' backward 128 vs 32 experts"] = {"dx_differ": differ(dx[:El], dx_b),
                                                  "dw_differ": differ(dw[:El], dw_b)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
