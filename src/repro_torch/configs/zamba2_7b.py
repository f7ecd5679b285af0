"""zamba2-7b [hybrid] — 81 Mamba2 layers, d_model=3584, shared attention
block (32H, kv=32, d_ff=14336) applied every 6 layers, vocab=32000,
ssm_state=64.  [arXiv:2411.15242]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_variant="mamba2",
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-reduced",
        family="hybrid",
        num_layers=5,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        ssm_state=16,
        ssm_variant="mamba2",
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_chunk=32,
        attn_every=2,
    )
