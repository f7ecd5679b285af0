"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8, qk_norm.  [hf:Qwen/Qwen3-30B-A3B family]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    qk_norm=True,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b-reduced",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=64,
        vocab_size=512,
        num_experts=8,
        experts_per_token=2,
        qk_norm=True,
    )
