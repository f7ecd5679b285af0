"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual MLP.  [hf:Snowflake/snowflake-arctic-base]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-reduced",
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
        moe_dense_residual=True,
    )
