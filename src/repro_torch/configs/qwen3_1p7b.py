"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm, tied embeddings.  [hf:Qwen/Qwen3-8B family]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-reduced",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        qk_norm=True,
        tie_embeddings=True,
    )
