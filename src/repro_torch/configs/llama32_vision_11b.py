"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, gated cross-attention image layers every 5.  Vision frontend is
a STUB (precomputed patch embeddings).  [hf:meta-llama/Llama-3.2-11B-Vision]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1600,
    rope_theta=5e5,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-reduced",
        family="vlm",
        num_layers=4,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        cross_attn_every=2,
        num_image_tokens=64,
    )
