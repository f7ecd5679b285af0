"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, GeLU MLP, biases, RoPE.  [arXiv:2402.19173]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    mlp="gelu",
    use_bias=True,
    rope_theta=1e5,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-reduced",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mlp="gelu",
        use_bias=True,
    )
