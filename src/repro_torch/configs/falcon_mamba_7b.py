"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
mamba1, ssm_state=16.  [arXiv:2410.05355]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_variant="mamba1",
    ssm_expand=2,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-reduced",
        family="ssm",
        num_layers=2,
        d_model=128,
        num_heads=1,
        num_kv_heads=1,
        head_dim=32,
        d_ff=0,
        vocab_size=512,
        ssm_state=8,
        ssm_variant="mamba1",
        ssm_expand=2,
        tie_embeddings=True,
    )
