"""whisper-tiny [audio/enc-dec] — 4+4L d_model=384 6H d_ff=1536 vocab=51865,
conv frontend is a STUB (precomputed frame embeddings).  [arXiv:2212.04356]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp="gelu",
    use_bias=True,
    norm="layernorm",
    pos_embed="absolute",
    tie_embeddings=True,
    max_source_len=1500,
    attn_kv_chunk=512,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-reduced",
        family="encdec",
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        mlp="gelu",
        use_bias=True,
        norm="layernorm",
        pos_embed="absolute",
        tie_embeddings=True,
        max_source_len=64,
    )
