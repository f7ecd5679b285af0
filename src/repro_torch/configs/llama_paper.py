"""The paper's own Llama-2-style pre-training family (Appendix A.1, Table 4):
30M / 50M / 100M / 200M non-embedding parameters + the 7B stability run.
Sequence length 512, batch 512, AdamW, cosine schedule with 10% warmup."""

from repro_torch.configs.base import ModelConfig


def _llama(name, layers, d, heads, vocab=32000) -> ModelConfig:
    # SwiGLU ffn: 8/3·d rounded up to a multiple of 64 (Llama-2 convention)
    f = ((int(d * 8 / 3) + 63) // 64) * 64
    return ModelConfig(
        name=name,
        family="dense",
        num_layers=layers,
        d_model=d,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=d // heads,
        d_ff=f,
        vocab_size=vocab,
    )


LLAMA_30M = _llama("llama-paper-30m", 6, 640, 5)
LLAMA_50M = _llama("llama-paper-50m", 7, 768, 6)
LLAMA_100M = _llama("llama-paper-100m", 8, 1024, 8)
LLAMA_200M = _llama("llama-paper-200m", 10, 1280, 10)
LLAMA_7B = _llama("llama-paper-7b", 32, 4096, 32)

# Paper learning rates (Table 4), scaled inverse-proportionally to N.
LEARNING_RATES = {
    "llama-paper-30m": 1.2e-3,
    "llama-paper-50m": 1.2e-3,
    "llama-paper-100m": 6e-4,
    "llama-paper-200m": 3e-4,
    "llama-paper-7b": 9.375e-6,
}

PAPER_FAMILY = {c.name: c for c in
                (LLAMA_30M, LLAMA_50M, LLAMA_100M, LLAMA_200M, LLAMA_7B)}


def tiny_llama(d: int = 128, layers: int = 3, vocab: int = 2048) -> ModelConfig:
    """~0.5-2M-param models for the CPU-scale Table-3 method comparison."""
    heads = max(d // 64, 2)
    return _llama(f"llama-tiny-{d}x{layers}", layers, d, heads, vocab)


def reduced() -> ModelConfig:
    """The family's CPU-scale stand-in (``--reduced``): 2 layers, d 128."""
    return tiny_llama(d=128, layers=2, vocab=512)
