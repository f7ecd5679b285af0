"""Model configuration (a torch-free copy of ``repro.configs.base``).

One ``ModelConfig`` per architecture, with the published dimensions, plus a
``reduced()`` variant for CPU tests.  The port serves and trains the dense
family and serves the MoE family; the other families' fields arrive with
their slices.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.quartet import QUARTET_CONFIG, QuartetConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    mlp: str = "swiglu"  # "swiglu" | "gelu"
    use_bias: bool = False
    qk_norm: bool = False
    pos_embed: str = "rope"  # "rope" | "absolute" | "none"
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3

    # numerics / technique
    quartet: QuartetConfig = QUARTET_CONFIG
    quantize_lm_head: bool = False  # the paper quantizes transformer linears
    dtype: str = "bfloat16"

    # attention backend: "blocked" (plain PyTorch online softmax), "flash"
    # (the forward-only flash kernel in cache-free forwards: evaluation) or
    # "paged" (serving steps attend over the paged pool with the kernel)
    attn_backend: str = "paged"
    attn_kv_chunk: int = 1024
    # training: recompute each layer's forward in the backward
    # (torch.utils.checkpoint), keeping only the layer inputs
    remat: bool = True

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_causal_lm(self) -> bool:
        return self.family in ("dense", "moe", "ssm", "hybrid", "vlm")

    def n_params(self, non_embedding: bool = True) -> int:
        """Analytic parameter count of the dense and MoE families."""
        if self.family not in ("dense", "moe"):
            raise NotImplementedError(f"n_params for family {self.family!r} is not ported yet")
        d, f, hd = self.d_model, self.d_ff, self.head_dim_
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        ffn = (3 if self.mlp == "swiglu" else 2) * d * f
        per_layer = attn + ffn
        if self.family == "moe":
            per_layer = attn + self.num_experts * ffn + d * self.num_experts
            if self.moe_dense_residual:
                per_layer += ffn
        total = self.num_layers * per_layer
        if not non_embedding:
            total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total
