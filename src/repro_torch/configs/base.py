"""Model configuration (a torch-free copy of ``repro.configs.base``).

One ``ModelConfig`` per architecture, with the published dimensions, plus a
``reduced()`` variant for CPU tests.  The port serves and trains the dense
and MoE families and serves the SSM (Mamba1), hybrid (Mamba2 with a shared
attention block), enc-dec (whisper) and VLM (gated cross-attention to image
tokens) families.
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

    # SSM (mamba1; mamba2 in the hybrid family)
    ssm_state: int = 0
    ssm_variant: str = ""  # "" | "mamba1" | "mamba2"
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64  # mamba2
    ssm_chunk: int = 128

    # hybrid: the shared attention block applied before every attn_every
    # Mamba2 layers
    attn_every: int = 0

    # enc-dec (whisper)
    encoder_layers: int = 0
    max_source_len: int = 1500  # whisper frame count (30 s)

    # vlm: cross-attention to image tokens every N layers
    cross_attn_every: int = 0
    num_image_tokens: int = 0

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
        """Analytic parameter count, the reference's formula: the weight
        matrices, no biases, norms or SSM vectors beyond A; the hybrid's
        shared block counted once per application.  As in the reference, an
        enc-dec model counts its decoder's self-attention and MLP only (not
        the encoder or the cross attention) and a VLM its cross blocks'
        attention only (not their MLPs)."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim_
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        ffn = (3 if self.mlp == "swiglu" else 2) * d * f
        per_layer = attn + ffn
        if self.family == "hybrid":
            total = (self.num_layers * _mamba_params(self)
                     + self.num_layers // max(self.attn_every, 1) * (attn + ffn))
            if not non_embedding:
                total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
            return total
        if self.family == "ssm":
            per_layer = _mamba_params(self)
        elif self.family == "moe":
            per_layer = attn + self.num_experts * ffn + d * self.num_experts
            if self.moe_dense_residual:
                per_layer += ffn
        total = self.num_layers * per_layer
        if self.family == "vlm" and self.cross_attn_every:
            total += self.num_layers // self.cross_attn_every * attn
        if not non_embedding:
            total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def n_active_params(self) -> int:
        """Parameters a token uses, the reference's formula: a MoE model's
        top-k experts only."""
        if self.family != "moe":
            return self.n_params()
        d, f, hd = self.d_model, self.d_ff, self.head_dim_
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        ffn = (3 if self.mlp == "swiglu" else 2) * d * f
        act = attn + self.experts_per_token * ffn + d * self.num_experts
        if self.moe_dense_residual:
            act += ffn
        return self.num_layers * act


def _mamba_params(cfg: ModelConfig) -> int:
    """One Mamba block's weights: in/x/dt/out projections, the conv and A."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    if cfg.ssm_variant == "mamba2":
        nh = di // cfg.ssm_head_dim
        return d * (2 * di + 2 * n * 1 + nh) + di * cfg.ssm_conv + di * d + 3 * nh
    dt_rank = max(d // 16, 1)
    return (d * 2 * di + di * cfg.ssm_conv + di * (dt_rank + 2 * n)
            + dt_rank * di + di * n + di * d)
