"""Speculative decoding over the paged MXFP4 KV cache: draft → one batched
verify → accept or roll back."""

from repro_torch.serve.spec.config import SpecConfig
from repro_torch.serve.spec.proposers import (
    PROPOSERS,
    DraftModelProposer,
    NGramProposer,
    Proposer,
    SelfProposer,
    build_proposer,
    register_proposer,
)
from repro_torch.serve.spec.verify import accept_tokens, aggregate_stats

__all__ = [
    "SpecConfig",
    "Proposer",
    "SelfProposer",
    "NGramProposer",
    "DraftModelProposer",
    "PROPOSERS",
    "register_proposer",
    "build_proposer",
    "accept_tokens",
    "aggregate_stats",
]
