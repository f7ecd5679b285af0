"""Speculative-decoding configuration.

Port of ``repro.serve.spec.config`` (plain Python, copied).

``SpecConfig`` rides inside :class:`repro_torch.serve.engine.EngineConfig` —
``EngineConfig(spec=SpecConfig(k=4, proposer="ngram"))`` turns every decode
tick of a paged-family engine into a draft → batched-verify → accept/rollback
cycle emitting between 1 and ``k + 1`` tokens per verify call.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Frozen (hashable) so it can nest inside the frozen EngineConfig.

    ``k``        — drafted tokens per verify call; the verify step scores
                   ``k + 1`` tokens (last accepted token + the drafted
                   suffix) and emits 1..k+1 tokens.
    ``proposer`` — registry name: ``"self"`` (the target model drafts for
                   itself — the parity/acceptance oracle), ``"ngram"``
                   (suffix-match over the request's own prompt + generation;
                   no extra weights), or ``"draft"`` (a separate registry
                   model in FP4 with its own paged cache).
    """

    k: int = 4
    proposer: str = "self"
    # -- ngram proposer -----------------------------------------------------
    ngram: int = 2  # suffix length to match against the request's history
    # -- draft-model proposer -----------------------------------------------
    draft_arch: str | None = None  # registry arch name (required for "draft")
    draft_reduced: bool = True  # use the reduced registry config
    draft_kv_dtype: str = "mxfp4"  # draft model's own paged-KV dtype
    draft_method: str = "quartet"  # FP4 forward for the draft model
    draft_seed: int = 0  # draft param init seed

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec.k must be >= 1, got {self.k}")
        if self.ngram < 1:
            raise ValueError(f"spec.ngram must be >= 1, got {self.ngram}")
        if self.draft_kv_dtype not in ("mxfp4", "dense"):
            raise ValueError(
                f"draft_kv_dtype must be 'mxfp4' or 'dense', got {self.draft_kv_dtype!r}")
