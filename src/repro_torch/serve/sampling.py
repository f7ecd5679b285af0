"""Per-request sampling: temperature / top-k / top-p with a seeded PRNG.

Port of ``repro.serve.sampling``.  One sampling implementation is shared by
every decode path — ``train.serve.greedy_generate``, the engine's prefill,
decode and verify ticks, and the speculative drafters — so that, given
equal logits, all of them draw the same token for the same (seed, row,
token index) triple.  That is what keeps speculative decoding token-exact
at temperature > 0: the verifier re-draws each drafted position with the
position's own key and accepts iff the draw matches the draft.

Keys: ``row_key(seed, row, t) = fold_in(fold_in(PRNGKey(seed), row), t)``,
where ``row`` is the batch row of a generate call (an engine request is
always row 0) and ``t`` counts generated tokens from 0 (the prefill's
token).  There is no global stream.  The keys, the random bits and the
uniforms are jax 0.9.0's bit for bit (:mod:`repro_torch.core.threefry`);
the Gumbel noise's two logs are PyTorch's, which may differ from XLA:CPU's
in the last place.

``temperature == 0`` is greedy argmax (first maximum wins) and never builds
a key.  A row on the card is sampled on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import threefry

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode sampling (frozen, so hashable)."""

    temperature: float = 0.0  # 0 → greedy argmax (default)
    top_k: int = 0  # 0 → disabled
    top_p: float = 1.0  # 1 → disabled
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def filter_logits(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """[..., V] logits → temperature-scaled f32 logits with the entries
    outside the top k and outside the nucleus set to ``NEG_INF``.  Top-k
    keeps ties with the k-th value; top-p keeps the tokens whose exclusive
    cumulative probability is below ``top_p``, so the argmax always stays."""
    l = logits.to(torch.float32) / np.float32(sp.temperature)
    V = l.shape[-1]
    neg = torch.full_like(l, NEG_INF)
    if sp.top_k and sp.top_k < V:
        kth = torch.topk(l, sp.top_k, dim=-1).values[..., -1:]
        l = torch.where(l >= kth, l, neg)
    if sp.top_p < 1.0:
        srt = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < np.float32(sp.top_p)
        cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf")))
        cutoff = torch.amin(cutoff, dim=-1, keepdim=True)
        l = torch.where(l >= cutoff, l, neg)
    return l


def row_key(seed: int, row: int, token_idx: int) -> tuple[int, int]:
    """Stateless per-token key: (request seed, batch row, generated-token
    index) → threefry key."""
    return threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), row), token_idx)


def sample_row(logits: torch.Tensor, sp: SamplingParams, row: int, token_idx: int) -> int:
    """One row's draw ([V] logits → token id), on the row's device."""
    if sp.greedy:
        return int(torch.argmax(logits))
    return threefry.categorical(row_key(sp.seed, row, token_idx), filter_logits(logits, sp))


class Sampler:
    """Host-facing sampler for one ``SamplingParams``:
    ``sampler(logits, token_idx)`` → int.  ``logits`` is a [V] tensor (kept
    on its device) or array."""

    def __init__(self, sp: SamplingParams):
        self.sp = sp

    def __call__(self, logits, token_idx: int) -> int:
        return sample_row(torch.as_tensor(logits), self.sp, 0, token_idx)


_SAMPLERS: dict[SamplingParams, Sampler] = {}


def get_sampler(sp: SamplingParams) -> Sampler:
    """Process-wide cache of samplers, one per ``SamplingParams``."""
    if sp not in _SAMPLERS:
        _SAMPLERS[sp] = Sampler(sp)
    return _SAMPLERS[sp]
