"""Host-side acceptance logic + per-request speculative accounting.

Port of ``repro.serve.spec.verify`` (plain Python, copied).

The device side of verification is one call (``serve.steps``'s
``verify_all``, wired up in ``serve.engine``); what lives here is the
pure-python part that is easy to reason about and unit test: given the drafted tokens and the target model's (greedy or sampled)
draws at every drafted position, decide how many drafts survive and what
gets emitted.

Greedy / deterministic-draft acceptance rule: walk the drafted suffix
left-to-right, accept while the target's own draw at that position equals
the draft, and on the first mismatch emit the target's draw as the
correction token.  If every draft survives, the position after the last
draft yields a *bonus* token for free.  The emitted prefix is, by
construction, exactly what the non-speculative loop would have produced one
token at a time — speculation changes the schedule, never the tokens (the
engine's parity-oracle tests pin this token-for-token).
"""

from __future__ import annotations

from typing import Iterable, Sequence


def accept_tokens(draft: Sequence[int], target: Sequence[int]) -> tuple[int, list[int]]:
    """(drafted tokens [k], target draws [k+1]) → (n_accepted, emitted).

    ``target[i]`` is the token the target model itself picks after consuming
    the context up to and including draft ``i-1`` (``target[0]`` follows the
    last accepted token; ``target[k]`` is the bonus draw after draft k).
    ``emitted`` is 1..k+1 tokens: the accepted prefix, then either one
    correction (first mismatch) or the bonus token (all accepted).
    """
    if len(target) != len(draft) + 1:
        raise ValueError(
            f"target must carry len(draft)+1 draws, got {len(target)} for k={len(draft)}")
    n_acc, emitted = 0, []
    for d, t in zip(draft, target):
        emitted.append(int(t))
        if int(t) != int(d):
            return n_acc, emitted
        n_acc += 1
    emitted.append(int(target[-1]))
    return n_acc, emitted


def aggregate_stats(requests: Iterable) -> dict:
    """Fleet-level speculative accounting over finished requests.

    ``tokens_per_decode_call`` counts only decode-phase tokens (the prefill-
    produced first token rides on a prefill call): with speculation on and
    any acceptance at all it exceeds 1.0; the non-speculative engine sits at
    exactly 1.0 by construction.
    """
    reqs = list(requests)
    decode_tokens = sum(max(len(r.tokens) - 1, 0) for r in reqs)
    calls = sum(r.decode_calls for r in reqs)
    proposed = sum(r.draft_proposed for r in reqs)
    accepted = sum(r.draft_accepted for r in reqs)
    return {
        "requests": len(reqs),
        "decode_tokens": decode_tokens,
        "decode_calls": calls,
        "tokens_per_decode_call": round(decode_tokens / calls, 3) if calls else None,
        "drafts_proposed": proposed,
        "drafts_accepted": accepted,
        "acceptance_rate": round(accepted / proposed, 3) if proposed else None,
    }
