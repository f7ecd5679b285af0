"""A state-pool prefill row against the teacher-forced forward's row:
``blocked_attention`` over a slot's whole cache view (the tail past the
prompt masked) computes, bit for bit, what it computes over the prompt's
keys alone.

On the card ``torch.sum`` over the key axis rounds a row by its length
(``tools/attention_row_probe.py``: 723 of 2048 VLM rows differ at 64
against 144 keys), so the chunk width must not follow T.  The CPU's sum
happens not to, so besides the outputs these tests record every op the
attention runs (a dispatch mode) and hold that the ops and their shapes are
the same at 64 keys and at the view's length: every chunk is
``min(kv_chunk, KV_CHUNK_MAX)`` keys wide, the last one padded.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.attention import KV_CHUNK_MAX, blocked_attention

S = 64


class _Ops(TorchDispatchMode):
    """Every aten op with its tensor arguments' shapes, in call order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        shapes = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
        self.ops.append((str(func), shapes))
        return func(*args, **(kwargs or {}))


def _rows(hq, hkv, hd, T, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((1, S, hq, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, T, hkv, hd)).astype(np.float32))
            for _ in range(2))
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def _chunk_ops(ops):
    """The ops from the first score product on: the chunk loop, what a
    row's arithmetic runs (before it, only the slicing of k and v to their
    first chunk sees the call's T)."""
    start = next(i for i, (f, _) in enumerate(ops) if "einsum" in f or "bmm" in f)
    return ops[start:]


@pytest.mark.parametrize("hq,hkv,hd,view", [(32, 8, 128, 144), (32, 32, 112, 224),
                                            (6, 6, 64, 144), (4, 2, 32, 600)])
def test_prefill_row_over_the_view_equals_the_prompt_row(hq, hkv, hd, view):
    q, k, v = _rows(hq, hkv, hd, view, seed=view + hd)
    pos = torch.arange(S, dtype=torch.int32)[None]
    alone = blocked_attention(q, k[:, :S], v[:, :S], pos, causal=True, kv_chunk=1024)
    over_view = blocked_attention(q, k, v, pos, causal=True, kv_chunk=1024)
    assert torch.equal(alone, over_view)


def test_a_rows_ops_run_at_one_width_whatever_t():
    """The first chunk's ops at 64 keys and at a 144-key view: the same
    ops at the same shapes (one chunk of min(kv_chunk, KV_CHUNK_MAX) keys)."""
    q, k, v = _rows(32, 8, 128, 144, seed=1)
    pos = torch.arange(S, dtype=torch.int32)[None]
    seen = {}
    for T in (S, 144):
        with _Ops() as rec:
            blocked_attention(q, k[:, :T], v[:, :T], pos, causal=True, kv_chunk=1024)
        seen[T] = _chunk_ops(rec.ops)
    assert seen[S] == seen[144]
    widths = {shape[-1] for f, shapes in seen[S] if "sum" in f for shape in shapes[:1]}
    assert widths == {min(1024, KV_CHUNK_MAX)}


@pytest.mark.parametrize("causal", [True, False])
def test_padding_is_exact_where_t_divides_into_chunks(causal):
    """At T a multiple of the width nothing is padded or masked beyond the
    causal mask; at a ragged T (a 1500-frame source) the padded keys are
    masked, so the output equals the attention over the unpadded keys in
    one chunk of T within f32 rounding."""
    q, k, v = _rows(4, 2, 32, 1500, seed=3)
    q = q[:, :16]
    pos = torch.arange(1484, 1500, dtype=torch.int32)[None]
    got = blocked_attention(q, k, v, pos, causal=causal, kv_chunk=512)
    qf = q.float().reshape(1, 16, 2, 2, 32) / np.sqrt(32)
    s = torch.einsum("bskgd,bckd->bskgc", qf, k.float())
    if causal:
        s = torch.where(pos[:, :, None, None, None] >= torch.arange(1500), s, -torch.inf)
    want = torch.einsum("bskgc,bckd->bskgd", torch.softmax(s, -1), v.float())
    torch.testing.assert_close(got.float(), want.reshape(1, 16, 4, 32).bfloat16().float(),
                               rtol=0, atol=2**-7)
