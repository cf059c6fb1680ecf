"""Token data pipeline: synthetic corpus + packing.

The port's own copy of ``src/repro/training/data.py`` (numpy only): an
infinite iterator of packed {tokens, labels} numpy batches for the
training launcher, bitwise the reference's for the same seed. The
synthetic corpus is a Zipf-distributed token stream with injected
bigram structure so the loss actually decreases (uniform noise would
not train). No data needs a download.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticCorpus:
    """Zipfian unigram stream with Markov bigram structure."""

    def __init__(self, vocab_size: int, seed: int = 0, alpha: float = 1.2,
                 bigram_strength: float = 0.7, state_size: int = 64):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = ranks ** -alpha
        self.unigram /= self.unigram.sum()
        # each token deterministically prefers a successor
        self.succ = self.rng.integers(0, vocab_size, vocab_size)
        self.p_bigram = bigram_strength

    def sample(self, n: int) -> np.ndarray:
        toks = np.empty(n, np.int64)
        toks[0] = self.rng.choice(self.vocab, p=self.unigram)
        follow = self.rng.random(n) < self.p_bigram
        indep = self.rng.choice(self.vocab, size=n, p=self.unigram)
        for i in range(1, n):
            toks[i] = self.succ[toks[i - 1]] if follow[i] else indep[i]
        return toks


def packed_batches(
    vocab_size: int,
    batch: int,
    seq_len: int,
    *,
    seed: int = 0,
    pad_id: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite {tokens, labels} iterator with next-token labels."""
    corpus = SyntheticCorpus(vocab_size, seed)
    while True:
        stream = corpus.sample(batch * (seq_len + 1))
        arr = stream.reshape(batch, seq_len + 1)
        yield {
            "tokens": arr[:, :-1].astype(np.int32),
            "labels": arr[:, 1:].astype(np.int32),
        }
