"""Synthetic LM token streams (a copy of ``repro/data/lm_data.py``: numpy,
the reference's tokens bit for bit from the same seed).

A Zipf-distributed Markov token generator gives a learnable (non-uniform
bigram) distribution so train-loss curves are meaningful in examples/tests.
"""
from __future__ import annotations

import numpy as np


class MarkovTokens:
    """Order-1 Markov chain over the vocab with Zipfian stationary dist."""

    def __init__(self, vocab_size: int, branch: int = 20, seed: int = 0):
        self.vocab = vocab_size
        self.branch = branch
        self.rng = np.random.default_rng(seed)
        # per-token successor table (sparse transition structure)
        self.successors = self.rng.integers(
            0, vocab_size, size=(vocab_size, branch)).astype(np.int32)
        w = 1.0 / np.arange(1, branch + 1)
        self.w = w / w.sum()

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len + 1), np.int32)
        cur = self.rng.integers(0, self.vocab, size=batch)
        out[:, 0] = cur
        for t in range(1, seq_len + 1):
            pick = self.rng.choice(self.branch, size=batch, p=self.w)
            cur = self.successors[cur, pick]
            out[:, t] = cur
        return out

    def batches(self, batch: int, seq_len: int):
        while True:
            tok = self.sample(batch, seq_len)
            yield {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
