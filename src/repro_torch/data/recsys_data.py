"""Criteo-like synthetic recsys stream: correlated sparse ids + CTR labels
(a numpy copy of ``repro/data/recsys_data.py``: the same seed gives the
same batches bit for bit)."""
from __future__ import annotations

import numpy as np


class CTRStream:
    """Synthetic click stream with a planted (learnable) logit structure."""

    def __init__(self, table_sizes, n_dense: int = 0, seed: int = 0,
                 multi_hot: int = 1):
        self.sizes = [int(s) for s in table_sizes]
        self.n_dense = n_dense
        self.rng = np.random.default_rng(seed)
        # planted per-field weights that define ground-truth CTR
        self.field_w = [self.rng.normal(scale=0.5, size=min(s, 1024))
                        for s in self.sizes]
        self.dense_w = self.rng.normal(scale=0.3, size=n_dense)

    def batch(self, b: int) -> dict:
        out = {}
        sparse = np.stack(
            [self.rng.zipf(1.3, size=b).clip(max=s) - 1 for s in self.sizes],
            axis=1).astype(np.int32)
        out["sparse"] = sparse
        logit = sum(self.field_w[i][sparse[:, i] % len(self.field_w[i])]
                    for i in range(len(self.sizes)))
        if self.n_dense:
            dense = self.rng.normal(size=(b, self.n_dense)).astype(np.float32)
            out["dense"] = dense
            logit = logit + dense @ self.dense_w
        p = 1.0 / (1.0 + np.exp(-logit + 1.5))
        out["labels"] = (self.rng.uniform(size=b) < p).astype(np.float32)
        return out

    def batches(self, b: int):
        while True:
            yield self.batch(b)


class BehaviorStream:
    """MIND-style user behavior sequences over a clustered item catalog."""

    def __init__(self, n_items: int, hist_len: int = 50, n_tastes: int = 64,
                 seed: int = 0):
        self.n_items = n_items
        self.hist_len = hist_len
        self.rng = np.random.default_rng(seed)
        self.item_taste = self.rng.integers(0, n_tastes, size=n_items)
        self.taste_items = [np.where(self.item_taste == t)[0]
                            for t in range(n_tastes)]
        self.n_tastes = n_tastes

    def batch(self, b: int) -> dict:
        # each user mixes 1-3 tastes; target comes from one of them
        hist = np.empty((b, self.hist_len), np.int32)
        target = np.empty((b,), np.int32)
        for u in range(b):
            k = self.rng.integers(1, 4)
            tastes = self.rng.choice(self.n_tastes, size=k, replace=False)
            pools = [self.taste_items[t] for t in tastes
                     if len(self.taste_items[t])]
            if not pools:
                pools = [np.arange(self.n_items)]
            picks = [self.rng.choice(p, size=self.hist_len) for p in pools]
            mix = self.rng.integers(0, len(pools), size=self.hist_len)
            hist[u] = np.choose(mix, picks)
            target[u] = self.rng.choice(pools[self.rng.integers(len(pools))])
        return {"hist": hist, "target": target,
                "labels": np.ones((b,), np.float32)}
