"""Locality-sensitive hashing, the paper's comparison system (port of
``repro/core/lsh.py``, numpy on the host, as in the reference).

E2LSH-style p-stable hashing for L2:  h(x) = floor((a.x + b) / w), with K
concatenated hashes per table and L tables.  The paper compares against a
*cascade* of LSH structures at increasing radii (0.4/0.53/0.63/0.88 on MNIST):
a query probes radii in order until enough candidates are found.  Buckets are
host-side hash maps, as in Andoni's E2LSH software, and the distance rerank
is the forest's fused rerank stage on the card.

The hashing stays float32 numpy, the reference's own arithmetic: another
order of the float sums could flip a ``floor`` and move a point to another
bucket, so the port's candidates are bitwise the reference's.
``CascadedLSH.retrieve_batch`` hashes a whole query batch with one
projection einsum per level and returns padded (B, M) id / mask arrays, the
input of ``core.pipeline.rerank_fused`` on the ``lsh-cascade`` backend.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LSHConfig:
    n_tables: int = 10          # L
    n_bits: int = 12            # K hashes concatenated per table
    width: float = 0.5          # w (bucket width, scales with target radius)
    seed: int = 0


def pad_candidate_lists(cands: list, pad_multiple: int = 64
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Pad per-query candidate id lists to a common (B, M) matrix + mask.

    M is the max list length rounded up to ``pad_multiple`` (the
    reference's bound on the shapes its compiled rerank sees).  Invalid
    slots hold id 0 and mask False, the contract of
    ``forest.gather_candidates``.
    """
    m = max((len(c) for c in cands), default=0)
    m = max(pad_multiple, -(-m // pad_multiple) * pad_multiple)
    ids = np.zeros((len(cands), m), np.int32)
    mask = np.zeros((len(cands), m), bool)
    for j, c in enumerate(cands):
        ids[j, :len(c)] = c
        mask[j, :len(c)] = True
    return ids, mask


class LSHIndex:
    """One radius level: L tables of K p-stable hashes each."""

    def __init__(self, x: np.ndarray, cfg: LSHConfig):
        self.cfg = cfg
        n, d = x.shape
        rng = np.random.default_rng(cfg.seed)
        # (L, K, d) gaussian projections; (L, K) uniform offsets
        self.a = rng.normal(size=(cfg.n_tables, cfg.n_bits, d)).astype(np.float32)
        self.b = rng.uniform(0.0, cfg.width,
                             size=(cfg.n_tables, cfg.n_bits)).astype(np.float32)
        keys = self._hash(x)                    # (L, N, K) int32
        self.tables: list[dict] = []
        for l in range(cfg.n_tables):
            table: dict = {}
            for i, key in enumerate(map(tuple, keys[l])):
                table.setdefault(key, []).append(i)
            self.tables.append(table)

    def _hash(self, x: np.ndarray) -> np.ndarray:
        # (L, n, K) = floor((x @ a^T + b) / w)
        proj = np.einsum("nd,lkd->lnk", x, self.a)
        return np.floor((proj + self.b[:, None, :]) / self.cfg.width).astype(
            np.int32)

    def candidate_sets(self, q: np.ndarray) -> list:
        """(B, d) -> per-query candidate id sets; ONE _hash call per batch."""
        keys = self._hash(q)                    # (L, B, K)
        out = [set() for _ in range(q.shape[0])]
        for l in range(self.cfg.n_tables):
            table = self.tables[l]
            for j, key in enumerate(map(tuple, keys[l])):
                got = table.get(key)
                if got:
                    out[j].update(got)
        return out

    def candidates_batch(self, q: np.ndarray, pad_multiple: int = 64
                         ) -> tuple[np.ndarray, np.ndarray]:
        """(B, d) -> padded (B, M) int32 ids + (B, M) bool mask.

        Shaped for the fused rerank stage (the ids / mask contract of
        ``gather_candidates``); one vectorized hash per batch.
        """
        sets = self.candidate_sets(np.atleast_2d(q))
        return pad_candidate_lists([sorted(s) for s in sets], pad_multiple)

    def candidates(self, q: np.ndarray) -> set:
        """Single-point shim over the batch path."""
        return self.candidate_sets(q[None, :])[0]


class CascadedLSH:
    """Multi-radius cascade (paper §2: 'a cascade of LSH tables ... searched in
    order of decreasing resolution, until either a match is found or all hash
    tables have been searched')."""

    def __init__(self, x: np.ndarray, radii: list[float], n_tables: int = 10,
                 n_bits: int = 12, width_scale: float = 1.0, seed: int = 0):
        self.x = np.asarray(x, np.float32)
        self.levels = [
            LSHIndex(self.x, LSHConfig(n_tables=n_tables, n_bits=n_bits,
                                       width=width_scale * r, seed=seed + 31 * i))
            for i, r in enumerate(radii)
        ]

    def retrieve_sets(self, q: np.ndarray, min_candidates: int = 1) -> list:
        """(B, d) -> per-query candidate sets; each query stops at the first
        radius level that accumulates >= min_candidates (cascade semantics,
        batched: one hash per level per batch)."""
        q = np.atleast_2d(q)
        out = [set() for _ in range(q.shape[0])]
        open_q = list(range(q.shape[0]))
        for level in self.levels:               # increasing radius
            if not open_q:
                break
            per_level = level.candidate_sets(q[open_q])
            still_open = []
            for j, cand in zip(open_q, per_level):
                out[j].update(cand)
                if len(out[j]) < min_candidates:
                    still_open.append(j)
            open_q = still_open
        return out

    def retrieve_batch(self, q: np.ndarray, min_candidates: int = 1,
                       pad_multiple: int = 64
                       ) -> tuple[np.ndarray, np.ndarray]:
        """(B, d) -> padded (B, M) ids + mask for the fused rerank stage."""
        sets = self.retrieve_sets(q, min_candidates)
        return pad_candidate_lists([sorted(s) for s in sets], pad_multiple)

    def retrieve(self, q: np.ndarray, min_candidates: int = 1) -> np.ndarray:
        cand = self.retrieve_sets(q[None, :], min_candidates)[0]
        return np.fromiter(cand, dtype=np.int64) if cand else np.empty(0, np.int64)

    def query(self, q: np.ndarray, k: int, min_candidates: int = 1
              ) -> tuple[np.ndarray, np.ndarray, int]:
        cand = self.retrieve(q, min_candidates)
        if cand.size == 0:
            return np.full(k, np.inf), np.full(k, -1), 0
        d = np.sum((self.x[cand] - q[None, :]) ** 2, axis=1)
        top = np.argsort(d)[:k]
        return d[top], cand[top], cand.size
