"""ANN index service: DEPRECATED shim over the unified index API.

``AnnService`` predates ``repro_torch.index``; it survives as a thin adapter so
external callers keep working.  New code should use::

    from repro_torch.index import IndexSpec, SearchParams, build_index
    index = build_index(key, db, IndexSpec(backend="rpf", forest=cfg))
    dists, ids = index.search(q, SearchParams(k=10))

The behavior tracks the segmented index lifecycle (DESIGN.md §8): queries
dispatch through the fused single-pass pipeline (core/pipeline.py) against
the published immutable view (no reader/writer lock contention); inserts
land in the delta buffer (paper §5 incremental updates, immediately
queryable) and are sealed into an immutable segment once they exceed
``rebuild_frac`` of the static rows; deletes/upserts tombstone the old row.
``compact()`` exposes the explicit (optionally background) rebuild that
replaced the old synchronous overflow fold.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import ForestConfig
from repro_torch.index import IndexSpec, SearchParams, build_index


class AnnService:
    """An ``rpf`` index built on ``device`` (the GPU unless
    ``device="cpu"``) from ``generator`` or ``draws`` (``build_index``'s;
    neither: a generator seeded with ``seed``)."""

    def __init__(self, db: np.ndarray, cfg: ForestConfig, metric: str = "l2",
                 seed: int = 0, rebuild_frac: float = 0.1,
                 mode: str = "auto",
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None, draws=None):
        self.metric = metric
        self.cfg = cfg
        self.seed = seed
        self.rebuild_frac = rebuild_frac
        self.mode = mode
        self.index = build_index(
            db, IndexSpec(backend="rpf", forest=cfg, seed=seed,
                          rebuild_frac=rebuild_frac),
            device=device, generator=generator, draws=draws)

    # ------------------------------------------------------------------ api
    @property
    def db(self) -> torch.Tensor:
        return self.index.db

    def insert(self, x: np.ndarray) -> int:
        """Paper §5 incremental update. Returns the new point's id."""
        return self.index.add(x)

    def delete(self, ids) -> int:
        """Tombstone one id or an iterable of ids. Returns the count."""
        return self.index.delete(ids)

    def upsert(self, gid: int, x: np.ndarray) -> int:
        """Insert-or-replace the vector for ``gid`` (id preserved)."""
        return self.index.upsert(gid, x)

    def compact(self, block: bool = True):
        """Rebuild the live point set into one segment (off the lock)."""
        return self.index.compact(block=block)

    def query(self, q: np.ndarray, k: int = 10
              ) -> tuple[np.ndarray, np.ndarray]:
        """q (B, d) -> (dists (B,k), ids (B,k)) on the host; probes index +
        delta."""
        d, i = self.index.search(q, SearchParams(k=k, metric=self.metric,
                                                 mode=self.mode))
        return d.cpu().numpy(), i.cpu().numpy()

    def stats(self) -> dict:
        s = self.index.stats()
        return {"n_static": s["n_static"], "n_overflow": s["n_overflow"],
                "n_segments": s["n_segments"],
                "n_tombstones": s["n_tombstones"],
                "n_compactions": s["n_compactions"],
                "n_trees": self.cfg.n_trees}
