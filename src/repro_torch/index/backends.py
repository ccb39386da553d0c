"""Index backends (port of ``repro/index/backends.py``): ``rpf``, the
paper's random-partition forest with the fused fp32 rerank.

An engine is the immutable search core of one segment: it owns the rows and
the forest and answers ``search(q, params)``.  ``params.n_probes`` widens
the descent to the most marginal leaves; ``params.n_trees`` queries a
prefix of the forest (the trees are independent, so any prefix is a valid
smaller forest).
"""
from __future__ import annotations

import torch

from repro_torch.core.forest import Forest, build_forest
from repro_torch.core.pipeline import fused_query
from repro_torch.index.api import Index, register_backend
from repro_torch.index.params import IndexSpec, SearchParams


class RPFEngine:
    """The paper's random-partition-forest core, fused fp32 rerank."""

    def __init__(self, spec: IndexSpec, rows: torch.Tensor, *,
                 generator: torch.Generator | None = None, draws=None,
                 forest: Forest | None = None):
        self.spec = spec
        self.db = rows
        self.forest = forest if forest is not None else build_forest(
            rows, spec.forest, generator=generator, draws=draws,
            device=rows.device)

    def search(self, q: torch.Tensor, params: SearchParams,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.spec.forest
        forest = self.forest
        if 0 < params.n_trees < cfg.n_trees:
            forest = forest.prefix(params.n_trees)
            cfg = cfg._replace(n_trees=params.n_trees)
        return fused_query(forest, q, self.db, params.k, cfg,
                           metric=params.metric, dedup=params.dedup,
                           mode=params.mode, chunk=params.chunk,
                           n_probes=params.n_probes, valid=valid,
                           device=self.db.device)


@register_backend("rpf")
class RPFIndex(Index):
    """The paper's random-partition-forest index, fused fp32 rerank."""

    engine_cls = RPFEngine

    @property
    def forest(self) -> Forest:
        return self.engine.forest
