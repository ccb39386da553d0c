"""Index backends (port of ``repro/index/backends.py``):

  rpf          the paper's random-partition forest, fused fp32 rerank
  rpf+int8     the same forest, int8 coarse shortlist -> fused fp32 rerank
  lsh-cascade  the paper's LSH baseline: multi-radius LSH candidates on the
               host -> the same fused rerank
  bruteforce   exact scan through the same fused rerank (the recall oracle)

An engine is the immutable search core of one segment: it owns the rows
(and the forest) on the device, answers ``search(q, params, valid=None)``
with segment-local ids (``valid`` an optional (n,) bool tombstone mask,
applied before any kernel scores a row), and saves as a tree of arrays
(``state_tree`` / ``state_skeleton`` / ``from_state``) under the
reference's leaf names.  One engine exists per sealed segment; each
``Index`` subclass adds its ``stats()`` keys and its format-1 checkpoint
tree.  ``params.n_probes`` widens the descent to the most marginal leaves;
``params.n_trees`` queries a prefix of the forest (the trees are
independent, so any prefix is a valid smaller forest); ``params.expand``
sets the int8 shortlist width; ``params.min_candidates`` sets where the LSH
cascade stops.  On both forest backends ``params.probe_schedule`` replaces
the fixed probe budget with per-query widening (``core/schedule.py``) and
``params.adaptive_wave`` queries the forest in early-exit waves of trees
(``core/adaptive.py``); the engine records the trees and mean probes its
last search used (``last_trees_used``, ``last_mean_probes``), which
``index/tune.py``'s cost model reads.  Knobs that do not apply to a
backend are inert.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.adaptive import adaptive_query
from repro_torch.core.forest import Forest, build_forest
from repro_torch.core.lsh import CascadedLSH
from repro_torch.core.pipeline import fused_query, rerank_fused
from repro_torch.core.quantized import QuantizedDB, quantize_db
from repro_torch.core.schedule import scheduled_query
from repro_torch.index.api import Index, register_backend
from repro_torch.index.params import IndexSpec, SearchParams
from repro_torch.index.segments import brute_force_topk

_FOREST_SKELETON = Forest(*[0] * len(Forest._fields))


def _rows_from_state(state: dict, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(state["db"], np.float32), device=device)


class RPFEngine:
    """The paper's random-partition-forest core, fused fp32 rerank."""

    def __init__(self, spec: IndexSpec, rows: torch.Tensor, *,
                 generator: torch.Generator | None = None, draws=None,
                 forest: Forest | None = None):
        self.spec = spec
        self.db = rows
        self.forest = forest if forest is not None else build_forest(
            rows, spec.forest, generator=generator, draws=draws,
            device=rows.device, tree_chunk=spec.tree_chunk)
        self.last_trees_used = spec.forest.n_trees
        self.last_mean_probes = 0.0

    def _rerank_source(self) -> torch.Tensor | QuantizedDB:
        return self.db

    def search(self, q: torch.Tensor, params: SearchParams,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.spec.forest
        forest = self.forest
        if 0 < params.n_trees < cfg.n_trees:
            forest = forest.prefix(params.n_trees)
            cfg = cfg._replace(n_trees=params.n_trees)
        src, dev = self._rerank_source(), self.db.device
        common = dict(metric=params.metric, mode=params.mode,
                      chunk=params.chunk, expand=params.expand,
                      dedup=params.dedup, valid=valid, device=dev)
        if params.probe_schedule > 0:
            # capabilities() refuses it together with adaptive_wave
            d, i, _, processed = scheduled_query(
                forest, q, src, params.k, cfg, cap=params.probe_schedule,
                tol=params.tol, **common)
            self.last_trees_used = cfg.n_trees
            self.last_mean_probes = float(processed.mean())
            return d, i
        if params.adaptive_wave > 0:
            d, i, used = adaptive_query(
                forest, q, src, params.k, cfg, wave=params.adaptive_wave,
                tol=params.tol, n_probes=params.n_probes, **common)
            self.last_trees_used = used
            self.last_mean_probes = float(params.n_probes)
            return d, i
        self.last_trees_used = cfg.n_trees
        self.last_mean_probes = float(params.n_probes)
        return fused_query(forest, q, src, params.k, cfg,
                           n_probes=params.n_probes, **common)

    def state_tree(self) -> dict:
        return {"db": self.db, "forest": self.forest}

    @classmethod
    def state_skeleton(cls, spec: IndexSpec) -> dict:
        return {"db": 0, "forest": _FOREST_SKELETON}

    @classmethod
    def from_state(cls, spec: IndexSpec, state: dict, device: torch.device):
        forest = Forest(*(torch.tensor(np.asarray(a), device=device)
                          for a in state["forest"]))
        return cls(spec, _rows_from_state(state, device), forest=forest)


class RPFInt8Engine(RPFEngine):
    """Same forest; int8 coarse shortlist (k' = expand*k, scored under
    ``params.metric`` on the dequantized rows) -> exact fp32 fused rerank.
    ``valid`` applies at the coarse stage."""

    def __init__(self, spec: IndexSpec, rows: torch.Tensor, *,
                 generator: torch.Generator | None = None, draws=None,
                 forest: Forest | None = None):
        super().__init__(spec, rows, generator=generator, draws=draws,
                         forest=forest)
        self.qdb = quantize_db(rows)

    def _rerank_source(self) -> QuantizedDB:
        return self.qdb


class LSHEngine:
    """The paper's LSH-cascade baseline behind the same search surface.

    The bucket probe runs on the host in numpy (one hash per batch per
    level, as in the reference), then the (B, M) ids and mask go to the
    index's device and through the same fused rerank as the forest
    backends, with dedup off: a query's candidate set holds each id once.
    The tables are a function of (rows, spec) alone, so the builder's
    generator and draws are unused.
    """

    def __init__(self, spec: IndexSpec, rows: torch.Tensor, *,
                 generator: torch.Generator | None = None, draws=None):
        self.spec = spec
        self.db = rows
        self.cascade = CascadedLSH(
            rows.cpu().numpy(), list(spec.lsh_radii),
            n_tables=spec.lsh_tables, n_bits=spec.lsh_bits,
            width_scale=spec.lsh_width_scale, seed=spec.seed)
        self.last_mean_candidates = 0.0

    def search(self, q: torch.Tensor, params: SearchParams,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        ids, mask = self.cascade.retrieve_batch(
            q.cpu().numpy(), min_candidates=params.min_candidates)
        self.last_mean_candidates = float(mask.sum(1).mean())
        dev = self.db.device
        return rerank_fused(q, torch.from_numpy(ids).to(dev),
                            torch.from_numpy(mask).to(dev), self.db,
                            params.k, metric=params.metric, mode=params.mode,
                            dedup=False, chunk=params.chunk, valid=valid)

    def state_tree(self) -> dict:
        return {"db": self.db}

    @classmethod
    def state_skeleton(cls, spec: IndexSpec) -> dict:
        return {"db": 0}

    @classmethod
    def from_state(cls, spec: IndexSpec, state: dict, device: torch.device):
        # the tables are a function of (rows, spec): rebuilt
        return cls(spec, _rows_from_state(state, device))


class BruteForceEngine:
    """Exact scan routed through the shared fused rerank stage; the
    builder's generator and draws are unused."""

    def __init__(self, spec: IndexSpec, rows: torch.Tensor, *,
                 generator: torch.Generator | None = None, draws=None):
        self.spec = spec
        self.db = rows

    def search(self, q: torch.Tensor, params: SearchParams,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        return brute_force_topk(q, self.db, params, valid=valid)

    def state_tree(self) -> dict:
        return {"db": self.db}

    @classmethod
    def state_skeleton(cls, spec: IndexSpec) -> dict:
        return {"db": 0}

    @classmethod
    def from_state(cls, spec: IndexSpec, state: dict, device: torch.device):
        return cls(spec, _rows_from_state(state, device))


@register_backend("rpf")
class RPFIndex(Index):
    """The paper's random-partition-forest index, fused fp32 rerank."""

    engine_cls = RPFEngine

    @property
    def forest(self) -> Forest:
        """The first segment's forest."""
        return self._primary_engine.forest

    @property
    def last_trees_used(self) -> int:
        """Trees the first segment's engine queried on its last search."""
        return self._primary_engine.last_trees_used

    @property
    def last_mean_probes(self) -> float:
        """Mean probes per query the first segment's engine processed on
        its last search (a schedule's sum over its rounds; ``n_probes`` on
        the fixed-budget paths)."""
        return self._primary_engine.last_mean_probes

    def _extra_stats(self) -> dict:
        return {"n_trees": self.spec.forest.n_trees}

    @classmethod
    def _v1_skeleton(cls, spec: IndexSpec) -> dict:
        return {"db": 0, "key_data": 0, "forest": _FOREST_SKELETON}


@register_backend("rpf+int8")
class RPFInt8Index(RPFIndex):
    """Same forest; int8 coarse shortlist -> exact fp32 fused rerank."""

    engine_cls = RPFInt8Engine

    @property
    def qdb(self) -> QuantizedDB:
        return self._primary_engine.qdb


@register_backend("lsh-cascade")
class LSHCascadeIndex(Index):
    """The paper's LSH cascade: host buckets -> the fused rerank."""

    engine_cls = LSHEngine

    @property
    def cascade(self) -> CascadedLSH:
        return self._primary_engine.cascade

    @property
    def last_mean_candidates(self) -> float:
        return self._primary_engine.last_mean_candidates

    def _extra_stats(self) -> dict:
        return {"n_levels": len(self.spec.lsh_radii),
                "n_tables": self.spec.lsh_tables}

    @classmethod
    def _v1_skeleton(cls, spec: IndexSpec) -> dict:
        return {"db": 0, "key_data": 0}


@register_backend("bruteforce")
class BruteForceIndex(Index):
    """Exact scan via the shared fused rerank stage (the recall oracle)."""

    engine_cls = BruteForceEngine

    @classmethod
    def _v1_skeleton(cls, spec: IndexSpec) -> dict:
        return {"db": 0, "key_data": 0}
