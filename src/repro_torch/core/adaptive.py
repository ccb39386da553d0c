"""Early-exit waves over tree groups (port of ``repro/core/adaptive.py``).

The L trees are queried in waves of ``wave`` trees; after each wave the
batch's mean k-th distance is compared with the previous wave's, and the
search stops once it improves by less than ``tol`` (relative).  The trees
are independent, so any window of the forest is itself a valid smaller
forest (``Forest.window``: views of the forest's arrays, no copy).
"""
from __future__ import annotations

import torch

from repro_torch.core.forest import Forest, ForestConfig
from repro_torch.core.pipeline import fused_query
from repro_torch.core.quantized import QuantizedDB
from repro_torch.core.search import mask_duplicates, merge_topk_pairs
from repro_torch.device import resolve_device
from repro_torch.kernels.common import POS_INF


def _merge_dedup(d1: torch.Tensor, i1: torch.Tensor, d2: torch.Tensor,
                 i2: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k merge that drops repeated ids (several waves usually find the
    same neighbour), keeping the first occurrence; ties to the earlier
    position."""
    d = torch.cat([d1, d2], dim=1)
    i = torch.cat([i1, i2], dim=1)
    keep = mask_duplicates(i, i >= 0)
    return merge_topk_pairs(torch.where(keep, d, POS_INF),
                            torch.where(keep, i, -1), k)


def adaptive_query(forest: Forest, queries: torch.Tensor,
                   db: torch.Tensor | QuantizedDB, k: int, cfg: ForestConfig,
                   wave: int = 10, tol: float = 0.01, metric: str = "l2",
                   mode: str = "auto", chunk: int = 0, expand: int = 4,
                   dedup: bool = True, n_probes: int = 1,
                   valid: torch.Tensor | None = None,
                   device: str | torch.device | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(dists (B, k), ids (B, k), trees used): the forest in waves of
    ``wave`` trees, each through ``fused_query`` at ``n_probes``, merged
    with repeats dropped.  ``dedup`` masks repeats within a wave; ``valid``
    masks dead rows in every wave.  The mean k-th distance comes to the
    host once a wave."""
    dev = resolve_device(device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    queries = queries.contiguous()
    n_points = (db.fp if isinstance(db, QuantizedDB) else db).shape[0]
    cfg = cfg.resolved(n_points)
    b, n_trees = queries.shape[0], forest.n_trees
    best_d = queries.new_full((b, k), POS_INF)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    prev_kth, used = None, 0
    for w0 in range(0, n_trees, wave):
        d, i = fused_query(forest.window(w0, w0 + wave), queries, db, k, cfg,
                           metric=metric, dedup=dedup, mode=mode, chunk=chunk,
                           expand=expand, n_probes=n_probes, valid=valid,
                           device=dev)
        best_d, best_i = _merge_dedup(best_d, best_i, d, i, k)
        used = min(w0 + wave, n_trees)
        last = best_d[:, -1]
        kth = float(torch.where(torch.isfinite(last), last, 0.0).mean())
        if prev_kth is not None and prev_kth > 0 \
                and (prev_kth - kth) / prev_kth < tol:
            break
        prev_kth = kth
    return best_d, best_i, used
