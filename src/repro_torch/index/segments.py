"""Segment helpers of the index (port of ``repro/index/segments.py``; this
slice ports ``brute_force_topk`` only -- segments, the delta buffer and
views are later slices)."""
from __future__ import annotations

import torch

from repro_torch.index.params import SearchParams


def brute_force_topk(q: torch.Tensor, rows: torch.Tensor,
                     params: SearchParams, valid: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact scan through the fused rerank path: (B, k) dists + row ids.

    The scan is ``rerank_fused`` over ids = arange(N) for every query
    (mask = ``valid``, dedup off), padded to at least k columns, so its
    distance arithmetic is that of every candidate-based backend: a row
    scores the same whichever backend holds it.  On the card that is the
    fused kernel with M = N.
    """
    from repro_torch.core.pipeline import rerank_fused
    b, n = q.shape[0], rows.shape[0]
    m = max(n, params.k)
    ids = torch.full((b, m), -1, dtype=torch.int32, device=rows.device)
    ids[:, :n] = torch.arange(n, dtype=torch.int32, device=rows.device)
    mask = ids >= 0
    if valid is not None:
        mask[:, :n] &= valid[None, :]
    return rerank_fused(q, ids, mask, rows, params.k, metric=params.metric,
                        mode=params.mode, dedup=False, chunk=params.chunk)
