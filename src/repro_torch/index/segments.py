"""Segment helpers of the index (port of ``repro/index/segments.py``; this
slice ports ``brute_force_topk`` only -- segments, the delta buffer and
views are later slices)."""
from __future__ import annotations

import torch

from repro_torch.index.params import SearchParams
from repro_torch.kernels import ops


def brute_force_topk(q: torch.Tensor, rows: torch.Tensor,
                     params: SearchParams, valid: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact scan through the fused rerank's arithmetic: (B, k) dists + row
    ids.

    The scan is ``ops.fused_scan``: the fused rerank over ids = arange(N)
    for every query (mask = ``valid``, dedup off, +inf / -1 past the live
    rows), so a row scores the same whichever backend holds it.  On the
    card that is kernel B's query-tiled scan, which scores every pair bit
    for bit as the gather kernel does; on the CPU, the gather's plain
    version over arange(N).  ``params.chunk`` does not change the answer
    and is not read.
    """
    return ops.fused_scan(q, rows, params.k, params.metric, valid,
                          params.mode)
