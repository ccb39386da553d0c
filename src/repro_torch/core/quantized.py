"""int8-quantized database with an fp32 rerank (port of
``repro/core/quantized.py``).

The rerank is bound by the bytes of the candidate rows.  Storing the rows
in int8 with one f32 scale per row cuts them 4x; coarse distances on the
dequantized rows pick a k' = expand*k shortlist that is reranked against
the fp32 rows.  The production path is ``core.pipeline.fused_query`` with a
``QuantizedDB`` (or ``build_index(backend="rpf+int8")``); the staged
functions here gather the (B, M, d) int8 block and are the oracle only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.forest import (Forest, ForestConfig, gather_candidates,
                                     traverse)
from repro_torch.core.search import mask_duplicates, rerank_topk
from repro_torch.kernels.common import POS_INF, topk_smallest


class QuantizedDB(NamedTuple):
    q: torch.Tensor         # (N, d) int8
    scale: torch.Tensor     # (N,) f32 per-row scale
    fp: torch.Tensor        # (N, d) f32 full-precision rows (rerank source)


def quantize_db(db: torch.Tensor) -> QuantizedDB:
    """Symmetric per-row int8: scale = max|row| / 127 + 1e-12, q8 =
    clip(round(row / scale), -127, 127), rounding half to even as
    ``jnp.round`` does."""
    scale = torch.amax(torch.abs(db), dim=1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(db / scale[:, None]), -127, 127)
    return QuantizedDB(q=q.to(torch.int8).contiguous(), scale=scale, fp=db)


def staged_rerank_quantized(queries: torch.Tensor, cand_ids: torch.Tensor,
                            mask: torch.Tensor, qdb: QuantizedDB, k: int,
                            expand: int = 4
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse int8 l2 shortlist (k' = expand*k) -> exact fp32 rerank.

    ORACLE ONLY: gathers the full (B, M, d) int8 candidate block.
    """
    mask = mask_duplicates(cand_ids, mask)
    safe = torch.where(mask, cand_ids, 0).long()
    deq = qdb.q[safe].float() * qdb.scale[safe][:, :, None]
    d = torch.sum((queries[:, None, :] - deq) ** 2, dim=-1)
    d = torch.where(mask, d, POS_INF)
    kp = min(expand * k, cand_ids.shape[1])
    _, pos = topk_smallest(d, kp)
    short_ids = torch.gather(cand_ids, 1, pos)
    short_mask = torch.gather(mask, 1, pos)
    return rerank_topk(queries, short_ids, short_mask, qdb.fp, k=k,
                       dedup=False)


def staged_query_quantized(forest: Forest, queries: torch.Tensor,
                           qdb: QuantizedDB, k: int, cfg: ForestConfig,
                           expand: int = 4
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The unfused quantized query, the correctness oracle."""
    cfg = cfg.resolved(qdb.fp.shape[0])
    leaves = traverse(forest, queries, cfg.max_depth)
    cand_ids, mask = gather_candidates(forest, leaves, cfg.leaf_pad)
    return staged_rerank_quantized(queries, cand_ids, mask, qdb, k=k,
                                   expand=expand)


def query_forest_quantized(forest: Forest, queries: torch.Tensor,
                           qdb: QuantizedDB, k: int, cfg: ForestConfig,
                           expand: int = 4, metric: str = "l2",
                           mode: str = "auto",
                           device: str | torch.device | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Deprecated shim: use ``pipeline.fused_query(forest, q, qdb, ...)``
    or ``build_index(backend="rpf+int8")``.  Runs the fused pipeline with
    the int8 shortlist source."""
    from repro_torch.core import pipeline  # local import: pipeline imports us

    return pipeline.fused_query(forest, queries, qdb, k, cfg, metric=metric,
                                mode=mode, expand=expand, device=device)
