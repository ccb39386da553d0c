"""Candidate dedup, rerank and top-k (port of ``repro/core/search.py``).

``rerank_topk`` is the staged oracle: it gathers the full (B, M, d)
candidate block before scoring.  Production queries go through
``core.pipeline``.  Every selection is a stable sort, so ties break the way
the reference's ``lax.top_k`` and stable ``argsort`` break them.
"""
from __future__ import annotations

import torch

from repro_torch.core import distances as dist_mod
from repro_torch.kernels.common import POS_INF, topk_smallest


def mask_duplicates(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mask repeated candidate ids per row, keeping the first occurrence."""
    big = torch.iinfo(torch.int32).max
    keyed = torch.where(mask, ids, big)
    sorted_ids, order = torch.sort(keyed, dim=1, stable=True)
    dup = torch.zeros_like(mask)
    dup[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    dup_orig = torch.empty_like(dup).scatter_(1, order, dup)
    return mask & ~dup_orig


def rerank_topk(queries: torch.Tensor, cand_ids: torch.Tensor,
                mask: torch.Tensor, db: torch.Tensor, k: int,
                metric: str = "l2", dedup: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact distances to the candidates + top-k (the staged oracle).

    queries (B, d); cand_ids / mask (B, M); db (N, d) -> (dists (B, k),
    ids (B, k)); invalid slots: +inf / -1.
    """
    if dedup:
        mask = mask_duplicates(cand_ids, mask)
    cand = db[cand_ids.long()]                                   # (B, M, d)
    d = dist_mod.METRICS[metric](queries[:, None, :], cand)
    d = torch.where(mask, d, POS_INF)
    dists, pos = topk_smallest(d, k)
    ids = torch.gather(cand_ids, 1, pos.clamp_min(0))
    return dists, torch.where(torch.isinf(dists), -1, ids)


def merge_topk_pairs(dists: torch.Tensor, ids: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Associative (B, m) -> (B, k) merge; entries with id -1 are ignored
    and ties go to the earlier position."""
    d, pos = topk_smallest(torch.where(ids >= 0, dists, POS_INF), k)
    return d, torch.gather(ids, 1, pos.clamp_min(0))


def recall_at_k(pred_ids: torch.Tensor, true_ids: torch.Tensor) -> float:
    """Fraction of the true k-NN ids recovered (order-insensitive)."""
    hits = (pred_ids[:, :, None] == true_ids[:, None, :]).any(dim=1)
    return float(hits.float().mean())
