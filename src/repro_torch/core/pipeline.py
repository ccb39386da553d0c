"""Fused forest query pipeline: traverse -> dedup -> rerank (port of
``repro/core/pipeline.py``, fp32 rerank source).

The paper's query is "descend the L trees, union the leaf sets, rerank
exactly".  ``fused_query`` runs it as: the descent kernel gives the (L, B)
or (L, B, P) leaves, the leaves' CSR slices give the (B, M) candidate id
matrix, duplicates and dead rows become -1 slots, and the fused gather +
distance + top-k kernel reranks them without ever writing the gathered
(B, M, d) block.

Chunking: the reference streamed the candidate axis in chunks sized by the
TPU's scalar-memory budget.  On the GPU the ids live in device memory, so a
kernel launch takes the whole M at once unless the caller asks for
``chunk``; the plain version, which does gather (B, c, d), streams chunks
under ``GATHER_BUDGET_BYTES``.  Chunk results merge with the associative
top-k (ties to the earlier chunk), so the answer does not depend on the
chunking.  Both rerank sources -- fp32 rows and the int8 shortlist
(``rerank_fused_quantized``) -- stream through the same ``_stream_rerank``.
``staged_query`` is the unfused oracle.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.core.forest import (Forest, ForestConfig, gather_candidates,
                                     gather_candidates_multi, traverse,
                                     traverse_forest)
from repro_torch.core.quantized import QuantizedDB
from repro_torch.core.search import (mask_duplicates, merge_topk_pairs,
                                     rerank_topk)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.common import GATHER_BUDGET_BYTES, POS_INF


def pick_rerank_chunk(b: int, m: int, d: int, chunk: int, k: int,
                      kernel: bool) -> int:
    """Candidate-axis chunk width: an explicit ``chunk`` (at least k), else
    all of M for the kernel and the gather budget for the plain version."""
    if chunk > 0:
        return min(max(chunk, k), m)
    if kernel:
        return m
    by_budget = GATHER_BUDGET_BYTES // (4 * max(b, 1) * max(d, 1))
    return min(m, max(by_budget, k))


def _stream_rerank(queries: torch.Tensor, ids: torch.Tensor, k: int,
                   rerank, kernel: bool, chunk: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the (B, M) id matrix, one ``rerank(q, ids_chunk)`` per
    candidate chunk, merged with ties to the earlier chunk."""
    with tracing.span("pipeline.rerank"):
        b, m = ids.shape
        c = pick_rerank_chunk(b, m, queries.shape[1], chunk, k, kernel)
        if c >= m:
            return rerank(queries, ids)
        best_d = queries.new_full((b, k), POS_INF)
        best_i = torch.full((b, k), -1, dtype=torch.int32, device=ids.device)
        for lo in range(0, m, c):
            dd, ii = rerank(queries, ids[:, lo:lo + c].contiguous())
            best_d, best_i = merge_topk_pairs(
                torch.cat([best_d, dd], dim=1),
                torch.cat([best_i, ii], dim=1), k)
        return best_d, torch.where(torch.isinf(best_d), -1, best_i)


def _valid_ids(cand_ids: torch.Tensor, mask: torch.Tensor, dedup: bool,
               valid: torch.Tensor | None) -> torch.Tensor:
    """(B, M) ids with dead rows, masked slots and (``dedup``) repeats
    turned to -1."""
    with tracing.span("pipeline.dedup"):
        if valid is not None:
            mask = mask & valid[cand_ids.long().clamp(0, valid.shape[0] - 1)]
        if dedup:
            mask = mask_duplicates(cand_ids, mask)
        return torch.where(mask, cand_ids, -1).int()


def rerank_fused(queries: torch.Tensor, cand_ids: torch.Tensor,
                 mask: torch.Tensor, db: torch.Tensor, k: int,
                 metric: str = "l2", mode: str = "auto", dedup: bool = True,
                 chunk: int = 0, valid: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, M) candidate ids -> top-k through the fused kernel.

    ``valid`` is an optional (N,) bool row-validity mask (tombstones): a
    dead row's slots become -1 before the kernel, so they load nothing and
    never take a top-k place.
    """
    ids = _valid_ids(cand_ids, mask, dedup, valid)
    return _stream_rerank(
        queries, ids, k,
        lambda q, i: ops.fused_rerank(q, i, db, k, metric, mode),
        ops.use_kernel(mode, queries), chunk)


def rerank_fused_quantized(queries: torch.Tensor, cand_ids: torch.Tensor,
                           mask: torch.Tensor, qdb: QuantizedDB, k: int,
                           expand: int = 4, metric: str = "l2",
                           mode: str = "auto", dedup: bool = True,
                           chunk: int = 0, valid: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 shortlist, then the exact fp32 rerank of the shortlist.

    Stage 1 scores the dequantized int8 rows under ``metric`` through the
    fused int8 kernel (d + 4 bytes per candidate) and keeps the k' =
    min(expand*k, M) best; ``valid`` and dedup apply here, so dead or
    repeated rows never take a shortlist place.  Stage 2 reranks the
    (B, k') shortlist against ``qdb.fp`` through the fp32 fused kernel
    with dedup off; the shortlist keeps stage 1's slot order, so stage 2's
    ties go to the earlier shortlist slot, as in the reference.  A
    shortlist of k' = 0 (``expand`` 0) raises ``ValueError``, as the
    reference's top-k does.
    """
    if expand * k < 1:
        raise ValueError(f"the int8 shortlist needs k' = expand * k >= 1, "
                         f"got expand={expand}, k={k}")
    ids = _valid_ids(cand_ids, mask, dedup, valid)
    kp = min(expand * k, ids.shape[1])
    _, short_i = _stream_rerank(
        queries, ids, kp,
        lambda q, i: ops.fused_rerank_int8(q, i, qdb.q, qdb.scale, kp,
                                           metric, mode),
        ops.use_kernel(mode, queries), chunk)
    return rerank_fused(queries, short_i, short_i >= 0, qdb.fp, k,
                        metric=metric, mode=mode, dedup=False, chunk=chunk)


def candidates(forest: Forest, queries: torch.Tensor, max_depth: int,
               leaf_pad: int, n_probes: int, mode: str = "auto"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Traverse + CSR slice: (B, M) candidate ids and mask, M = L*P*pad."""
    with tracing.span("pipeline.descend"):
        leaves = traverse_forest(forest, queries, max_depth, n_probes, mode)
    with tracing.span("pipeline.slice"):
        if n_probes <= 1:
            return gather_candidates(forest, leaves, leaf_pad)
        return gather_candidates_multi(forest, leaves, leaf_pad)


def fused_query(forest: Forest, queries: torch.Tensor,
                db: torch.Tensor | QuantizedDB, k: int, cfg: ForestConfig,
                metric: str = "l2", dedup: bool = True, mode: str = "auto",
                chunk: int = 0, expand: int = 4, n_probes: int = 1,
                valid: torch.Tensor | None = None,
                device: str | torch.device | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """End-to-end forest query, the production path.

    ``db`` picks the rerank source: (N, d) f32 rows rerank every candidate
    exactly; a ``QuantizedDB`` runs the int8 shortlist of k' = ``expand``*k
    first and reranks only that.  ``n_probes`` > 1 descends to that many
    most-marginal leaves per tree; ``valid`` optionally masks dead db rows.
    Runs on ``device`` (the GPU unless ``device="cpu"``); the forest and db
    must already live there.  Returns (dists (B, k), ids (B, k)); invalid
    slots: +inf / -1.
    """
    with tracing.span("pipeline.query"):
        dev = resolve_device(device)
        queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        queries = queries.contiguous()
        quantized = isinstance(db, QuantizedDB)
        cfg = cfg.resolved((db.fp if quantized else db).shape[0])
        cand_ids, mask = candidates(forest, queries, cfg.max_depth,
                                    cfg.leaf_pad, n_probes, mode)
        if quantized:
            return rerank_fused_quantized(queries, cand_ids, mask, db, k,
                                          expand=expand, metric=metric,
                                          mode=mode, dedup=dedup,
                                          chunk=chunk, valid=valid)
        return rerank_fused(queries, cand_ids, mask, db, k, metric=metric,
                            mode=mode, dedup=dedup, chunk=chunk, valid=valid)


def staged_query(forest: Forest, queries: torch.Tensor, db: torch.Tensor,
                 k: int, cfg: ForestConfig, metric: str = "l2",
                 dedup: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The unfused pipeline, the correctness oracle: K-general descent,
    CSR slice, and a rerank over the gathered (B, M, d) block."""
    cfg = cfg.resolved(db.shape[0])
    leaves = traverse(forest, queries, cfg.max_depth)
    cand_ids, mask = gather_candidates(forest, leaves, cfg.leaf_pad)
    return rerank_topk(queries, cand_ids, mask, db, k=k, metric=metric,
                       dedup=dedup)
