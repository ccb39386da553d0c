"""Plain PyTorch versions of the CUDA kernels (port of ``repro/kernels/ref.py``).

Each mirrors its kernel's contract exactly: shapes, dtypes, -1 slots and
tie-breaking.  They are what a wrapper runs for tensors on the CPU, what
``mode="ref"`` forces, and what ``chip_smoke.py`` holds the kernels
against on the card.  Each call adds one to ``REF_CALLS[<name>]``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.distances import METRICS
from repro_torch.kernels.common import (EPS, GATHER_BUDGET_BYTES, POS_INF,
                                        REF_CALLS, blockwise_topk,
                                        topk_smallest)


def fused_gather_topk_ref(q: torch.Tensor, ids: torch.Tensor,
                          db: torch.Tensor, k: int, metric: str = "l2"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.fused_query.fused_gather_topk``.

    q (B, d), ids (B, M) int32 with -1 marking invalid slots, db (N, d) ->
    (dists (B, k) f32, ids (B, k) int32), ascending, ties to the earliest
    slot; +inf / -1 where fewer than k slots are valid.  Unlike the kernel
    it gathers the (B, M, d) candidate block, so callers bound M.
    """
    REF_CALLS["fused_gather_topk"] += 1
    valid = ids >= 0
    cand = db[ids.clamp(0, db.shape[0] - 1).long()].float()     # (B, M, d)
    scores = METRICS[metric](q.float()[:, None, :], cand)
    scores = torch.where(valid, scores, POS_INF)
    d, pos = topk_smallest(scores, k)
    i = torch.gather(ids, 1, pos.clamp_min(0))
    return d, torch.where(torch.isinf(d), -1, i)


def fused_gather_topk_int8_ref(q: torch.Tensor, ids: torch.Tensor,
                               q8: torch.Tensor, scale: torch.Tensor, k: int,
                               metric: str = "l2"
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.fused_query_int8.fused_gather_topk_int8``.

    The dequant-gather of the reference's oracle: each valid slot's int8
    row times its f32 scale (one rounded product), scored under ``metric``
    against q; ascending, ties to the earliest slot, +inf / -1 past the
    valid slots.  It gathers the (B, M, d) block, so callers bound M.
    """
    REF_CALLS["fused_gather_topk_int8"] += 1
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    deq = q8[safe].float() * scale[safe][:, :, None]             # (B, M, d)
    scores = METRICS[metric](q.float()[:, None, :], deq)
    scores = torch.where(valid, scores, POS_INF)
    d, pos = topk_smallest(scores, k)
    i = torch.gather(ids, 1, pos.clamp_min(0))
    return d, torch.where(torch.isinf(d), -1, i)


def distance_topk_ref(q: torch.Tensor, cand: torch.Tensor, ids: torch.Tensor,
                      mask: torch.Tensor, k: int, metric: str = "l2"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.distance_topk.distance_topk``.

    q (B, d), cand (B, M, d) pre-gathered rows, ids (B, M) int32, mask
    (B, M) bool -> (dists (B, k) f32, ids (B, k) int32): l2 or chi2 of
    every slot, +inf where masked, then the reference's
    ``lexsort((ids, scores))``, so ties go to the smaller id (a stable sort
    by id, then a stable sort by score).  +inf / -1 past the valid slots,
    and where k > M (the reference's plain version returns min(k, M)
    columns there; its kernel pads to k, as this does).
    """
    REF_CALLS["distance_topk"] += 1
    if metric not in ("l2", "chi2"):
        raise ValueError(f"distance_topk scores l2 or chi2, not {metric!r}")
    scores = METRICS[metric](q.float()[:, None, :], cand.float())
    scores = torch.where(mask, scores, POS_INF)
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    d, pos = topk_smallest(torch.gather(scores, 1, by_id), k)
    i = torch.gather(ids, 1, torch.gather(by_id, 1, pos.clamp_min(0)))
    return d, torch.where(torch.isinf(d), -1, i)


def embedding_bag_ref(ids: torch.Tensor, weights: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.embedding_bag.embedding_bag``: ids (B, H)
    int32, weights (B, H) f32, table (V, D) -> (B, D) f32, the sum over h
    of ``weights[b, h] * table[ids[b, h]]``.  Padding is id 0 with weight
    0, and its product is taken like any other, as in the reference.  An
    id outside [0, V) is clamped, as the reference's gather clamps it."""
    REF_CALLS["embedding_bag"] += 1
    rows = table[ids.long().clamp(0, table.shape[0] - 1)].float()  # (B, H, D)
    return torch.sum(rows * weights.float()[..., None], dim=1)


def matmul_topk_ref(q: torch.Tensor, db: torch.Tensor, k: int,
                    metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.matmul_topk.matmul_topk``: exact scan, l2
    as |q|^2 - 2 q.c + |c|^2 (not clamped) or dot as -q.c; ascending, ties
    to the smaller id, +inf / -1 where k > N.  The product is
    ``torch.matmul`` in fp32 (TF32 must be off on the card)."""
    REF_CALLS["matmul_topk"] += 1
    if metric not in ("l2", "dot"):
        raise ValueError(f"matmul_topk scores l2 or dot, not {metric!r}")
    if q.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("matmul_topk_ref needs fp32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    qf = q.float()
    q_sq = torch.sum(qf * qf, dim=1)[:, None]

    def score(qq, blk):
        cross = qq @ blk.float().T
        if metric == "dot":
            return -cross
        return q_sq - 2 * cross + torch.sum(blk.float() ** 2, dim=1)[None, :]

    block = max(GATHER_BUDGET_BYTES // (4 * max(q.shape[0], 1)), k)
    return blockwise_topk(qf, db, k, score, block)


def chi2_topk_ref(q: torch.Tensor, db: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.chi2_topk.chi2_topk``: exact scan of
    sum (q - c)^2 / (q + c + 1e-12); ascending, ties to the smaller id,
    +inf / -1 where k > N.  The reference broadcasts the whole (B, N, d)
    block; this streams db blocks under ``GATHER_BUDGET_BYTES``."""
    REF_CALLS["chi2_topk"] += 1

    def score(qq, blk):
        x, y = qq[:, None, :], blk.float()[None, :, :]
        return torch.sum((x - y) ** 2 / (x + y + EPS), dim=-1)

    b, d = q.shape
    block = max(GATHER_BUDGET_BYTES // (4 * max(b, 1) * max(d, 1)), 1)
    return blockwise_topk(q.float(), db, k, score, block)


def chi2_topk_dordered(q: torch.Tensor, db: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``chi2_topk_ref`` with kernel E's order of sums: each pair's terms
    t = q - c; t * t / ((q + c) + 1e-12) are added one by one in d order
    in fp32, so its distances are bitwise the kernel's (``torch.sum``
    adds them in another order).  One elementwise pass per dimension: for
    tests and ``chip_smoke.py``'s slab check, not for full-size scans."""
    REF_CALLS["chi2_topk_dordered"] += 1

    def score(qq, blk):
        acc = qq.new_zeros((qq.shape[0], blk.shape[0]))
        for j in range(qq.shape[1]):
            x, y = qq[:, j, None], blk[None, :, j].float()
            t = x - y
            acc = acc + t * t / (x + y + EPS)
        return acc

    b = q.shape[0]
    block = max(GATHER_BUDGET_BYTES // (4 * max(b, 1)), 1)
    return blockwise_topk(q.float(), db, k, score, block)


def descend(project: Callable[[torch.Tensor], torch.Tensor],
            thresh: torch.Tensor, child_base: torch.Tensor, n_queries: int,
            max_depth: int, n_probes: int) -> torch.Tensor:
    """Batched forest descent, single- or multi-probe, for any projection.

    ``project(node)`` maps node ids (L, B, A) to the queries' projections
    (L, B, A) under those nodes' tests.  Probe 0 is the primary leaf; each
    alternate re-descends with the decision flipped at the next-smallest
    margin ``|y - thresh|`` of the primary path (ties to the shallower
    depth); a slot is -1 once no finite margin is left, including the
    slots past ``max_depth + 1``.  Returns (L, B) int32 for
    ``n_probes == 1``, else (L, B, n_probes).
    """
    n_trees = thresh.shape[0]
    l_idx = torch.arange(n_trees, device=thresh.device).view(-1, 1, 1)
    n_alt = max(0, min(n_probes - 1, max_depth))

    def level(node, flip):
        y = project(node)
        th = thresh[l_idx, node]
        cb = child_base[l_idx, node].long()
        internal = cb >= 0
        go_right = y >= th
        if flip is not None:
            go_right = go_right ^ flip
        return torch.where(internal, cb + go_right.long(), node), internal, \
            y, th

    node = torch.zeros((n_trees, n_queries, 1), dtype=torch.long,
                       device=thresh.device)
    margins = []
    for _ in range(max_depth):
        node, internal, y, th = level(node, None)
        margins.append(torch.where(internal, torch.abs(y - th), POS_INF))
    probes = [node]
    if n_alt:
        margins = torch.cat(margins, dim=-1)                # (L, B, depth)
        best, flip_depth = topk_smallest(margins, n_alt)    # (L, B, n_alt)
        alt = torch.zeros_like(flip_depth)
        for t in range(max_depth):
            alt = level(alt, flip_depth == t)[0]
        probes.append(torch.where(torch.isfinite(best), alt, -1))
    out = torch.cat(probes, dim=-1)
    if out.shape[-1] < n_probes:
        out = torch.nn.functional.pad(out, (0, n_probes - out.shape[-1]),
                                      value=-1)
    out = out.int()
    return out[..., 0] if n_probes == 1 else out


def forest_traverse_ref(feat: torch.Tensor, thresh: torch.Tensor,
                        child_base: torch.Tensor, queries: torch.Tensor,
                        max_depth: int, n_probes: int = 1) -> torch.Tensor:
    """Plain version of ``kernels.forest_traverse_hbm.forest_traverse_hbm``.

    The forest-level twin of the reference's single-tree
    ``forest_traverse_ref`` / ``forest_traverse_multiprobe_ref`` (a single
    tree is L = 1): K = 1 trees, feat / thresh / child_base (L, max_nodes),
    queries (B, d) -> leaf ids (L, B), or (L, B, n_probes) with -1 for
    absent probes.  The test is the raw coordinate, ``q[b, feat] >= thresh``.
    """
    REF_CALLS["forest_traverse"] += 1
    l_idx = torch.arange(feat.shape[0], device=feat.device).view(-1, 1, 1)
    b_idx = torch.arange(queries.shape[0], device=feat.device).view(1, -1, 1)

    def project(node):
        return queries[b_idx, feat[l_idx, node].long()]

    return descend(project, thresh, child_base, queries.shape[0], max_depth,
                   n_probes)


def forest_traverse_tree_ref(feat: torch.Tensor, thresh: torch.Tensor,
                             child_base: torch.Tensor, queries: torch.Tensor,
                             max_depth: int, n_probes: int = 1
                             ) -> torch.Tensor:
    """Plain version of ``kernels.forest_traverse.forest_traverse``, the
    single-tree descent: the reference's ``forest_traverse_ref`` (n_probes
    = 1) and ``forest_traverse_multiprobe_ref`` in one, as the forest
    version at L = 1.  feat / thresh / child_base (max_nodes,), queries
    (B, d) -> (B,) int32 leaf ids, or (B, n_probes) with -1 for absent
    probes."""
    REF_CALLS["forest_traverse_smem"] += 1
    b_idx = torch.arange(queries.shape[0], device=feat.device).view(1, -1, 1)

    def project(node):
        return queries[b_idx, feat[node].long()]

    return descend(project, thresh[None], child_base[None], queries.shape[0],
                   max_depth, n_probes)[0]
