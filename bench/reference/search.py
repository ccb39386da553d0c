"""The plain forest query, frozen: descent, leaf slice, dedup, exact rerank.

A query descends every tree from the root, taking the right child where
its coordinate ``q[feat] >= thresh``.  With P probes a tree gives P leaves:
the primary one, then the P - 1 paths that flip the decision at the
smallest margins ``|q[feat] - thresh|`` of the primary path (ties to the
shallower depth), each leaf -1 where no finite margin is left.  The
candidates are the first ``pad`` points of each probed leaf, each distinct
id once.  The answer is the k candidates nearest under the metric, by
(distance, id), computed in float64.

``rerank(..., precision=)`` is the control: the same top-k with the rows
and queries rounded to ``precision`` and the distance summed in float32.

This file imports nothing of the program.
"""
from __future__ import annotations

import torch

from bench.reference.forest import Forest, round_to

BLOCK_BYTES = 1 << 30      # the largest gathered block a rerank holds


def _terms(q: torch.Tensor, c: torch.Tensor, metric: str) -> torch.Tensor:
    t = q - c
    if metric == "l2":
        return t * t
    if metric == "chi2":
        return t * t / (q + c + 1e-12)
    raise ValueError(f"the reference scores l2 or chi2, not {metric!r}")


def distance(q: torch.Tensor, c: torch.Tensor, metric: str) -> torch.Tensor:
    """sum over the last axis of the metric's terms, in q's and c's dtype."""
    return _terms(q, c, metric).sum(dim=-1)


def descend(forest: Forest, queries: torch.Tensor, max_depth: int,
            n_probes: int, visited: list | None = None) -> torch.Tensor:
    """(L, B, P) leaf ids, -1 for an absent probe.  ``visited``, when given,
    receives each level's (L, B, A) node ids, the nodes the descent read."""
    feat = forest.proj_idx[..., 0].long()
    thresh, child = forest.thresh, forest.child_base.long()
    n_trees, b = thresh.shape[0], queries.shape[0]
    l_idx = torch.arange(n_trees, device=thresh.device).view(-1, 1, 1)
    b_idx = torch.arange(b, device=thresh.device).view(1, -1, 1)
    n_alt = max(0, min(n_probes - 1, max_depth))

    def level(node, flip):
        if visited is not None:
            visited.append(node)
        y = queries[b_idx, feat[l_idx, node]]
        th = thresh[l_idx, node]
        cb = child[l_idx, node]
        internal = cb >= 0
        right = y >= th
        if flip is not None:
            right = right ^ flip
        return torch.where(internal, cb + right.long(), node), internal, \
            (y - th).abs()

    node = torch.zeros((n_trees, b, 1), dtype=torch.long,
                       device=thresh.device)
    margins = []
    for _ in range(max_depth):
        node, internal, margin = level(node, None)
        margins.append(torch.where(internal, margin, float("inf")))
    probes = [node]
    if n_alt:
        margins = torch.cat(margins, dim=-1)              # (L, B, depth)
        best, flip_at = torch.sort(margins, dim=-1, stable=True)
        best, flip_at = best[..., :n_alt], flip_at[..., :n_alt]
        alt = torch.zeros_like(flip_at)
        for t in range(max_depth):
            alt = level(alt, flip_at == t)[0]
        probes.append(torch.where(torch.isfinite(best), alt, -1))
    out = torch.cat(probes, dim=-1)
    if out.shape[-1] < n_probes:
        out = torch.nn.functional.pad(out, (0, n_probes - out.shape[-1]),
                                      value=-1)
    return out


def candidates(forest: Forest, leaves: torch.Tensor, pad: int
               ) -> torch.Tensor:
    """(B, L * P * pad) ids of the probed leaves' first ``pad`` points, each
    distinct id once (sorted), -1 in the empty and repeated slots."""
    n_trees, b, p = leaves.shape
    l_idx = torch.arange(n_trees, device=leaves.device).view(-1, 1, 1)
    ok = leaves >= 0
    leaf = leaves.clamp_min(0).long()
    off = forest.leaf_offset[l_idx, leaf].long()
    cnt = torch.where(ok, forest.leaf_count[l_idx, leaf].long(), 0)
    slot = torch.arange(pad, device=leaves.device)
    pos = (off[..., None] + slot).clamp(0, forest.perm.shape[1] - 1)
    ids = torch.where(slot < cnt[..., None],
                      forest.perm[l_idx[..., None], pos].long(), -1)
    ids = ids.permute(1, 0, 2, 3).reshape(b, -1)
    ids = torch.sort(ids, dim=1)[0]
    repeat = torch.zeros_like(ids, dtype=torch.bool)
    repeat[:, 1:] = ids[:, 1:] == ids[:, :-1]
    return torch.where(repeat, -1, ids)


def rerank(queries: torch.Tensor, cand: torch.Tensor, rows: torch.Tensor,
           k: int, metric: str, precision: str = "fp64"
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest of each query's candidates (-1 slots skipped) by
    (distance, id): (B, k) distances and ids, +inf / -1 past the valid
    candidates.  "fp64" computes in float64; any other ``precision`` rounds
    rows and queries to it and sums in float32 (the control)."""
    b, m = cand.shape
    d = rows.shape[1]
    dtype = torch.float64 if precision == "fp64" else torch.float32
    step = max(1, BLOCK_BYTES // max(1, m * d * 8))
    out_d, out_i = [], []
    for lo in range(0, b, step):
        c = cand[lo:lo + step]
        q = queries[lo:lo + step]
        r = rows[c.clamp_min(0)]
        if precision != "fp64":
            q, r = round_to(q.float(), precision), round_to(r.float(),
                                                             precision)
        dist = distance(q.to(dtype)[:, None, :], r.to(dtype), metric)
        dist = torch.where(c >= 0, dist, float("inf"))
        # by distance, then by id: the ids are sorted, so a stable sort by
        # distance keeps the smaller id first among equals
        dist, order = torch.sort(dist, dim=1, stable=True)
        ids = torch.gather(c, 1, order)[:, :k]
        dist = dist[:, :k]
        short = k - dist.shape[1]
        if short > 0:
            dist = torch.nn.functional.pad(dist, (0, short),
                                           value=float("inf"))
            ids = torch.nn.functional.pad(ids, (0, short), value=-1)
        out_d.append(dist)
        out_i.append(torch.where(torch.isinf(dist), -1, ids))
    return torch.cat(out_d), torch.cat(out_i)


def query(forest: Forest, queries: torch.Tensor, rows: torch.Tensor, k: int,
          metric: str, max_depth: int, n_probes: int, pad: int,
          precision: str = "fp64") -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The whole query: (distances, ids, candidates)."""
    cand = candidates(forest, descend(forest, queries, max_depth, n_probes),
                      pad)
    d, i = rerank(queries, cand, rows, k, metric, precision)
    return d, i, cand
