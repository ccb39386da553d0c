"""The work a search needs, counted from the reference's candidate lists,
and the card's peaks: the yardstick of the roofline metrics.

The counts are what these inputs need, whatever implements them:

  rerank ops    distinct valid (query, candidate) pairs x d x the
                operations of one term as the plain metric writes it: l2
                (q - c)^2 summed is a subtract, a multiply and an add (3);
                chi2 (q - c)^2 / (q + c + eps) summed is a subtract, a
                multiply, two adds, a divide and the add of the sum (6)
  rerank bytes  each distinct row the batch's candidates touch, read once
                (d x 4 bytes), the queries (B x d x 4), and the (B, k)
                outputs (a 4-byte distance and a 4-byte id each)
  forest bytes  each distinct (tree, node) the descent visits, its
                coordinate, threshold and child read once (3 x 4 bytes),
                and each distinct probed leaf's offset and count (2 x 4)
                and the ids of its first ``pad`` points (4 each)

A least time is the larger of ops / PEAK_FLOPS and bytes / PEAK_BYTES.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet (at the 700 W limit): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TERM_OPS = {"l2": 3, "chi2": 6}
NODE_BYTES = 12
LEAF_BYTES = 8
ID_BYTES = 4


def rerank_work(cand: torch.Tensor, d: int, k: int, metric: str
                ) -> tuple[int, int]:
    """(ops, bytes) of one batch's rerank; cand (B, M) distinct ids per
    row, -1 in empty slots."""
    valid = cand >= 0
    pairs = int(valid.sum())
    rows = int(torch.unique(cand[valid]).numel())
    b = cand.shape[0]
    return pairs * d * TERM_OPS[metric], 4 * (rows * d + b * d) + 8 * b * k


def forest_bytes(visited: list, leaves: torch.Tensor, leaf_count: torch.Tensor,
                 max_nodes: int, pad: int) -> int:
    """Bytes of one batch's descent and leaf slice: ``visited`` the (L, B,
    A) node ids of each level the descent read, ``leaves`` the (L, B, P)
    probed leaves (-1 absent), ``leaf_count`` the forest's (L, max_nodes)."""
    n_trees = leaves.shape[0]
    tree = torch.arange(n_trees, device=leaves.device).view(-1, 1, 1)
    nodes = torch.unique(torch.cat([(tree * max_nodes + v).reshape(-1)
                                    for v in visited])) if visited else []
    ok = leaves >= 0
    keys = torch.unique((tree * max_nodes + leaves.long())[ok])
    counts = leaf_count.reshape(-1)[keys].long().clamp(max=pad)
    return (NODE_BYTES * len(nodes) + LEAF_BYTES * keys.numel()
            + ID_BYTES * int(counts.sum()))


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
