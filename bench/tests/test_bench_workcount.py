"""The roofline's work counts against arithmetic done by hand on a tiny
forest."""
import torch

from bench import workcount
from bench.reference import search as rsearch
from bench.reference.forest import Forest


def two_trees():
    """Two trees over 6 points, max_nodes 3: tree 0 splits coordinate 0 at
    0.5 (leaves 1: points 0, 1, 2; 2: points 3, 4, 5), tree 1 is one leaf
    holding all 6 points."""
    m = 3
    feat = torch.zeros((2, m, 1), dtype=torch.int32)
    thresh = torch.tensor([[0.5, 0.0, 0.0], [0.0, 0.0, 0.0]])
    child = torch.tensor([[1, -1, -1], [-1, -1, -1]], dtype=torch.int32)
    perm = torch.tensor([[0, 1, 2, 3, 4, 5], [0, 1, 2, 3, 4, 5]],
                        dtype=torch.int32)
    off = torch.tensor([[0, 0, 3], [0, 6, 6]], dtype=torch.int32)
    cnt = torch.tensor([[0, 3, 3], [6, 0, 0]], dtype=torch.int32)
    return Forest(feat, torch.ones((2, m, 1)), thresh, child, perm, off, cnt,
                  torch.tensor([3, 1], dtype=torch.int32))


def test_rerank_counts_by_hand():
    # query 0 sees ids 0, 1, 2 and 5; query 1 sees 2, 3 (and -1 slots)
    cand = torch.tensor([[0, 1, 2, 5], [-1, 2, 3, -1]])
    ops, nbytes = workcount.rerank_work(cand, d=4, k=2, metric="l2")
    # 6 pairs x 4 dims x 3 ops; 5 distinct rows (0, 1, 2, 3, 5) x 16 bytes
    # + 2 queries x 16 + 2 x 2 outputs x 8
    assert ops == 6 * 4 * 3
    assert nbytes == 5 * 16 + 2 * 16 + 2 * 2 * 8
    ops, _ = workcount.rerank_work(cand, d=4, k=2, metric="chi2")
    assert ops == 6 * 4 * 6


def test_forest_bytes_by_hand():
    forest = two_trees()
    q = torch.tensor([[0.2, 0.0], [0.9, 0.0]])
    visited = []
    leaves = rsearch.descend(forest, q, max_depth=2, n_probes=1,
                             visited=visited)
    assert leaves[..., 0].tolist() == [[1, 2], [0, 0]]
    got = workcount.forest_bytes(visited, leaves, forest.leaf_count,
                                 max_nodes=3, pad=4)
    # nodes read: tree 0 {0, 1, 2}, tree 1 {0}: 4 x 12 bytes; leaves
    # probed: (0, 1), (0, 2), (1, 0): 3 x 8 bytes; ids sliced: 3 + 3 +
    # min(6, pad 4) = 10 x 4 bytes
    assert got == 4 * 12 + 3 * 8 + 10 * 4


def test_least_time():
    assert workcount.least_seconds(67e12, 0) == 1.0
    assert workcount.least_seconds(0, 3.35e12) == 1.0
    assert workcount.least_seconds(67e12, 6.7e12) == 2.0
