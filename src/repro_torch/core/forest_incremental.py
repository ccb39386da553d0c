"""The paper's incremental tree builder (Zhong 2015, Fig. 1 / 3) in numpy
(a copy of ``repro/core/forest_incremental.py``; the port keeps its own
copy so it never imports the reference).

The semantics oracle: points are inserted one at a time in random order, a
leaf splits when its count exceeds C, and the split hyper-plane is Eq. 1 with
the threshold a random value between the r and 1 - r percentiles of the
node's points.  Tests hold the level-synchronous builder (``core.forest``) to
the same partition invariants.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class _Node:
    # internal: test (idx, coef, thresh); leaf: point id list
    idx: Optional[np.ndarray] = None
    coef: Optional[np.ndarray] = None
    thresh: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    points: Optional[list] = None

    def is_leaf(self) -> bool:
        return self.left is None


class IncrementalTree:
    """One random binary partition tree, built incrementally (paper Fig. 1)."""

    def __init__(self, x: np.ndarray, capacity: int, split_ratio: float,
                 n_proj: int, rng: np.random.Generator):
        self.x = x
        self.capacity = capacity
        self.r = split_ratio
        self.k = n_proj
        self.rng = rng
        self.root = _Node(points=[])

    def _project(self, node: _Node, xi: np.ndarray) -> float:
        return float(np.dot(xi[node.idx], node.coef))

    def _descend(self, xi: np.ndarray) -> _Node:
        node = self.root
        while not node.is_leaf():
            # Eq. 1: t(x) = sum_k x[d_k] xi_k - psi >= 0  -> left child
            if self._project(node, xi) - node.thresh >= 0:
                node = node.left
            else:
                node = node.right
        return node

    def _make_test(self, node: _Node) -> None:
        """RandomTest(node.GetDataPoints(), r) from the paper's pseudocode."""
        d = self.x.shape[1]
        node.idx = self.rng.integers(0, d, size=self.k)
        node.coef = (np.ones(self.k) if self.k == 1
                     else self.rng.uniform(0.0, 1.0, size=self.k))
        y = self.x[np.asarray(node.points)][:, node.idx] @ node.coef
        y_sorted = np.sort(y)
        n = len(y_sorted)
        # paper Eq. 1: psi ~ U[y_{r n}, y_{(1-r) n}] (interval of VALUES)
        a = y_sorted[min(int(np.floor(self.r * n)), n - 1)]
        b = y_sorted[min(int(np.floor((1.0 - self.r) * n)), n - 1)]
        u = float(self.rng.uniform())
        psi = a + u * (b - a)
        lo, hi = y_sorted[0], y_sorted[-1]
        if psi <= lo:   # tie escape (see core/forest.py)
            psi = lo + max(u, 0.05) * (hi - lo)
        node.thresh = float(psi)

    def insert(self, i: int) -> None:
        node = self._descend(self.x[i])
        node.points.append(i)
        if len(node.points) > self.capacity:
            self._make_test(node)
            y = self.x[np.asarray(node.points)][:, node.idx] @ node.coef
            go_left = (y - node.thresh) >= 0
            left_pts = [p for p, g in zip(node.points, go_left) if g]
            right_pts = [p for p, g in zip(node.points, go_left) if not g]
            if not left_pts or not right_pts:
                # degenerate split (ties): keep as fat leaf, drop the test
                node.idx = None
                node.coef = None
                return
            node.left = _Node(points=left_pts)
            node.right = _Node(points=right_pts)
            node.points = None

    def retrieve(self, q: np.ndarray) -> list:
        """Paper Fig. 3: drop the query to a leaf, return its point ids."""
        return list(self._descend(q).points)

    # ---- structural helpers for tests -----------------------------------
    def leaves(self) -> list:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n.is_leaf():
                out.append(n)
            else:
                stack.extend([n.left, n.right])
        return out

    def depth_stats(self) -> tuple[float, int]:
        depths, stack = [], [(self.root, 0)]
        while stack:
            n, d = stack.pop()
            if n.is_leaf():
                depths.append(d)
            else:
                stack.extend([(n.left, d + 1), (n.right, d + 1)])
        return float(np.mean(depths)), int(np.max(depths))


class IncrementalForest:
    """Paper Fig. 1 TrainTrees + Fig. 3 Retrieve, for L trees."""

    def __init__(self, x: np.ndarray, n_trees: int, capacity: int = 12,
                 split_ratio: float = 0.3, n_proj: int = 1, seed: int = 0):
        self.x = np.asarray(x, np.float32)
        self.trees = []
        root_rng = np.random.default_rng(seed)
        for _ in range(n_trees):
            rng = np.random.default_rng(root_rng.integers(2**63))
            tree = IncrementalTree(self.x, capacity, split_ratio, n_proj, rng)
            order = rng.permutation(self.x.shape[0])  # random insert order
            for i in order:
                tree.insert(int(i))
            self.trees.append(tree)

    def retrieve(self, q: np.ndarray) -> np.ndarray:
        """Union of the L leaf point-sets (paper Fig. 3, outer loop)."""
        ids: set = set()
        for t in self.trees:
            ids.update(t.retrieve(q))
        return np.fromiter(ids, dtype=np.int64)

    def query(self, q: np.ndarray, k: int, metric: str = "l2"
              ) -> tuple[np.ndarray, np.ndarray]:
        cand = self.retrieve(q)
        x = self.x[cand]
        if metric == "l2":
            d = np.sum((x - q[None, :]) ** 2, axis=1)
        elif metric == "chi2":
            d = np.sum((x - q) ** 2 / (x + q + 1e-12), axis=1)
        else:
            raise ValueError(metric)
        top = np.argsort(d)[:k]
        return d[top], cand[top]
