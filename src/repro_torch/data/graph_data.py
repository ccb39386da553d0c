"""Graph generators + a real CSR fanout neighbor sampler (minibatch_lg cell)
(a copy of ``repro/data/graph_data.py``: numpy, the reference's arrays bit
for bit from the same seed).

One token differs: ``NeighborSampler.sample`` draws each frontier node's
offsets below its own degree, ``np.maximum(deg, 1)[:, None]``.  The
reference's ``np.maximum(deg, 1)`` has shape (F,) against a draw of shape
(F, f), so numpy raises on the first hop whenever f > 1 and F != f; the
draws are otherwise the reference's, draw for draw.
"""
from __future__ import annotations

import numpy as np


def random_graph(n_nodes: int, n_edges: int, d_feat: int = 0, seed: int = 0,
                 power_law: bool = True):
    """Random directed graph with power-law-ish degree. Returns dict of arrays."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = rng.pareto(1.5, size=n_nodes) + 1.0
        p = w / w.sum()
        src = rng.choice(n_nodes, size=n_edges, p=p)
    else:
        src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.integers(0, n_nodes, size=n_edges)
    out = {
        "senders": src.astype(np.int32),
        "receivers": dst.astype(np.int32),
        "positions": rng.normal(size=(n_nodes, 3)).astype(np.float32),
        "species": rng.integers(0, 16, size=n_nodes).astype(np.int32),
    }
    if d_feat:
        out["node_feat"] = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    return out


def to_csr(senders: np.ndarray, receivers: np.ndarray, n_nodes: int
           ) -> tuple[np.ndarray, np.ndarray]:
    """(indptr, indices): out-neighbors of each node (CSR over senders)."""
    order = np.argsort(senders, kind="stable")
    indices = receivers[order].astype(np.int32)
    counts = np.bincount(senders, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices


class NeighborSampler:
    """GraphSAGE-style uniform fanout sampler over a CSR adjacency.

    Produces fixed-shape padded samples (TPU-friendly): per hop h with fanout
    f_h, every frontier node draws f_h neighbors with replacement; isolated
    nodes self-loop.  Returns a subgraph as (senders, receivers, node_map).
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray, fanouts: tuple[int, ...]):
        nodes = [seeds.astype(np.int64)]
        edges_s, edges_r = [], []
        frontier = seeds.astype(np.int64)
        for f in fanouts:
            deg = (self.indptr[frontier + 1] - self.indptr[frontier])
            offs = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                                     size=(len(frontier), f))
            neigh = self.indices[
                np.minimum(self.indptr[frontier, None] + offs,
                           len(self.indices) - 1)]
            # isolated nodes -> self loops
            neigh = np.where(deg[:, None] > 0, neigh, frontier[:, None])
            src = neigh.reshape(-1)
            dst = np.repeat(frontier, f)
            edges_s.append(src)
            edges_r.append(dst)
            frontier = np.unique(src)
            nodes.append(frontier)
        all_nodes, inv = np.unique(np.concatenate(nodes), return_inverse=True)
        # relabel endpoints into the compact node set
        relabel = {g: i for i, g in enumerate(all_nodes)}
        s = np.concatenate(edges_s)
        r = np.concatenate(edges_r)
        s_local = np.searchsorted(all_nodes, s)
        r_local = np.searchsorted(all_nodes, r)
        return {
            "node_ids": all_nodes.astype(np.int64),       # global ids
            "senders": s_local.astype(np.int32),
            "receivers": r_local.astype(np.int32),
            "seed_local": np.searchsorted(all_nodes, seeds).astype(np.int32),
        }


def sort_edges_for_mesh(senders: np.ndarray, receivers: np.ndarray,
                        n_nodes: int, n_shards: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Sort edges by receiver shard AND pad per-shard edge counts equal.

    This is the preprocessing contract of the sharded MACE message-passing
    path (models/mace._a_features_sharded): with edges grouped by receiver
    shard, every device scatters only into its local node range.  Padding
    edges are self-loops on the shard's first node with zero weight (callers
    must mask them via edge_mask).
    Returns (senders, receivers, edge_mask) all of length
    n_shards * max_per_shard.
    """
    n_loc = n_nodes // n_shards
    shard = np.minimum(receivers // n_loc, n_shards - 1)
    order = np.argsort(shard, kind="stable")
    s, r = senders[order], receivers[order]
    shard = shard[order]
    counts = np.bincount(shard, minlength=n_shards)
    m = int(counts.max())
    out_s = np.zeros((n_shards, m), np.int32)
    out_r = np.zeros((n_shards, m), np.int32)
    mask = np.zeros((n_shards, m), np.float32)
    start = 0
    for sh in range(n_shards):
        c = counts[sh]
        out_s[sh, :c] = s[start:start + c]
        out_r[sh, :c] = r[start:start + c]
        out_s[sh, c:] = sh * n_loc
        out_r[sh, c:] = sh * n_loc
        mask[sh, :c] = 1.0
        start += c
    return out_s.reshape(-1), out_r.reshape(-1), mask.reshape(-1)


def batched_molecules(batch: int, n_nodes: int, n_edges: int, seed: int = 0):
    """Batch of small molecule-like graphs, flattened with graph_ids."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.5, 2.5, size=(batch, n_nodes, 3)).astype(np.float32)
    species = rng.integers(0, 8, size=(batch, n_nodes)).astype(np.int32)
    senders, receivers, gids = [], [], []
    for g in range(batch):
        d = np.linalg.norm(pos[g][:, None] - pos[g][None], axis=-1)
        np.fill_diagonal(d, np.inf)
        # keep the n_edges shortest directed edges
        s, r = np.unravel_index(np.argsort(d, axis=None)[:n_edges], d.shape)
        senders.append(s + g * n_nodes)
        receivers.append(r + g * n_nodes)
        gids.append(np.full(n_nodes, g))
    return {
        "positions": pos.reshape(-1, 3),
        "species": species.reshape(-1),
        "senders": np.concatenate(senders).astype(np.int32),
        "receivers": np.concatenate(receivers).astype(np.int32),
        "graph_ids": np.concatenate(gids).astype(np.int32),
        "n_graphs": batch,
    }
