"""Random binary partition forest (port of ``repro/core/forest.py``).

Paper semantics (Zhong 2015, section 3): L independent random binary
partition trees; an internal node tests ``sum_k x[d_k] * xi_k >= psi`` with
a random coordinate set and a data-adaptive threshold psi, a random value
between the r and 1 - r percentiles of the node's projected points; a node
splits while it holds more than C points.  A query descends each tree to a
leaf (one coordinate read and one compare per level), the leaves' points are
unioned and reranked exactly.

The builder is the reference's batched cross-tree builder (all L trees
advance one level together as one (L, N) problem, with one composite sort
per level and an early exit once no leaf is overfull), written in PyTorch at
full sort width.  Its randomness is injected: ``draws(level)`` returns the
level's ``(cand_idx, cand_coef, u)``; without it, each level is drawn from a
``torch.Generator``.  Fed the reference's own draws it reproduces every
``Forest`` array bitwise.

Query: ``traverse_forest`` sends K = 1 forests (the paper's default) to the
descent kernel through ``kernels.ops``; forests with K > 1 use the
K-general descent here, as the reference does, since no kernel was ever
written for them.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import descend


class ForestConfig(NamedTuple):
    """Hyper-parameters of the random partition forest (paper section 3.4)."""

    n_trees: int = 80          # L
    capacity: int = 12         # C: max points per leaf
    split_ratio: float = 0.3   # r in (0, 0.5]
    n_proj: int = 1            # K: coordinates per random test
    max_depth: int = 0         # 0 -> auto bound from N, C, r
    max_nodes: int = 0         # 0 -> auto bound
    leaf_pad: int = 0          # padded candidate slots per (query, tree); 0 -> C

    def resolved(self, n_points: int) -> "ForestConfig":
        r = float(self.split_ratio)
        rc = max(r * self.capacity, 1.0)
        depth = self.max_depth
        if depth <= 0:
            # tie-escape splits on heavily tied data can be as uneven as
            # ~85/15: budget for the worse of that and 1 - r
            shrink = max(1.0 - r, 0.85)
            depth = int(math.ceil(math.log(max(n_points / rc, 2.0))
                                  / math.log(1.0 / shrink))) + 6
        nodes = self.max_nodes
        if nodes <= 0:
            nodes = int(4.0 * n_points / rc) + 64
        pad = self.leaf_pad if self.leaf_pad > 0 else self.capacity
        return self._replace(max_depth=depth, max_nodes=nodes, leaf_pad=pad)


class Forest(NamedTuple):
    """Flat SoA forest; every array carries a leading (L,) tree axis.

    A node is internal iff child_base >= 0; its children are child_base and
    child_base + 1.  Leaf points of node ``n`` of tree ``l`` are
    ``perm[l, leaf_offset[l, n] : leaf_offset[l, n] + leaf_count[l, n]]``.
    """

    proj_idx: torch.Tensor     # (L, max_nodes, K) int32
    proj_coef: torch.Tensor    # (L, max_nodes, K) f32
    thresh: torch.Tensor       # (L, max_nodes)    f32
    child_base: torch.Tensor   # (L, max_nodes)    int32, -1 for a leaf
    perm: torch.Tensor         # (L, N)            int32 point ids by leaf
    leaf_offset: torch.Tensor  # (L, max_nodes)    int32
    leaf_count: torch.Tensor   # (L, max_nodes)    int32
    n_nodes: torch.Tensor      # (L,)              int32

    @property
    def n_trees(self) -> int:
        return self.thresh.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.thresh.shape[1]

    def prefix(self, n_trees: int) -> "Forest":
        """The first ``n_trees`` trees: itself a valid smaller forest."""
        return Forest(*(a[:n_trees] for a in self))

    def window(self, lo: int, hi: int) -> "Forest":
        """Trees ``lo`` to ``hi`` - 1 (clipped to the forest), as views:
        itself a valid smaller forest.  Each array stays contiguous, so a
        kernel given one reads from its ``data_ptr()``, offset included."""
        return Forest(*(a[lo:hi] for a in self))


Draws = Callable[[int], tuple]

# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def generator_draws(generator: torch.Generator, cfg: ForestConfig, d: int,
                    device: torch.device) -> Draws:
    """Per-level draws from ``generator`` (on ``device``): candidate
    coordinates, coefficients and threshold quantiles for every slot.

    Levels are drawn in order from the generator's stream; a level asked
    for again (a chunked build asks once per chunk) is drawn again from
    the generator state it started at, so it repeats bit for bit."""
    shape = (cfg.n_trees, cfg.max_nodes, cfg.n_proj)
    starts = [generator.get_state()]      # the state each level starts at

    def draw():
        ci = torch.randint(0, d, shape, generator=generator, device=device,
                           dtype=torch.int32)
        cc = torch.rand(shape, generator=generator, device=device)
        u = torch.rand(shape[:2], generator=generator, device=device)
        return ci, cc, u

    def draws(level: int):
        while len(starts) <= level:
            generator.set_state(starts[-1])
            draw()
            starts.append(generator.get_state())
        generator.set_state(starts[level])
        out = draw()
        if len(starts) == level + 1:
            starts.append(generator.get_state())
        return out

    return draws


def _lerp(a: torch.Tensor, u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + u * (b - a)`` rounded once, as the reference's fused
    multiply-add rounds it: ``u * (b - a)`` is exact in float64, so the
    float64 form gives the same float32 on any device."""
    return (a.double() + u.double() * (b - a).double()).float()


def _dot_k(v: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """sum_k v[..., k] * coef[..., k], each step rounded once as the
    reference's fused multiply-add reduction rounds it (exact for K = 1)."""
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    for j in range(v.shape[-1]):
        acc = (acc.double() + v[..., j].double() * coef[..., j].double()
               ).float()
    return acc


def _project(x: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor
             ) -> torch.Tensor:
    """y = sum_k x[i, idx[..., i, k]] * coef[..., i, k]; idx / coef
    (L, N, K) -> (L, N)."""
    rows = torch.arange(x.shape[0], device=x.device).view(1, -1, 1)
    return _dot_k(x[rows, idx], coef)


def build_forest(x: torch.Tensor, cfg: ForestConfig, *,
                 generator: torch.Generator | None = None,
                 draws: Draws | None = None,
                 device: str | torch.device | None = None,
                 tree_chunk: int = 0) -> Forest:
    """Build the L-tree forest over the points ``x`` (N, d) float32.

    ``draws(level) -> (cand_idx (L, m, K), cand_coef (L, m, K), u (L, m))``
    supplies each level's randomness (tensors or numpy arrays); without it
    the levels are drawn from ``generator`` (seed 0 when None).  Runs on
    ``device`` (the GPU unless ``device="cpu"``).

    ``tree_chunk`` > 0 builds the trees in chunks of that many, each chunk
    from its own slice of every level's draws: the trees are independent,
    so the forest is bitwise the unchunked one, with the builder's (L, N)
    state cut to the chunk's width.
    """
    with tracing.span("build.forest"):
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
        n, d = x.shape
        cfg = cfg.resolved(n)
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            draws = generator_draws(generator, cfg, d, dev)
        if not 0 < tree_chunk < cfg.n_trees:
            return _build_trees(x, cfg, draws)
        chunks = []
        for lo in range(0, cfg.n_trees, tree_chunk):
            hi = min(lo + tree_chunk, cfg.n_trees)
            chunks.append(_build_trees(
                x, cfg._replace(n_trees=hi - lo),
                lambda level, lo=lo, hi=hi: tuple(a[lo:hi]
                                                  for a in draws(level))))
        return Forest(*(torch.cat(parts) for parts in zip(*chunks)))


def _build_trees(x: torch.Tensor, cfg: ForestConfig, draws: Draws) -> Forest:
    """The batched level loop over one resolved config's trees."""
    dev = x.device
    n, _ = x.shape
    L, m, kp, cap = cfg.n_trees, cfg.max_nodes, cfg.n_proj, cfg.capacity

    node_ids = torch.arange(m, device=dev)[None, :]
    tree_off = torch.arange(L, device=dev)[:, None] * m
    r_lo = torch.tensor(cfg.split_ratio, dtype=torch.float32, device=dev)
    r_hi = torch.tensor(1.0 - cfg.split_ratio, dtype=torch.float32, device=dev)
    assign = torch.zeros((L, n), dtype=torch.long, device=dev)
    counts = torch.zeros((L, m), dtype=torch.long, device=dev)
    counts[:, 0] = n
    proj_idx = torch.zeros((L, m, kp), dtype=torch.long, device=dev)
    proj_coef = torch.ones((L, m, kp), dtype=torch.float32, device=dev)
    thresh = torch.zeros((L, m), dtype=torch.float32, device=dev)
    child_base = torch.full((L, m), -1, dtype=torch.long, device=dev)
    n_nodes = torch.ones((L,), dtype=torch.long, device=dev)

    def overfull_leaves():
        return (child_base < 0) & (node_ids < n_nodes[:, None]) \
            & (counts > cap)

    def any_overfull(overfull):
        """One host wait on the device: whether any leaf is overfull."""
        with tracing.span("build.sync"):
            return bool(overfull.any())

    # level by level until no leaf anywhere is overfull, or the depth budget
    level, overfull = 0, overfull_leaves()
    while level < cfg.max_depth and any_overfull(overfull):
        with tracing.span("build.level"):
            with tracing.span("build.draws"):
                ci, cc, u = (torch.as_tensor(a, device=dev)
                             for a in draws(level))
            ci, cc, u = ci.long(), cc.float(), u.float()
            if kp == 1:
                cc = torch.ones_like(cc)      # scale-invariant for K = 1
            test_idx = torch.where(overfull[..., None], ci, proj_idx)
            test_coef = torch.where(overfull[..., None], cc, proj_coef)
            per_point = assign[..., None].expand(-1, -1, kp)
            y = _project(x, test_idx.gather(1, per_point),
                         test_coef.gather(1, per_point))

            # one composite (node, projection) stable sort per level: by y,
            # then stably by node
            order = torch.sort(y, dim=1, stable=True)[1]
            order = order.gather(1, torch.sort(assign.gather(1, order), dim=1,
                                               stable=True)[1])
            y_sorted = y.gather(1, order)

            def at(pos):
                return y_sorted.gather(1, pos.clamp(0, n - 1))

            start = torch.cumsum(counts, dim=1) - counts
            lo = at(start)
            hi = at(start + counts - 1)
            # a constant projection cannot split: the node stays open and
            # redraws at the next level
            splitting = overfull & (hi > lo)

            # allocate children compactly per tree, unless over the node
            # budget
            n_split = splitting.sum(dim=1)
            rank = torch.cumsum(splitting.long(), dim=1) - 1
            overflow = (n_nodes + 2 * n_split) > m
            new_child_base = torch.where(splitting & ~overflow[:, None],
                                         n_nodes[:, None] + 2 * rank,
                                         child_base)
            splitting = splitting & ~overflow[:, None]
            n_nodes = torch.where(overflow, n_nodes, n_nodes + 2 * n_split)

            # paper Eq. 1: psi ~ U[y_(r n), y_((1-r) n)] within the node
            last_idx = torch.maximum(start, start + counts - 1)
            cnt_f = counts.float()
            pos_a = torch.clamp(start + torch.floor(r_lo * cnt_f).long(),
                                start, last_idx)
            pos_b = torch.clamp(start + torch.floor(r_hi * cnt_f).long(),
                                start, last_idx)
            cand_thresh = _lerp(at(pos_a), u, at(pos_b))
            # tie escape: a collapsed percentile interval falls back to a
            # uniform value split over the node's full (lo, hi] range
            cand_thresh = torch.where(cand_thresh > lo, cand_thresh,
                                      _lerp(lo, torch.clamp_min(u, 0.05), hi))

            proj_idx = torch.where(splitting[..., None], ci, proj_idx)
            proj_coef = torch.where(splitting[..., None], cc, proj_coef)
            thresh = torch.where(splitting, cand_thresh, thresh)

            # reassign the points of splitting nodes, recount occupancy
            go_right = y >= thresh.gather(1, assign)
            assign = torch.where(splitting.gather(1, assign),
                                 new_child_base.gather(1, assign)
                                 + go_right.long(), assign)
            with tracing.span("build.sync"):
                counts = torch.bincount((assign + tree_off).view(-1),
                                        minlength=L * m).view(L, m)
            child_base = new_child_base
            level, overfull = level + 1, overfull_leaves()

    # CSR leaf storage: one stable argsort of the final assignment
    perm = torch.sort(assign, dim=1, stable=True)[1]
    leaf_offset = torch.cumsum(counts, dim=1) - counts
    leaf_count = torch.where(child_base < 0, counts, 0)
    return Forest(proj_idx=proj_idx.int(), proj_coef=proj_coef,
                  thresh=thresh, child_base=child_base.int(),
                  perm=perm.int(), leaf_offset=leaf_offset.int(),
                  leaf_count=leaf_count.int(), n_nodes=n_nodes.int())


# ---------------------------------------------------------------------------
# query: batched traversal + candidate retrieval
# ---------------------------------------------------------------------------


def _projector(forest: Forest, queries: torch.Tensor):
    l_idx = torch.arange(forest.n_trees, device=queries.device).view(-1, 1, 1)

    def project(node):                        # (L, B, A) -> (L, B, A)
        idx = forest.proj_idx[l_idx, node].long()            # (L, B, A, K)
        coef = forest.proj_coef[l_idx, node]
        rows = torch.arange(queries.shape[0], device=queries.device
                            ).view(1, -1, 1, 1)
        return _dot_k(queries[rows, idx], coef)

    return project


def traverse(forest: Forest, queries: torch.Tensor, max_depth: int
             ) -> torch.Tensor:
    """Map each query to its leaf in every tree: (B, d) -> (L, B) int32."""
    return descend(_projector(forest, queries), forest.thresh,
                   forest.child_base, queries.shape[0], max_depth, 1)


def traverse_multiprobe(forest: Forest, queries: torch.Tensor,
                        max_depth: int, n_probes: int) -> torch.Tensor:
    """The ``n_probes`` most marginal leaves per tree: (L, B, n_probes)
    int32, primary leaf first, -1 where no alternate exists."""
    return descend(_projector(forest, queries), forest.thresh,
                   forest.child_base, queries.shape[0], max_depth, n_probes)


def traverse_forest(forest: Forest, queries: torch.Tensor, max_depth: int,
                    n_probes: int = 1, mode: str = "auto") -> torch.Tensor:
    """Mode-dispatched descent, the pipeline's traversal entry.

    K = 1 forests go through ``kernels.ops.traverse`` (the descent kernel
    for CUDA tensors under auto / kernel, its plain version otherwise);
    ``proj_coef`` is identically 1 there, so the kernel's raw-coordinate
    compare is bitwise the projection's.  Returns (L, B) for ``n_probes ==
    1``, else (L, B, n_probes).
    """
    if forest.proj_idx.shape[-1] == 1:
        return ops.traverse(forest.proj_idx[..., 0], forest.thresh,
                            forest.child_base, queries, max_depth, n_probes,
                            mode)
    ops.canonical_mode(mode)
    if n_probes == 1:
        return traverse(forest, queries, max_depth)
    return traverse_multiprobe(forest, queries, max_depth, n_probes)


def gather_candidates_multi(forest: Forest, leaves: torch.Tensor, pad: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidates of the multi-probe leaf set.

    leaves (L, B, P) with -1 marking absent probes -> (B, L*P*pad) int32
    ids and (B, L*P*pad) bool mask; empty slots hold id 0, mask False.
    """
    n_trees, b, p = leaves.shape
    l_idx = torch.arange(n_trees, device=leaves.device).view(-1, 1, 1)
    ok = leaves >= 0
    safe = leaves.clamp_min(0).long()
    off = forest.leaf_offset[l_idx, safe].long()                 # (L, B, P)
    cnt = torch.where(ok, forest.leaf_count[l_idx, safe], 0)
    slot = torch.arange(pad, device=leaves.device)
    pos = (off[..., None] + slot).clamp(0, forest.perm.shape[1] - 1)
    mask = slot < cnt[..., None]                           # (L, B, P, pad)
    ids = torch.where(mask, forest.perm[l_idx[..., None], pos], 0)
    ids = ids.permute(1, 0, 2, 3).reshape(b, n_trees * p * pad)
    mask = mask.permute(1, 0, 2, 3).reshape(b, n_trees * p * pad)
    return ids, mask


def gather_candidates(forest: Forest, leaves: torch.Tensor, pad: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded union of the leaf point sets: leaves (L, B) -> (B, L*pad) ids,
    (B, L*pad) mask.  The single-probe case of ``gather_candidates_multi``."""
    return gather_candidates_multi(forest, leaves[..., None], pad)


def query_forest(forest: Forest, queries: torch.Tensor, db: torch.Tensor,
                 k: int, cfg: ForestConfig, metric: str = "l2",
                 dedup: bool = True, mode: str = "auto", chunk: int = 0,
                 device: str | torch.device | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """End-to-end query: traverse -> dedup -> rerank -> top-k, through
    ``core.pipeline.fused_query``.  Returns (dists (B, k), ids (B, k));
    invalid slots: +inf / -1."""
    from repro_torch.core import pipeline  # local import: pipeline imports us

    return pipeline.fused_query(forest, queries, db, k, cfg, metric=metric,
                                dedup=dedup, mode=mode, chunk=chunk,
                                device=device)


# ---------------------------------------------------------------------------
# structural statistics (paper section 3.4), on the host
# ---------------------------------------------------------------------------


def forest_stats(forest: Forest, cfg: ForestConfig, n_points: int) -> dict:
    """Per-tree node, leaf, occupancy and depth statistics, their means
    over the trees, and the per-tree list under ``per_tree``."""
    cfg = cfg.resolved(n_points)
    child = forest.child_base.cpu().numpy()
    count = forest.leaf_count.cpu().numpy()
    n_nodes = forest.n_nodes.cpu().numpy()
    stats = []
    for t in range(child.shape[0]):
        alive = np.arange(child.shape[1]) < n_nodes[t]
        leaf = (child[t] < 0) & alive
        occ = count[t][leaf & (count[t] > 0)]
        # depth per node via a forward sweep (children follow parents)
        depth = np.full(child.shape[1], -1, np.int32)
        depth[0] = 0
        for i in range(int(n_nodes[t])):
            if child[t, i] >= 0:
                depth[child[t, i]] = depth[i] + 1
                depth[child[t, i] + 1] = depth[i] + 1
        leaf_depths = depth[leaf & (count[t] > 0)]
        stats.append(dict(
            n_nodes=int(n_nodes[t]),
            n_leaves=int(leaf.sum()),
            occ_mean=float(occ.mean()) if occ.size else 0.0,
            occ_max=int(occ.max()) if occ.size else 0,
            overflow_points=(int(occ[occ > cfg.capacity].sum())
                             if occ.size else 0),
            depth_mean=(float(leaf_depths.mean()) if leaf_depths.size
                        else 0.0),
            depth_max=int(leaf_depths.max()) if leaf_depths.size else 0,
        ))
    agg = {key: float(np.mean([s[key] for s in stats])) for key in stats[0]}
    agg["per_tree"] = stats
    return agg
