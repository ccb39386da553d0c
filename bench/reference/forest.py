"""The plain random partition forest build (Zhong 2015, section 3), frozen.

A node splits while it holds more than C points; its test is a random
coordinate (K = 1), its threshold psi a random value between the r and
1 - r percentiles of the node's points along that coordinate (paper Eq. 1).
All L trees advance one level together: per level one stable sort of the
(L, N) projections by value and then by node, the percentile positions read
from the sorted block, the points of splitting nodes moved to their
children.  The draws of a level are, in this order, the coordinates
(``randint``), the coefficients and the quantiles (``rand``) of every
(tree, node) slot, from a ``torch.Generator`` on the rows' device.

This file imports nothing of the program.  ``precision`` rounds the rows
before the build (``"tf32"`` or ``"bf16"``): the control of the build.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Forest(NamedTuple):
    """Flat arrays with a leading (L,) tree axis; a node is internal iff
    child_base >= 0, its children child_base and child_base + 1; the points
    of leaf n are perm[l, leaf_offset[l, n]:][:leaf_count[l, n]]."""

    proj_idx: torch.Tensor     # (L, m, K) int32
    proj_coef: torch.Tensor    # (L, m, K) f32
    thresh: torch.Tensor       # (L, m) f32
    child_base: torch.Tensor   # (L, m) int32
    perm: torch.Tensor         # (L, N) int32
    leaf_offset: torch.Tensor  # (L, m) int32
    leaf_count: torch.Tensor   # (L, m) int32
    n_nodes: torch.Tensor      # (L,) int32


def sizes(n: int, capacity: int, split_ratio: float) -> tuple[int, int]:
    """(max_depth, max_nodes) of a forest over n points: the depth at which
    even an 85 / 15 split has emptied every node, plus 6, and 4 N / (r C)
    + 64 nodes a tree."""
    rc = max(split_ratio * capacity, 1.0)
    shrink = max(1.0 - split_ratio, 0.85)
    depth = int(math.ceil(math.log(max(n / rc, 2.0))
                          / math.log(1.0 / shrink))) + 6
    return depth, int(4.0 * n / rc) + 64


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x (f32) rounded to ``precision``: "fp32" leaves it, "tf32" keeps 10
    mantissa bits (round to nearest), "bf16" 7."""
    if precision == "fp32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def _lerp(a: torch.Tensor, u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + u (b - a), rounded once to f32."""
    return (a.double() + u.double() * (b - a).double()).float()


def build(x: torch.Tensor, n_trees: int, capacity: int, split_ratio: float,
          seed: int, precision: str = "fp32") -> Forest:
    """The forest over rows x (N, d) f32, drawn from a generator seeded
    with ``seed`` on x's device."""
    dev = x.device
    x = round_to(x.float(), precision).contiguous()
    n, d = x.shape
    max_depth, m = sizes(n, capacity, split_ratio)
    L, cap = n_trees, capacity
    gen = torch.Generator(device=dev).manual_seed(seed)

    node_ids = torch.arange(m, device=dev)[None, :]
    tree_off = torch.arange(L, device=dev)[:, None] * m
    r_lo = torch.tensor(split_ratio, dtype=torch.float32, device=dev)
    r_hi = torch.tensor(1.0 - split_ratio, dtype=torch.float32, device=dev)
    assign = torch.zeros((L, n), dtype=torch.long, device=dev)
    counts = torch.zeros((L, m), dtype=torch.long, device=dev)
    counts[:, 0] = n
    feat = torch.zeros((L, m), dtype=torch.long, device=dev)
    thresh = torch.zeros((L, m), dtype=torch.float32, device=dev)
    child_base = torch.full((L, m), -1, dtype=torch.long, device=dev)
    n_nodes = torch.ones((L,), dtype=torch.long, device=dev)

    def overfull_leaves():
        return (child_base < 0) & (node_ids < n_nodes[:, None]) \
            & (counts > cap)

    level, overfull = 0, overfull_leaves()
    while level < max_depth and bool(overfull.any()):
        ci = torch.randint(0, d, (L, m, 1), generator=gen, device=dev,
                           dtype=torch.int32)[..., 0].long()
        torch.rand((L, m, 1), generator=gen, device=dev)  # K = 1: unused
        u = torch.rand((L, m), generator=gen, device=dev)

        test = torch.where(overfull, ci, feat)
        # + 0.0: a -0.0 coordinate projects to +0.0 (the sum starts at 0)
        y = x[torch.arange(n, device=dev)[None, :],
              test.gather(1, assign)] + 0.0

        order = torch.sort(y, dim=1, stable=True)[1]
        order = order.gather(1, torch.sort(assign.gather(1, order), dim=1,
                                           stable=True)[1])
        y_sorted = y.gather(1, order)

        def at(pos):
            return y_sorted.gather(1, pos.clamp(0, n - 1))

        start = torch.cumsum(counts, dim=1) - counts
        lo = at(start)
        hi = at(start + counts - 1)
        splitting = overfull & (hi > lo)

        n_split = splitting.sum(dim=1)
        rank = torch.cumsum(splitting.long(), dim=1) - 1
        overflow = (n_nodes + 2 * n_split) > m
        new_child_base = torch.where(splitting & ~overflow[:, None],
                                     n_nodes[:, None] + 2 * rank, child_base)
        splitting = splitting & ~overflow[:, None]
        n_nodes = torch.where(overflow, n_nodes, n_nodes + 2 * n_split)

        last = torch.maximum(start, start + counts - 1)
        cnt_f = counts.float()
        pos_a = torch.clamp(start + torch.floor(r_lo * cnt_f).long(), start,
                            last)
        pos_b = torch.clamp(start + torch.floor(r_hi * cnt_f).long(), start,
                            last)
        psi = _lerp(at(pos_a), u, at(pos_b))
        # a collapsed percentile interval: a uniform value in (lo, hi]
        psi = torch.where(psi > lo, psi, _lerp(lo, torch.clamp_min(u, 0.05),
                                               hi))

        feat = torch.where(splitting, ci, feat)
        thresh = torch.where(splitting, psi, thresh)

        go_right = y >= thresh.gather(1, assign)
        assign = torch.where(splitting.gather(1, assign),
                             new_child_base.gather(1, assign)
                             + go_right.long(), assign)
        counts = torch.bincount((assign + tree_off).view(-1),
                                minlength=L * m).view(L, m)
        child_base = new_child_base
        level, overfull = level + 1, overfull_leaves()

    perm = torch.sort(assign, dim=1, stable=True)[1]
    leaf_offset = torch.cumsum(counts, dim=1) - counts
    leaf_count = torch.where(child_base < 0, counts, 0)
    return Forest(proj_idx=feat.int()[..., None],
                  proj_coef=torch.ones((L, m, 1), dtype=torch.float32,
                                       device=dev),
                  thresh=thresh, child_base=child_base.int(),
                  perm=perm.int(), leaf_offset=leaf_offset.int(),
                  leaf_count=leaf_count.int(), n_nodes=n_nodes.int())


def count_diff(a, b) -> int:
    """Entries in which two forests differ, array by array (a shape that
    differs counts every entry of the larger)."""
    total = 0
    for x, y in zip(a, b):
        x = torch.as_tensor(x).cpu()
        y = torch.as_tensor(y).cpu()
        if x.shape != y.shape:
            total += max(x.numel(), y.numel())
            continue
        if x.dtype.is_floating_point:
            total += int((x.view(torch.int32) != y.view(torch.int32)).sum())
        else:
            total += int((x.long() != y.long()).sum())
    return total
