"""Forest descent kernel (port of ``repro/kernels/forest_traverse_hbm.py``).

``forest_traverse_hbm`` launches ``csrc/forest_traverse.cu`` for tensors on
a CUDA device and runs its plain version (``ref.forest_traverse_ref``) for
tensors on the CPU.  The TPU kernel kept the trees in HBM to lift the SMEM
node cap; on the GPU every tree lives in device memory anyway, so one kernel
serves every tree size, and any ``max_depth`` and ``n_probes``, and the name
only keeps the pair findable.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LAUNCHES, check_tensor
from repro_torch.kernels.ref import forest_traverse_ref

# the grid's y limit: a block takes one tree (csrc/forest_traverse.cu)
_MAX_GRID_Y = 65535


def forest_traverse_hbm(feat: torch.Tensor, thresh: torch.Tensor,
                        child_base: torch.Tensor, queries: torch.Tensor,
                        max_depth: int, n_probes: int = 1) -> torch.Tensor:
    """Whole-forest K = 1 descent.

    feat int32 / thresh f32 / child_base int32, each (L, max_nodes);
    queries (B, d) f32.  Returns leaf ids (L, B) int32 for ``n_probes ==
    1``, else (L, B, n_probes) with -1 marking absent probes (primary leaf
    first, then alternates by ascending margin).
    """
    if not queries.is_cuda:
        return forest_traverse_ref(feat, thresh, child_base, queries,
                                   max_depth, n_probes)
    dev = queries.device
    check_tensor("feat", feat, torch.int32, 2, dev)
    check_tensor("thresh", thresh, torch.float32, 2, dev)
    check_tensor("child_base", child_base, torch.int32, 2, dev)
    check_tensor("queries", queries, torch.float32, 2, dev)
    if not (feat.shape == thresh.shape == child_base.shape):
        raise ValueError(f"tree arrays disagree: {tuple(feat.shape)}, "
                         f"{tuple(thresh.shape)}, {tuple(child_base.shape)}")
    if n_probes < 1:
        raise ValueError(f"n_probes must be >= 1, got {n_probes}")
    n_trees, n_nodes = feat.shape
    if n_trees > _MAX_GRID_Y:
        raise ValueError(f"{n_trees} trees exceed the grid's y limit")
    b, d = queries.shape
    out = torch.empty((n_trees, b, n_probes), dtype=torch.int32, device=dev)
    fn = build.library("forest_traverse").forest_traverse
    err = fn(feat.data_ptr(), thresh.data_ptr(), child_base.data_ptr(),
             queries.data_ptr(), out.data_ptr(), n_trees, n_nodes, b, d,
             max_depth, n_probes, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "forest_traverse")
    LAUNCHES["forest_traverse"] += 1
    return out[..., 0] if n_probes == 1 else out


def forest_traverse_hbm_tree(feat: torch.Tensor, thresh: torch.Tensor,
                             child_base: torch.Tensor, queries: torch.Tensor,
                             max_depth: int, n_probes: int = 1
                             ) -> torch.Tensor:
    """Single K = 1 tree through the forest kernel at L = 1, with the
    single-tree contract of ``forest_traverse.forest_traverse``: feat /
    thresh / child_base (max_nodes,) -> (B,) leaf ids for ``n_probes ==
    1``, else (B, n_probes)."""
    return forest_traverse_hbm(feat[None], thresh[None], child_base[None],
                               queries, max_depth, n_probes)[0]
