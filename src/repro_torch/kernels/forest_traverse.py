"""Single-tree descent with the tree in shared memory (port of
``repro/kernels/forest_traverse.py``).

``forest_traverse`` launches ``csrc/forest_traverse_smem.cu`` for tensors
on a CUDA device and runs its plain version
(``ref.forest_traverse_tree_ref``) for tensors on the CPU.  Each block
copies the tree's three arrays into shared memory and descends its queries
there with the descent kernel A runs (``csrc/descent.cuh``), so the leaves
are bitwise equal to kernel A's.  The TPU kernel held the tree in scalar
memory, capped at 65,536 nodes; here the cap is the card's opt-in shared
memory per block over 12 bytes a node (``smem_node_cap``: 19,370 nodes on
an H100's 232,448 bytes).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LAUNCHES, check_tensor
from repro_torch.kernels.ref import forest_traverse_tree_ref

# feat int32 + thresh f32 + child_base int32
NODE_BYTES = 12


@functools.lru_cache(maxsize=None)
def smem_node_cap(device: torch.device) -> int:
    """The largest tree (allocated nodes) the kernel takes on ``device``:
    the opt-in shared memory a block may use, over 12 bytes a node."""
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_block_optin // NODE_BYTES


def forest_traverse(feat: torch.Tensor, thresh: torch.Tensor,
                    child_base: torch.Tensor, queries: torch.Tensor,
                    max_depth: int, n_probes: int = 1) -> torch.Tensor:
    """Single K = 1 tree: feat int32 / thresh f32 / child_base int32, each
    (max_nodes,); queries (B, d) f32.  Returns leaf ids (B,) int32 for
    ``n_probes == 1``, else (B, n_probes) with -1 marking absent probes
    (primary leaf first, then alternates by ascending margin).  Raises for
    a tree over ``smem_node_cap``."""
    if not queries.is_cuda:
        return forest_traverse_tree_ref(feat, thresh, child_base, queries,
                                        max_depth, n_probes)
    dev = queries.device
    check_tensor("feat", feat, torch.int32, 1, dev)
    check_tensor("thresh", thresh, torch.float32, 1, dev)
    check_tensor("child_base", child_base, torch.int32, 1, dev)
    check_tensor("queries", queries, torch.float32, 2, dev)
    if not (feat.shape == thresh.shape == child_base.shape):
        raise ValueError(f"tree arrays disagree: {tuple(feat.shape)}, "
                         f"{tuple(thresh.shape)}, {tuple(child_base.shape)}")
    n_nodes = feat.shape[0]
    cap = smem_node_cap(dev)
    if not 1 <= n_nodes <= cap:
        raise ValueError(f"a tree of {n_nodes} nodes does not fit shared "
                         f"memory (cap {cap} nodes on this card); use "
                         f"kernel='hbm'")
    if n_probes < 1:
        raise ValueError(f"n_probes must be >= 1, got {n_probes}")
    b, d = queries.shape
    out = torch.empty((b, n_probes), dtype=torch.int32, device=dev)
    fn = build.library("forest_traverse_smem").forest_traverse_smem
    err = fn(feat.data_ptr(), thresh.data_ptr(), child_base.data_ptr(),
             queries.data_ptr(), out.data_ptr(), n_nodes, b, d, max_depth,
             n_probes, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "forest_traverse_smem")
    LAUNCHES["forest_traverse_smem"] += 1
    return out[:, 0] if n_probes == 1 else out
