"""Weighted multi-hot embedding bag (port of
``repro/kernels/embedding_bag.py``), the recsys models' history pooling.

``embedding_bag`` launches ``csrc/embedding_bag.cu`` for tensors on a CUDA
device and runs its plain version (``ref.embedding_bag_ref``) for tensors
on the CPU.  The kernel sums a bag in a fixed order that is not h order:
each of the bag's ``warps_per_bag`` warps takes a contiguous range of
slots, a lane sums every R-th slot of its range (R = 2 rows a warp-step at
D = 64), the R partial sums are added pairwise and then the warps' sums
in warp order; the (B, H, D) gathered rows are never written.  The C
entry picks the warps a bag from B and the card's SM count, so that few
bags still fill the card.  ``torch.nn.functional.embedding_bag`` computes
the same function and is only the yardstick ``chip_smoke.py`` times
beside the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LAUNCHES, check_tensor
from repro_torch.kernels.ref import embedding_bag_ref


def embedding_bag(ids: torch.Tensor, weights: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
    """ids (B, H) int32, weights (B, H) f32, table (V, D) f32 -> (B, D)
    f32, the sum over h of ``weights[b, h] * table[ids[b, h]]``; padding
    is id 0 with weight 0."""
    if not ids.is_cuda:
        return embedding_bag_ref(ids, weights, table)
    dev = ids.device
    check_tensor("ids", ids, torch.int32, 2, dev)
    check_tensor("weights", weights, torch.float32, 2, dev)
    check_tensor("table", table, torch.float32, 2, dev)
    if weights.shape != ids.shape:
        raise ValueError(f"shapes disagree: ids {tuple(ids.shape)}, weights "
                         f"{tuple(weights.shape)}")
    b, h = ids.shape
    v, d = table.shape
    if v == 0:
        raise ValueError("the table holds no rows")
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    fn = build.library("embedding_bag").embedding_bag
    err = fn(ids.data_ptr(), weights.data_ptr(), table.data_ptr(),
             out.data_ptr(), b, h, v, d,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "embedding_bag")
    LAUNCHES["embedding_bag"] += 1
    return out
