"""Weighted multi-hot embedding bag (port of
``repro/kernels/embedding_bag.py``), the recsys models' history pooling.

``embedding_bag`` launches ``csrc/embedding_bag.cu`` for tensors on a CUDA
device and runs its plain version (``ref.embedding_bag_ref``) for tensors
on the CPU.  One warp sums one bag in h order in fp32; the (B, H, D)
gathered rows are never written.  ``torch.nn.functional.embedding_bag``
computes the same function and is only the yardstick ``chip_smoke.py``
times beside the kernel.
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
