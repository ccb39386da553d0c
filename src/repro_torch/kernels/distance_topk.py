"""Exact distance over pre-gathered candidates + masked top-k (port of
``repro/kernels/distance_topk.py``), the staged rerank stage.

``distance_topk`` launches ``csrc/distance_topk.cu`` for tensors on a CUDA
device and runs its plain version (``ref.distance_topk_ref``) for tensors
on the CPU.  Unlike kernel B (``fused_query``) it takes the (B, M, d)
candidate rows the caller gathered, and orders its top-k by (score, id):
ties go to the smaller id, the contract of the reference's plain version
(``repro/kernels/ref.py`` ``distance_topk_ref``).  A masked slot loads
nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (LAUNCHES, SMEM_LIMIT, check_tensor,
                                        gather_smem_bytes, pointers,
                                        topk_rounds)
from repro_torch.kernels.ref import distance_topk_ref

METRIC_CODES = {"l2": 0, "chi2": 2}
# the kernel's top-k list; a larger k runs in rounds (``common.topk_rounds``)
K_MAX = 128
# the kernel's static tiles (~8 KB)
_SMEM_STATIC = 10_240


def distance_topk(q: torch.Tensor, cand: torch.Tensor, ids: torch.Tensor,
                  mask: torch.Tensor, k: int, metric: str = "l2"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, d) f32, cand (B, M, d) f32, ids (B, M) int32, mask (B, M)
    bool -> (dists (B, k) f32, ids (B, k) int32), ascending, ties to the
    smaller id, +inf / -1 past the valid slots."""
    if metric not in METRIC_CODES:
        raise ValueError(f"distance_topk scores l2 or chi2, not {metric!r}")
    if not q.is_cuda:
        return distance_topk_ref(q, cand, ids, mask, k, metric)
    dev = q.device
    check_tensor("q", q, torch.float32, 2, dev)
    check_tensor("cand", cand, torch.float32, 3, dev)
    check_tensor("ids", ids, torch.int32, 2, dev)
    check_tensor("mask", mask, torch.bool, 2, dev)
    b, d = q.shape
    m = cand.shape[1]
    if cand.shape[0] != b or cand.shape[2] != d or ids.shape != (b, m) \
            or mask.shape != (b, m):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, cand "
                         f"{tuple(cand.shape)}, ids {tuple(ids.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if gather_smem_bytes(d, metric == "chi2", True) + _SMEM_STATIC > SMEM_LIMIT:
        raise ValueError(f"d = {d} does not fit a block's shared memory")
    fn = build.library("distance_topk").distance_topk
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(kk, lower):
        out_d = torch.empty((b, kk), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, kk), dtype=torch.int32, device=dev)
        last_s = torch.empty((b,), dtype=torch.int32, device=dev)
        # a launch that is all of k needs no next key: the kernel then
        # compiles without its rounds' tests
        err = fn(q.data_ptr(), cand.data_ptr(), ids.data_ptr(),
                 mask.data_ptr(), *pointers(lower, 3), out_d.data_ptr(),
                 out_i.data_ptr(), None if kk == k else last_s.data_ptr(), b,
                 m, d, kk, METRIC_CODES[metric], stream)
        build.check_launch(err, "distance_topk")
        LAUNCHES["distance_topk"] += 1
        return out_d, out_i, (out_d, out_i, last_s)

    return topk_rounds(k, K_MAX, launch)
