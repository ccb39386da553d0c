"""Fused int8-row gather + dequantize + distance + running top-k' (port of
``repro/kernels/fused_query_int8.py``), the coarse stage of ``rpf+int8``.

``fused_gather_topk_int8`` launches ``csrc/fused_query_int8.cu`` for
tensors on a CUDA device and runs its plain version
(``ref.fused_gather_topk_int8_ref``) for tensors on the CPU.  The kernel
reads each valid candidate's int8 row and its f32 scale (d + 4 bytes, not
the 4d of the fp32 row), dequantizes in registers and never writes a
dequantized block.  It is bound by those bytes, so it keeps many rows in
flight: one 128-thread block per query, 8 blocks an SM, each warp loading
four listed valid slots before it sums any of them, and an int8 -> f32
conversion that is exact without the quarter-rate ``I2F`` for three bytes
of four.  Its top-k' list holds ``K_MAX`` = 512 (k = 128 at expand 4); a
larger k' runs in rounds (``common.topk_rounds``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (LAUNCHES, check_tensor, pointers,
                                        topk_rounds)
from repro_torch.kernels.fused_query import METRIC_CODES
from repro_torch.kernels.ref import fused_gather_topk_int8_ref

K_MAX = 512
# a block's shared memory: the query row beside 11 KB of static tiles
_SMEM_LIMIT = 232_448
_SMEM_STATIC = 16_384


def fused_gather_topk_int8(q: torch.Tensor, ids: torch.Tensor,
                           q8: torch.Tensor, scale: torch.Tensor, k: int,
                           metric: str = "l2"
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, d) f32, ids (B, M) int32 (-1 = empty), q8 (N, d) int8, scale
    (N,) f32 -> (dists (B, k) f32, ids (B, k) int32) on the dequantized
    rows, ascending, ties to the earliest slot, +inf / -1 past the valid
    slots."""
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    if not q.is_cuda:
        return fused_gather_topk_int8_ref(q, ids, q8, scale, k, metric)
    dev = q.device
    check_tensor("q", q, torch.float32, 2, dev)
    check_tensor("ids", ids, torch.int32, 2, dev)
    check_tensor("q8", q8, torch.int8, 2, dev)
    check_tensor("scale", scale, torch.float32, 1, dev)
    b, d = q.shape
    m = ids.shape[1]
    n = q8.shape[0]
    if ids.shape[0] != b or q8.shape[1] != d or scale.shape[0] != n:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, ids "
                         f"{tuple(ids.shape)}, q8 {tuple(q8.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if n == 0:
        raise ValueError("q8 holds no rows")
    if 4 * d + _SMEM_STATIC > _SMEM_LIMIT:
        raise ValueError(f"d = {d} does not fit a block's shared memory")
    fn = build.library("fused_query_int8").fused_gather_topk_int8
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(kk, lower):
        out_d = torch.empty((b, kk), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, kk), dtype=torch.int32, device=dev)
        last_s = torch.empty((b,), dtype=torch.int32, device=dev)
        err = fn(q.data_ptr(), ids.data_ptr(), q8.data_ptr(),
                 scale.data_ptr(), *pointers(lower, 2), out_d.data_ptr(),
                 out_i.data_ptr(), last_s.data_ptr(), b, m, n, d, kk,
                 METRIC_CODES[metric], stream)
        build.check_launch(err, "fused_gather_topk_int8")
        LAUNCHES["fused_gather_topk_int8"] += 1
        return out_d, out_i, (out_d, last_s)

    return topk_rounds(k, K_MAX, launch)
