"""Fused candidate gather + exact distance + running top-k (port of
``repro/kernels/fused_query.py``), the query's hot loop.

``fused_gather_topk`` launches ``csrc/fused_query.cu`` for tensors on a
CUDA device and runs its plain version (``ref.fused_gather_topk_ref``) for
tensors on the CPU.  The kernel reads each valid candidate's db row once and
never writes the (B, M, d) gathered block; a -1 slot loads nothing and can
never take a top-k place, which is how tombstones and duplicate candidates
are masked upstream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LAUNCHES, check_tensor
from repro_torch.kernels.ref import fused_gather_topk_ref

METRIC_CODES = {"l2": 0, "dot": 1, "chi2": 2, "cosine": 3}
K_MAX = 128
# a block's shared memory: the query row beside ~5 KB of static tiles
_SMEM_LIMIT = 232_448
_SMEM_STATIC = 8_192


def fused_gather_topk(q: torch.Tensor, ids: torch.Tensor, db: torch.Tensor,
                      k: int, metric: str = "l2"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, d) f32, ids (B, M) int32 (-1 = empty), db (N, d) f32 ->
    (dists (B, k) f32, ids (B, k) int32), ascending, ties to the earliest
    slot, +inf / -1 past the valid slots."""
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    if not q.is_cuda:
        return fused_gather_topk_ref(q, ids, db, k, metric)
    dev = q.device
    check_tensor("q", q, torch.float32, 2, dev)
    check_tensor("ids", ids, torch.int32, 2, dev)
    check_tensor("db", db, torch.float32, 2, dev)
    b, d = q.shape
    m = ids.shape[1]
    n = db.shape[0]
    if ids.shape[0] != b or db.shape[1] != d:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, ids "
                         f"{tuple(ids.shape)}, db {tuple(db.shape)}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in [1, {K_MAX}], got {k}")
    if n == 0:
        raise ValueError("db holds no rows")
    if 4 * d + _SMEM_STATIC > _SMEM_LIMIT:
        raise ValueError(f"d = {d} does not fit a block's shared memory")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = build.library("fused_query").fused_gather_topk
    err = fn(q.data_ptr(), ids.data_ptr(), db.data_ptr(), out_d.data_ptr(),
             out_i.data_ptr(), b, m, n, d, k, METRIC_CODES[metric],
             torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "fused_gather_topk")
    LAUNCHES["fused_gather_topk"] += 1
    return out_d, out_i
