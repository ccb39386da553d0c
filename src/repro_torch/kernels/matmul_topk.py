"""Exact brute-force l2 / dot scan with a streaming top-k: kernel D (port
of ``repro/kernels/matmul_topk.py``), and the input checks and scratch it
shares with kernel E (``kernels/chi2_topk.py``).

``matmul_topk`` launches ``csrc/scan_topk.cu`` for tensors on a CUDA device
and runs its plain version (``ref.matmul_topk_ref``) for tensors on the
CPU.  The kernel scores a tile of queries against a tile of db rows
staged in shared memory and keeps a running top-k per query; the (B, N)
score matrix is never written.  The rows are cut into up to 32 slices so
that one wave of blocks fills the card; each slice leaves its own top-k
and a second kernel merges the lists of a query, ties to the smaller id.
l2 adds |q|^2 and |c|^2 to the kernel's fp32 cross product as the
reference does; both are small vectors computed here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LAUNCHES, check_tensor
from repro_torch.kernels.ref import matmul_topk_ref

METRIC_CODES = {"l2": 0, "dot": 1}
K_MAX = 128
# row slices per query tile: at most one per lane of the merging warp; the
# kernel picks how many, so the scratch holds the most
MAX_SLICES = 32


def scan_outputs(q: torch.Tensor, db: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, ...]:
    """Check an exact scan's CUDA inputs and allocate its slice scratch and
    outputs: (part_d, part_i) (B, MAX_SLICES, k), (out_d, out_i) (B, k)."""
    dev = q.device
    check_tensor("q", q, torch.float32, 2, dev)
    check_tensor("db", db, torch.float32, 2, dev)
    b, d = q.shape
    if db.shape[1] != d:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, db "
                         f"{tuple(db.shape)}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in [1, {K_MAX}], got {k}")
    if db.shape[0] == 0:
        raise ValueError("db holds no rows")
    return (torch.empty((b, MAX_SLICES, k), dtype=torch.float32, device=dev),
            torch.empty((b, MAX_SLICES, k), dtype=torch.int32, device=dev),
            torch.empty((b, k), dtype=torch.float32, device=dev),
            torch.empty((b, k), dtype=torch.int32, device=dev))


def scan_topk(q: torch.Tensor, db: torch.Tensor, k: int, metric: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/scan_topk.cu`` on CUDA tensors under ``metric``."""
    part_d, part_i, out_d, out_i = scan_outputs(q, db, k)
    (b, d), n = q.shape, db.shape[0]
    if metric == "l2":
        q_sq, db_sq = torch.sum(q * q, dim=1), torch.sum(db * db, dim=1)
    else:                                 # not read by the kernel
        q_sq = db_sq = q.new_empty(1)
    fn = build.library("scan_topk").scan_topk
    err = fn(q.data_ptr(), db.data_ptr(), q_sq.data_ptr(), db_sq.data_ptr(),
             part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
             out_i.data_ptr(), b, n, d, k, MAX_SLICES, METRIC_CODES[metric],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, "scan_topk")
    return out_d, out_i


def matmul_topk(q: torch.Tensor, db: torch.Tensor, k: int,
                metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: (B, d) x (N, d) -> exact top-k (dists (B, k) f32, ids
    (B, k) int32), l2 as |q|^2 - 2 q.c + |c|^2 or dot as -q.c; ascending,
    ties to the smaller id, +inf / -1 where k > N."""
    if metric not in ("l2", "dot"):
        raise ValueError(f"matmul_topk scores l2 or dot, not {metric!r}")
    if not q.is_cuda:
        return matmul_topk_ref(q, db, k, metric)
    out = scan_topk(q, db, k, metric)
    LAUNCHES["matmul_topk"] += 1
    return out

