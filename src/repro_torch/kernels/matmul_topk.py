"""Exact brute-force l2 / dot scan with a streaming top-k: kernel D (port
of ``repro/kernels/matmul_topk.py``), and the input checks and scratch it
shares with kernel E (``kernels/chi2_topk.py``).

``matmul_topk`` launches ``csrc/scan_topk.cu`` for tensors on a CUDA device
and runs its plain version (``ref.matmul_topk_ref``) for tensors on the
CPU.  The kernel is bound by its fp32 FFMAs (2 B N d flops, 1.44 ms for
1024 queries against MNIST-784 on an H100), so its operands come from
registers: a block scores 128 queries against 128-row tiles, each thread
an 8 x 8 block of sums, with both tiles streamed through shared memory by
cp.async two or three 32-column steps ahead.  Each sum is one FFMA chain
over d in order, so the scores, and the output, are bit for bit those of
any other tiling.  Survivors of each tile (scores below a query's k-th
key) are merged by rank into a running top-k per query; the (B, N) score
matrix is never written.  The rows are cut into up to 32 slices so that
one wave of blocks fills the card; each slice leaves its own top-k and a
second kernel merges the lists of a query, ties to the smaller id.  l2
adds |q|^2 and |c|^2 to the kernel's fp32 cross product as the reference
does; both are small vectors computed here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (LAUNCHES, check_tensor, pointers,
                                        topk_rounds)
from repro_torch.kernels.ref import matmul_topk_ref

METRIC_CODES = {"l2": 0, "dot": 1}
# a kernel's top-k list; a larger k runs in rounds (``common.topk_rounds``)
K_MAX = 128
# row slices per query tile: at most one per lane of the merging warp; the
# kernel picks how many, so the scratch holds the most
MAX_SLICES = 32


def check_scan(q: torch.Tensor, db: torch.Tensor, k: int) -> None:
    """Raise unless (q, db, k) are an exact scan's CUDA inputs."""
    dev = q.device
    check_tensor("q", q, torch.float32, 2, dev)
    check_tensor("db", db, torch.float32, 2, dev)
    if db.shape[1] != q.shape[1]:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, db "
                         f"{tuple(db.shape)}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if db.shape[0] == 0:
        raise ValueError("db holds no rows")


def scan_outputs(q: torch.Tensor, k: int) -> tuple[torch.Tensor, ...]:
    """One launch's slice scratch and outputs for k <= K_MAX: (part_d,
    part_i) (B, MAX_SLICES, k), (out_d, out_i) (B, k)."""
    b, dev = q.shape[0], q.device
    return (torch.empty((b, MAX_SLICES, k), dtype=torch.float32, device=dev),
            torch.empty((b, MAX_SLICES, k), dtype=torch.int32, device=dev),
            torch.empty((b, k), dtype=torch.float32, device=dev),
            torch.empty((b, k), dtype=torch.int32, device=dev))


def matmul_topk(q: torch.Tensor, db: torch.Tensor, k: int,
                metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: (B, d) x (N, d) -> exact top-k (dists (B, k) f32, ids
    (B, k) int32), l2 as |q|^2 - 2 q.c + |c|^2 or dot as -q.c; ascending,
    ties to the smaller id, +inf / -1 where k > N."""
    if metric not in METRIC_CODES:
        raise ValueError(f"matmul_topk scores l2 or dot, not {metric!r}")
    if not q.is_cuda:
        return matmul_topk_ref(q, db, k, metric)
    check_scan(q, db, k)
    (b, d), n = q.shape, db.shape[0]
    if metric == "l2":
        q_sq, db_sq = torch.sum(q * q, dim=1), torch.sum(db * db, dim=1)
    else:                                 # not read by the kernel
        q_sq = db_sq = q.new_empty(1)
    fn = build.library("scan_topk").scan_topk
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def launch(kk, lower):
        part_d, part_i, out_d, out_i = scan_outputs(q, kk)
        err = fn(q.data_ptr(), db.data_ptr(), q_sq.data_ptr(),
                 db_sq.data_ptr(), *pointers(lower, 2), part_d.data_ptr(),
                 part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), b, n,
                 d, kk, MAX_SLICES, METRIC_CODES[metric], stream)
        build.check_launch(err, "scan_topk")
        LAUNCHES["matmul_topk"] += 1
        return out_d, out_i, (out_d, out_i)

    return topk_rounds(k, K_MAX, launch)
