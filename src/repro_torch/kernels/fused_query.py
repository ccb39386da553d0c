"""Fused candidate gather + exact distance + running top-k (port of
``repro/kernels/fused_query.py``), the query's hot loop, and its exact scan.

``fused_gather_topk`` launches ``csrc/fused_query.cu`` for tensors on a
CUDA device and runs its plain version (``ref.fused_gather_topk_ref``) for
tensors on the CPU.  The kernel reads each valid candidate's db row once and
never writes the (B, M, d) gathered block; a -1 slot loads nothing and can
never take a top-k place, which is how tombstones and duplicate candidates
are masked upstream.

``fused_scan`` is the same function over ids = arange(N) for every query
(the ``bruteforce`` backend), launched as ``csrc/fused_scan.cu``: a tile of
queries against a tile of rows, so a row is read once per query tile, and
every pair scored bit for bit as the gather scores it
(``csrc/pair_score.cuh``); ties go to the smaller id.  Its plain version
is ``ref.fused_scan_ref``.

Both kernels keep a top-k list of at most ``K_MAX``; a larger k runs in
rounds (``common.topk_rounds``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (LAUNCHES, SMEM_LIMIT, check_tensor,
                                        gather_smem_bytes, pointers,
                                        topk_rounds)
from repro_torch.kernels.matmul_topk import MAX_SLICES
from repro_torch.kernels.ref import fused_gather_topk_ref, fused_scan_ref

METRIC_CODES = {"l2": 0, "dot": 1, "chi2": 2, "cosine": 3}
K_MAX = 128
# the gather's static tiles (~5 KB)
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
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if n == 0:
        raise ValueError("db holds no rows")
    chi2 = metric == "chi2"                 # only chi2 stages its rows
    if gather_smem_bytes(d, chi2, chi2) + _SMEM_STATIC > SMEM_LIMIT:
        raise ValueError(f"d = {d} does not fit a block's shared memory")
    if d % 4 == 0 and db.data_ptr() % 16:
        raise ValueError("db must start on a 16-byte boundary where d % 4 "
                         "== 0 (the kernel reads its rows as float4)")
    fn = build.library("fused_query").fused_gather_topk
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(kk, lower):
        out_d = torch.empty((b, kk), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, kk), dtype=torch.int32, device=dev)
        last_s = torch.empty((b,), dtype=torch.int32, device=dev)
        err = fn(q.data_ptr(), ids.data_ptr(), db.data_ptr(),
                 *pointers(lower, 2), out_d.data_ptr(), out_i.data_ptr(),
                 last_s.data_ptr(), b, m, n, d, kk, METRIC_CODES[metric],
                 stream)
        build.check_launch(err, "fused_gather_topk")
        LAUNCHES["fused_gather_topk"] += 1
        return out_d, out_i, (out_d, last_s)

    return topk_rounds(k, K_MAX, launch)


def fused_scan(q: torch.Tensor, db: torch.Tensor, k: int, metric: str = "l2",
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, d) f32, db (N, d) f32, valid (N,) bool or None -> (dists (B, k)
    f32, ids (B, k) int32): ``fused_gather_topk`` over ids = arange(N) (-1
    where ``valid`` is False) for every query, bit for bit; ascending,
    ties to the smaller id, +inf / -1 past the live rows."""
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    if not q.is_cuda:
        return fused_scan_ref(q, db, k, metric, valid)
    dev = q.device
    check_tensor("q", q, torch.float32, 2, dev)
    check_tensor("db", db, torch.float32, 2, dev)
    b, d = q.shape
    n = db.shape[0]
    if db.shape[1] != d:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, db "
                         f"{tuple(db.shape)}")
    if valid is not None:
        check_tensor("valid", valid, torch.bool, 1, dev)
        if valid.shape[0] != n:
            raise ValueError(f"valid has {valid.shape[0]} entries for {n} "
                             "rows")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if n == 0 or d == 0:
        raise ValueError(f"db of shape {tuple(db.shape)} holds nothing")
    fn = build.library("fused_scan").fused_scan
    stream = torch.cuda.current_stream(dev).cuda_stream
    # cosine's query and row norms, which a pre-pass writes
    norms = torch.empty((b + n,) if metric == "cosine" else (1,),
                        dtype=torch.float32, device=dev)
    row_sq = norms[b:] if metric == "cosine" else norms

    def launch(kk, lower):
        part_d = torch.empty((b, MAX_SLICES, kk), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((b, MAX_SLICES, kk), dtype=torch.int32,
                             device=dev)
        out_d = torch.empty((b, kk), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, kk), dtype=torch.int32, device=dev)
        err = fn(q.data_ptr(), db.data_ptr(),
                 None if valid is None else valid.data_ptr(),
                 norms.data_ptr(), row_sq.data_ptr(), *pointers(lower, 2),
                 part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                 out_i.data_ptr(), b, n, d, kk, MAX_SLICES,
                 METRIC_CODES[metric], stream)
        build.check_launch(err, "fused_scan")
        LAUNCHES["fused_scan"] += 1
        return out_d, out_i, (out_d, out_i)

    return topk_rounds(k, K_MAX, launch)
