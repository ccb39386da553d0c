"""Exact brute-force chi-square scan with a streaming top-k: kernel E (port
of ``repro/kernels/chi2_topk.py``), the exact baseline of the paper's
ISS-595 experiment.

``chi2_topk`` launches ``csrc/chi2_topk.cu`` for tensors on a CUDA device
and runs its plain version (``ref.chi2_topk_ref``) for tensors on the
CPU.  Each term is an IEEE division (no fast-math flag, no
``__fdividef``) and a pair's terms are added in d order, so the scores are
bitwise those of ``ref.chi2_topk_dordered``.  Lanes vary over queries and
a warp shares the row element, so a zero element (most of a sparse
histogram) is a warp-uniform branch that adds the query's own term
q q / (q + 1e-12), precomputed once per call, with one FADD.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LAUNCHES, pointers, topk_rounds
from repro_torch.kernels.matmul_topk import (K_MAX, MAX_SLICES, check_scan,
                                             scan_outputs)
from repro_torch.kernels.ref import chi2_topk_ref

# the kernel's query tile and dims a stage: the transposed query tiles and
# their zero-element terms are (ceil(B / TILE_Q), d_pad, TILE_Q) f32 each
TILE_Q = 128
CHUNK_D = 32


def chi2_topk(q: torch.Tensor, db: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel E: (B, d) x (N, d) -> exact chi2 top-k, sum (q - c)^2 /
    (q + c + 1e-12) with IEEE division, summed in d order; ascending, ties
    to the smaller id, +inf / -1 where k > N or the score is +inf."""
    if not q.is_cuda:
        return chi2_topk_ref(q, db, k)
    check_scan(q, db, k)
    (b, d), n = q.shape, db.shape[0]
    d_pad = max(CHUNK_D, -(-d // CHUNK_D) * CHUNK_D)
    qt = torch.empty((-(-b // TILE_Q), d_pad, TILE_Q), dtype=torch.float32,
                     device=q.device)
    tt = torch.empty_like(qt)
    fn = build.library("chi2_topk").chi2_topk
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def launch(kk, lower):
        part_d, part_i, out_d, out_i = scan_outputs(q, kk)
        err = fn(q.data_ptr(), db.data_ptr(), qt.data_ptr(), tt.data_ptr(),
                 *pointers(lower, 2), part_d.data_ptr(), part_i.data_ptr(),
                 out_d.data_ptr(), out_i.data_ptr(), b, n, d, kk, MAX_SLICES,
                 stream)
        build.check_launch(err, "chi2_topk")
        LAUNCHES["chi2_topk"] += 1
        return out_d, out_i, (out_d, out_i)

    return topk_rounds(k, K_MAX, launch)
