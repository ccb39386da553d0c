"""Exact brute-force chi-square scan with a streaming top-k: kernel E (port
of ``repro/kernels/chi2_topk.py``), the exact baseline of the paper's
ISS-595 experiment.

``chi2_topk`` launches ``csrc/scan_topk.cu`` (the tiled scan it shares
with kernel D, ``kernels/matmul_topk.scan_topk``) for tensors on a CUDA
device and runs its plain version (``ref.chi2_topk_ref``) for tensors on
the CPU.  Each term is an IEEE division: no fast-math flag, no
``__fdividef``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.matmul_topk import scan_topk
from repro_torch.kernels.ref import chi2_topk_ref


def chi2_topk(q: torch.Tensor, db: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel E: (B, d) x (N, d) -> exact chi2 top-k, sum (q - c)^2 /
    (q + c + 1e-12) with IEEE division; ascending, ties to the smaller id,
    +inf / -1 where k > N."""
    if not q.is_cuda:
        return chi2_topk_ref(q, db, k)
    out = scan_topk(q, db, k, "chi2")
    LAUNCHES["chi2_topk"] += 1
    return out
