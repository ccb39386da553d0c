"""Exact (brute-force) k-NN, the recall baseline (port of
``repro/core/knn.py``).  The l2, dot and cosine forms are one fp32 matrix
product (``torch.matmul``, with TF32 off), as the reference left its product
to XLA."""
from __future__ import annotations

import torch

from repro_torch.core import distances as dist_mod
from repro_torch.kernels.common import topk_smallest


def exact_knn(queries: torch.Tensor, db: torch.Tensor, k: int,
              metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """(B, d) x (N, d) -> exact top-k (dists, ids), ties to the smaller id."""
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact_knn needs fp32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    d = dist_mod.PAIRWISE[dist_mod.canonical_metric(metric)](queries, db)
    dists, ids = topk_smallest(d, k)
    return dists, ids.int()
