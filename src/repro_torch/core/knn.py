"""Exact (brute-force) k-NN, the recall baseline (port of
``repro/core/knn.py``).  The l2, dot and cosine forms are one fp32 matrix
product (``torch.matmul``, with TF32 off), as the reference left its product
to XLA.  ``db_chunk`` streams the rows in blocks, as the reference does."""
from __future__ import annotations

import torch

from repro_torch.core import distances as dist_mod
from repro_torch.kernels.common import blockwise_topk, topk_smallest


def exact_knn(queries: torch.Tensor, db: torch.Tensor, k: int,
              metric: str = "l2", db_chunk: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, d) x (N, d) -> exact top-k (dists, ids), ties to the smaller id.

    ``db_chunk`` > 0 (with N a multiple of it) scores ``db_chunk`` rows at
    a time and merges each block into the running top-k over
    ``[best, new]``, so ties still go to the earlier (smaller) id.
    """
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact_knn needs fp32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    pairwise = dist_mod.PAIRWISE[dist_mod.canonical_metric(metric)]
    n = db.shape[0]
    if not db_chunk or n <= db_chunk:
        dists, ids = topk_smallest(pairwise(queries, db), k)
        return dists, ids.int()
    if n % db_chunk:
        raise ValueError(f"pad the db to a multiple of db_chunk: {n} rows, "
                         f"db_chunk {db_chunk}")
    return blockwise_topk(queries, db, k, pairwise, db_chunk)
