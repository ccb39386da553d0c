"""Shared pieces of the kernels' wrappers and plain versions.

``topk_smallest`` is the selection every plain version uses: the k smallest
scores in ascending order with ties going to the earliest slot, the order
the reference's ``lax.top_k`` and its in-kernel ``select_topk_block`` keep
(``repro/kernels/common.py``).  ``torch.topk`` promises nothing about ties,
so it is a stable sort.

``blockwise_topk`` is the exact top-k of a score over db blocks, the
streaming the plain scans and ``core.knn.exact_knn`` share; every plain
version that gathers or broadcasts keeps its block under
``GATHER_BUDGET_BYTES``.

``LAUNCHES`` counts kernel launches by kernel name, ``REF_CALLS`` calls of
the plain versions; a run resets them and reads them to show which path it
took.
"""
from __future__ import annotations

import collections
from typing import Callable

import torch

POS_INF = float("inf")
EPS = 1e-12
# the largest f32 block a plain version gathers or broadcasts at once
GATHER_BUDGET_BYTES = 1 << 28

LAUNCHES: collections.Counter = collections.Counter()
REF_CALLS: collections.Counter = collections.Counter()


def topk_smallest(scores: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., M) -> the k smallest (..., k) and their positions, ascending,
    ties to the earliest position.  With k > M the tail is +inf / -1."""
    vals, pos = torch.sort(scores, dim=-1, stable=True)
    vals, pos = vals[..., :k], pos[..., :k]
    short = k - vals.shape[-1]
    if short > 0:
        pad = vals.shape[:-1] + (short,)
        vals = torch.cat([vals, vals.new_full(pad, POS_INF)], dim=-1)
        pos = torch.cat([pos, pos.new_full(pad, -1)], dim=-1)
    return vals, pos


def blockwise_topk(q: torch.Tensor, db: torch.Tensor, k: int,
                   score: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``score(q, db_block)`` (B, n) over db blocks of
    ``block`` rows: each block merges into the running top-k over
    ``[best, new]``, so ties go to the smaller id; +inf / -1 past N."""
    b, n = q.shape[0], db.shape[0]
    best_d = q.new_full((b, 0), POS_INF)
    best_i = torch.empty((b, 0), dtype=torch.int32, device=q.device)
    for lo in range(0, n, block):
        s = score(q, db[lo:lo + block])
        ids = torch.arange(lo, lo + s.shape[1], dtype=torch.int32,
                           device=q.device).expand(b, -1)
        all_d = torch.cat([best_d, s], dim=1)
        best_d, pos = topk_smallest(all_d, min(k, all_d.shape[1]))
        best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1, pos)
    best_d, pos = topk_smallest(best_d, k)
    best_i = torch.gather(best_i, 1, pos.clamp_min(0))
    return best_d, torch.where(torch.isinf(best_d), -1, best_i)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``ndim``
    on ``device`` (what a kernel's wrapper accepts)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected rank {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
