"""Shared pieces of the kernels' wrappers and plain versions.

``topk_smallest`` is the selection every plain version uses: the k smallest
scores in ascending order with ties going to the earliest slot, the order
the reference's ``lax.top_k`` and its in-kernel ``select_topk_block`` keep
(``repro/kernels/common.py``).  ``torch.topk`` promises nothing about ties,
so it is a stable sort.

``LAUNCHES`` counts kernel launches by kernel name, ``REF_CALLS`` calls of
the plain versions; a run resets them and reads them to show which path it
took.
"""
from __future__ import annotations

import collections

import torch

POS_INF = float("inf")
EPS = 1e-12

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
