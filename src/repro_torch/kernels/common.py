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

``topk_rounds`` serves any k from a kernel whose top-k list holds at most
``kmax`` entries: each round launches the kernel with an exclusive lower
key per query, the last key of the round before, so round r returns ranks
r * kmax .. r * kmax + kmax - 1 of the same order.  A kernel scores every
pair the same way in every round, so a k <= kmax result is a bit-for-bit
prefix of a larger k's.

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

# the shared memory of kernels B's and G's blocks, beside their static
# tiles: the query row (and chi2's own terms), each padded to 16 bytes,
# and where rows are staged (``ring``) each of the 8 warps' 2 row buffers
# of min(d, 1024) + 3 floats, padded to 16 bytes (csrc/pair_score.cuh:
# STAGES, CHUNK, stage_stride)
SMEM_LIMIT = 232_448


def gather_smem_bytes(d: int, chi2: bool, ring: bool) -> int:
    dp = -(-d // 4) * 4
    stride = (min(d, 1024) + 6) // 4 * 4
    return 4 * (dp * (2 if chi2 else 1) + (8 * 2 * stride if ring else 0))


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


Lower = tuple[torch.Tensor, ...]
# a round's launch: (k, lower or None) -> (dists (B, k), ids (B, k), the
# key columns of the next round's lower key, see ``last_key``)
Launch = Callable[[int, "Lower | None"], tuple[torch.Tensor, torch.Tensor,
                                                Lower]]


def after(lower: Lower | None, scores: torch.Tensor,
          *keys: torch.Tensor) -> torch.Tensor:
    """Whether each (score, key...) lies strictly after its row's exclusive
    lower key ``lower`` = ((B,) scores, (B,) keys...) in lexicographic
    order; all True where ``lower`` is None."""
    if lower is None:
        return torch.ones_like(scores, dtype=torch.bool)
    lo_d, *lo_keys = (t[:, None] for t in lower)
    out = torch.zeros_like(scores, dtype=torch.bool)
    tie = torch.ones_like(out)
    for mine, low in zip((scores, *keys), (lo_d, *lo_keys)):
        out |= tie & (mine > low)
        tie &= mine == low
    return out


def last_key(*cols: torch.Tensor) -> Lower:
    """The lower key of a round's next round from its key columns: the last
    column of a (B, k) score or key tensor, a (B,) one as it is."""
    return tuple(c[:, -1].contiguous() if c.dim() == 2 else c for c in cols)


def pointers(lower: Lower | None, n: int) -> list[int | None]:
    """The device pointers of a lower key's n tensors for a kernel's C
    entry, or n nulls where there is none."""
    if lower is None:
        return [None] * n
    return [t.data_ptr() for t in lower]


def topk_rounds(k: int, kmax: int, launch: Launch
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k from ceil(k / kmax) rounds of ``launch``, each after the
    last key of the round before, written side by side into (B, k)."""
    d, i, cols = launch(min(k, kmax), None)
    if k <= kmax:
        return d, i
    parts_d, parts_i, done = [d], [i], d.shape[1]
    while done < k:
        d, i, cols = launch(min(kmax, k - done), last_key(*cols))
        parts_d.append(d)
        parts_i.append(i)
        done += d.shape[1]
    return torch.cat(parts_d, dim=1), torch.cat(parts_i, dim=1)


def blockwise_topk(q: torch.Tensor, db: torch.Tensor, k: int,
                   score: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   block: int, lower: Lower | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``score(q, db_block)`` (B, n) over db blocks of
    ``block`` rows: each block merges into the running top-k over
    ``[best, new]``, so ties go to the smaller id; +inf / -1 past N.  A
    (score, id) at or before ``lower`` (the exclusive lower key) takes no
    place."""
    b, n = q.shape[0], db.shape[0]
    best_d = q.new_full((b, 0), POS_INF)
    best_i = torch.empty((b, 0), dtype=torch.int32, device=q.device)
    for lo in range(0, n, block):
        s = score(q, db[lo:lo + block])
        ids = torch.arange(lo, lo + s.shape[1], dtype=torch.int32,
                           device=q.device).expand(b, -1)
        s = torch.where(after(lower, s, ids), s, POS_INF)
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
