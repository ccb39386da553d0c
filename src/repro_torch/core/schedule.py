"""Per-query probe scheduling (port of ``repro/core/schedule.py``).

Every query starts at ``n_probes = 1`` and is descended again at a doubling
probe width -- 1, 2, 4, ... up to the cap -- while its k-th distance still
improves by more than ``tol`` a round; converged queries leave the later
rounds.

Each round replaces the running result of its active queries: the probe
set at width w is a prefix of the set at any larger width, so a later
round sees a superset of every earlier round's candidates.  At ``tol =
0.0`` no query converges (the improvement is clamped at 0, and 0 < 0 is
false), so the last round is the full batch, in its original order, at the
cap: the same ``fused_query`` call as the fixed-``n_probes`` search, hence
bitwise its answer on every rerank source.

A later round gathers exactly its active queries (the reference pads them
to a power of two for jit); the answer for a query must not depend on
which other queries share its batch, which the kernels keep.  The k-th
distances come to the host once a round.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import Forest, ForestConfig
from repro_torch.core.pipeline import fused_query
from repro_torch.core.quantized import QuantizedDB
from repro_torch.device import resolve_device

__all__ = ["probe_widths", "scheduled_query"]


def probe_widths(cap: int) -> list[int]:
    """The round schedule: doubling widths 1, 2, 4, ... ending exactly at
    ``cap`` (cap = 6 -> [1, 2, 4, 6])."""
    if cap < 1:
        raise ValueError(f"probe cap must be >= 1, got {cap}")
    widths, w = [], 1
    while w < cap:
        widths.append(w)
        w *= 2
    widths.append(cap)
    return widths


def _improvement(prev_kth: np.ndarray, kth: np.ndarray) -> np.ndarray:
    """Relative k-th-distance improvement per query: an infinite previous
    k-th (top-k not yet filled) never converges, the denominator is
    |prev| so signed metrics behave, a previous k-th of 0 reads 0, and the
    result is clamped at 0."""
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = (prev_kth - kth) / np.abs(prev_kth)
    rel = np.where(np.isfinite(prev_kth),
                   np.where(prev_kth == 0.0, 0.0, rel), np.inf)
    return np.maximum(rel, 0.0)


def scheduled_query(forest: Forest, queries: torch.Tensor,
                    db: torch.Tensor | QuantizedDB, k: int, cfg: ForestConfig,
                    cap: int, tol: float = 0.01, metric: str = "l2",
                    mode: str = "auto", chunk: int = 0, expand: int = 4,
                    dedup: bool = True, valid: torch.Tensor | None = None,
                    device: str | torch.device | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray,
                               np.ndarray]:
    """Convergence-gated per-query probe widening up to ``cap`` probes.

    Returns ``(dists (B, k), ids (B, k), probes_final (B,),
    probes_processed (B,))``: the width each query's answer came from, and
    the probes it was descended at over all rounds (1 + 2 + ...).
    """
    dev = resolve_device(device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    queries = queries.contiguous()
    b = queries.shape[0]
    widths = probe_widths(cap)

    def run(q, w):
        return fused_query(forest, q, db, k, cfg, metric=metric, dedup=dedup,
                           mode=mode, chunk=chunk, expand=expand, n_probes=w,
                           valid=valid, device=dev)

    best_d, best_i = run(queries, widths[0])
    probes_final = np.full(b, widths[0], np.int32)
    probes_processed = np.full(b, widths[0], np.int32)
    prev_kth = best_d[:, -1].cpu().numpy().copy()
    active = np.arange(b)
    for w in widths[1:]:
        if active.size == 0:
            break
        if active.size == b:
            d_act, i_act = run(queries, w)
            best_d, best_i = d_act, i_act
        else:
            sel = torch.from_numpy(active).to(dev)
            d_act, i_act = run(queries[sel], w)
            best_d[sel] = d_act
            best_i[sel] = i_act
        probes_final[active] = w
        probes_processed[active] += w
        kth = d_act[:, -1].cpu().numpy()
        converged = _improvement(prev_kth[active], kth) < tol
        prev_kth[active] = kth
        active = active[~converged]
    return best_d, best_i, probes_final, probes_processed
