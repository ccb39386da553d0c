"""Recall-targeted tuning: the cheapest SearchParams that meets a target
(port of ``repro/index/tune.py``).

    from repro_torch.index import build_index, tune

    index = build_index(db, spec)
    params = tune(index, sample_queries, target_recall=0.95)
    dists, ids = index.search(queries)      # the tuned params apply

``tune`` measures recall@k against exact k-NN over the index's live rows
(``core/knn.exact_knn``), walks a small backend-specific grid in ascending
cost order and returns the cheapest ``SearchParams`` that meets the
target.  The result is stored as ``index.tuned_params`` and rides the
manifest; the session's tuning context lets ``compact()`` retune after
churn.  The grid, the oracle and every measured search are functions of
(index state, queries), and the cost models are the reference's, so the
port picks the reference's params on the same index and queries.

Cost model: expected fp32 candidate rows touched per query, the quantity
the fused rerank's traffic is linear in.  For the forest backends that is
``trees * n_probes * leaf_pad`` (``rpf+int8`` pays a quarter of it in the
int8 stage plus ``expand * k`` exact rows); for ``lsh-cascade`` the
measured mean candidate count.  Adaptive entries are charged the trees
they used on the sample and scheduled entries the mean probes they
processed, on a one-segment index.

The reference's ``tune_sharded`` waits for the sharded index (ROADMAP.md
queue 1 item 8): its per-shard builds draw from the sharded index's key
stream.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.knn import exact_knn
from repro_torch.core.schedule import probe_widths
from repro_torch.index.params import SearchParams

__all__ = ["tune", "tune_report"]


def _recall(pred_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Order-insensitive recall@k of predicted against oracle global ids."""
    hits = (pred_ids[:, :, None] == true_ids[:, None, :]).any(axis=1)
    return float(hits.mean())


def _tree_grid(n_trees: int, tree_fracs: Sequence[float]) -> list[int]:
    grid = sorted({max(1, int(round(n_trees * f))) for f in tree_fracs
                   if 0.0 < f <= 1.0} | {n_trees})
    return [t for t in grid if t <= n_trees]


def _candidate_grid(index, k: int, metric: str, mode: str,
                    probe_grid: Sequence[int], tree_fracs: Sequence[float],
                    adaptive_waves: Sequence[int],
                    expand_grid: Sequence[int],
                    schedule_grid: Sequence[int] = (0,)
                    ) -> list[SearchParams]:
    """The backend's search grid, in a fixed order."""
    backend = getattr(index, "backend", "")
    base = dict(k=k, metric=metric, mode=mode)
    if backend == "bruteforce":
        return [SearchParams(**base)]
    if backend == "lsh-cascade":
        return [SearchParams(**base, min_candidates=mc)
                for mc in sorted({1, k, 4 * k, 16 * k})]
    total = index.spec.forest.n_trees
    expands = sorted(set(expand_grid)) if backend == "rpf+int8" else [4]
    grid = []
    for t in _tree_grid(total, tree_fracs):
        # the full forest is spelled n_trees = 0 ("all")
        n_trees = 0 if t == total else t
        for p in sorted(set(probe_grid)):
            for w in sorted(set(adaptive_waves)):
                if w >= t:          # a wave covering the forest is a no-op
                    continue
                for e in expands:
                    grid.append(SearchParams(
                        **base, n_trees=n_trees, n_probes=p,
                        adaptive_wave=w, expand=e))
        # a schedule owns the probe axis (n_probes is inert under it)
        for s in sorted(set(schedule_grid)):
            if s < 1:
                continue
            for e in expands:
                grid.append(SearchParams(**base, n_trees=n_trees,
                                         probe_schedule=s, expand=e))
    return grid


def _forest_rows(index, trees: int, probes: float, params: SearchParams,
                 k: int) -> float:
    """Candidate rows a query touches on a forest backend, int8 discounted."""
    cfg = index.spec.forest.resolved(max(index.n_rows, 2))
    rows = trees * probes * cfg.leaf_pad
    if getattr(index, "backend", "") == "rpf+int8":
        return 0.25 * rows + params.expand * k
    return float(rows)


def _static_cost(index, params: SearchParams, k: int) -> float:
    """Upper-bound cost (fp32-row equivalents a query), the scan order."""
    backend = getattr(index, "backend", "")
    if backend == "bruteforce":
        return float(index.n_rows)
    if backend == "lsh-cascade":
        return float(params.min_candidates)
    trees = params.n_trees or index.spec.forest.n_trees
    # a query that never converges is descended at every width of the
    # schedule, so its bound is their sum
    probes = (sum(probe_widths(params.probe_schedule))
              if params.probe_schedule else params.n_probes)
    return _forest_rows(index, trees, probes, params, k)


def _single_segment(index) -> bool:
    view = index.snapshot()
    return len(view.segments) == 1 and view.delta is None


def _measured_cost(index, params: SearchParams, k: int) -> float:
    """``_static_cost``, but adaptive entries are charged the trees they
    used and scheduled entries the probes they processed on the sample
    (the primary engine's counters, so only on a one-segment index)."""
    backend = getattr(index, "backend", "")
    if backend == "lsh-cascade":
        return float(getattr(index, "last_mean_candidates", 0.0)
                     or params.min_candidates)
    forest_backend = backend in ("rpf", "rpf+int8")
    if forest_backend and params.adaptive_wave and _single_segment(index):
        used = int(getattr(index, "last_trees_used",
                           params.n_trees or index.spec.forest.n_trees))
        return _forest_rows(index, used, params.n_probes, params, k)
    if forest_backend and params.probe_schedule and _single_segment(index):
        trees = params.n_trees or index.spec.forest.n_trees
        probes = float(getattr(index, "last_mean_probes", 0.0)) or \
            float(params.probe_schedule)
        return _forest_rows(index, trees, probes, params, k)
    return _static_cost(index, params, k)


def _host_queries(queries) -> np.ndarray:
    if isinstance(queries, torch.Tensor):
        queries = queries.detach().cpu().numpy()
    return np.atleast_2d(np.asarray(queries, np.float32))


def tune_report(index, queries, target_recall: float = 0.95, k: int = 10,
                metric: str = "l2", mode: str = "auto",
                probe_grid: Iterable[int] = (1, 2, 4, 8),
                tree_fracs: Iterable[float] = (0.25, 0.5, 1.0),
                adaptive_waves: Iterable[int] = (0,),
                expand_grid: Iterable[int] = (2, 4),
                schedule_grid: Iterable[int] = (0,),
                persist: bool = True
                ) -> tuple[SearchParams, list[dict]]:
    """``tune`` returning ``(params, report)``: one report row a grid point
    evaluated, ``{"params", "recall", "cost", "meets_target"}``, in
    ascending static-cost order.  See :func:`tune`."""
    host_q = _host_queries(queries)
    q = torch.from_numpy(host_q).to(index.device)
    gids, rows = index.live_points()
    if rows.shape[0] == 0:
        raise ValueError("cannot tune an empty index")
    k_oracle = min(k, rows.shape[0])
    _, pos = exact_knn(q, torch.from_numpy(rows).to(index.device),
                       k=k_oracle, metric=metric)
    true_ids = gids[pos.cpu().numpy()]

    grid = _candidate_grid(index, k, metric, mode, tuple(probe_grid),
                           tuple(tree_fracs), tuple(adaptive_waves),
                           tuple(expand_grid), tuple(schedule_grid))
    if not grid:
        raise ValueError(
            "tuner grid is empty — probe_grid/tree_fracs/adaptive_waves "
            f"prune every combination for backend "
            f"{getattr(index, 'backend', '?')!r} "
            f"(L={getattr(index.spec.forest, 'n_trees', '?')})")
    grid.sort(key=lambda p: (_static_cost(index, p, k), p.n_probes,
                             p.n_trees, p.expand, p.adaptive_wave,
                             p.probe_schedule, p.min_candidates))

    report: list[dict] = []
    best: tuple[float, SearchParams] | None = None       # (cost, params)
    fallback: tuple[float, float, SearchParams] | None = None
    for params in grid:
        # the static cost bounds the measured one only for fixed entries,
        # which then cannot beat the incumbent
        if best is not None and _static_cost(index, params, k) >= best[0] \
                and not params.adaptive_wave and not params.probe_schedule:
            continue
        _, ids = index.search(q, params)
        rec = _recall(ids.cpu().numpy(), true_ids)
        cost = _measured_cost(index, params, k)
        meets = rec >= target_recall
        report.append({"params": params, "recall": rec, "cost": cost,
                       "meets_target": meets})
        if meets and (best is None or cost < best[0]):
            best = (cost, params)
        if fallback is None or (-rec, cost) < (-fallback[0], fallback[1]):
            fallback = (rec, cost, params)
    chosen = best[1] if best is not None else fallback[2]
    if persist:
        index.tuned_params = chosen
        index._tune_ctx = {
            "queries": host_q,
            "kwargs": dict(target_recall=target_recall, k=k, metric=metric,
                           mode=mode, probe_grid=tuple(probe_grid),
                           tree_fracs=tuple(tree_fracs),
                           adaptive_waves=tuple(adaptive_waves),
                           expand_grid=tuple(expand_grid),
                           schedule_grid=tuple(schedule_grid)),
        }
        index._tuned_n_live = index.n_rows
    return chosen, report


def tune(index, queries, target_recall: float = 0.95, k: int = 10,
         metric: str = "l2", mode: str = "auto",
         probe_grid: Iterable[int] = (1, 2, 4, 8),
         tree_fracs: Iterable[float] = (0.25, 0.5, 1.0),
         adaptive_waves: Iterable[int] = (0,),
         expand_grid: Iterable[int] = (2, 4),
         schedule_grid: Iterable[int] = (0,),
         persist: bool = True) -> SearchParams:
    """The cheapest ``SearchParams`` whose recall@``k`` on ``queries`` (a
    representative (B, d) sample) meets ``target_recall``; if none does,
    the highest-recall point (the cheapest among ties).

    The grid: ``rpf`` / ``rpf+int8`` walk ``n_trees`` x ``n_probes``, and
    optionally early-exit waves (``adaptive_waves``, 0 = off), probe
    schedules (``schedule_grid`` of caps, 0 = off) and, on ``rpf+int8``,
    the shortlist width ``expand_grid``; ``lsh-cascade`` walks
    ``min_candidates``; ``bruteforce`` has nothing to tune.  With
    ``persist`` the result becomes ``index.tuned_params``, the default of
    a bare ``index.search(q)``, kept by ``save`` / ``load_index``.
    """
    params, _ = tune_report(index, queries, target_recall=target_recall,
                            k=k, metric=metric, mode=mode,
                            probe_grid=probe_grid, tree_fracs=tree_fracs,
                            adaptive_waves=adaptive_waves,
                            expand_grid=expand_grid,
                            schedule_grid=schedule_grid, persist=persist)
    return params
