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

``tune_sharded`` tunes each DB shard of a sharded deployment
(``core/sharded_index.py``) on its own rows: shard ``s`` builds from
``seal_seed(index.seed, s)`` (the reference's ``fold_in(index.key, s)``),
or from injected draws.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.knn import exact_knn
from repro_torch.core.schedule import probe_widths
from repro_torch.index.api import build_index, seal_seed
from repro_torch.index.params import SearchParams

__all__ = ["tune", "tune_report", "tune_sharded"]


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


# ---------------------------------------------------------------------------
# distributed tuning: measure on the mesh partitioning, not one host
# ---------------------------------------------------------------------------


def _shard_bounds(n: int, n_shards: int) -> list[tuple[int, int]]:
    """Row ranges of each DB shard: contiguous and even, the last shard
    taking the remainder when ``n_shards`` does not divide ``n``."""
    n_local = n // n_shards
    return [(s * n_local, (s + 1) * n_local if s < n_shards - 1 else n)
            for s in range(n_shards)]


def tune_sharded(index, queries, n_shards: int, target_recall: float = 0.95,
                 k: int = 10, metric: str = "l2", mode: str = "auto",
                 probe_grid: Iterable[int] = (1, 2, 4, 8),
                 mesh=None, db_axes: Sequence[str] = ("data",),
                 tree_axis: str = "model", persist: bool = True, draws=None
                 ) -> tuple[list[SearchParams], list[dict]]:
    """Per-shard tuned operating points, measured on the mesh partitioning.

    A true neighbour is found iff the shard that owns it surfaces it
    locally, so global recall decomposes over the partition:

        recall = sum_s |found_s & owned_s| / |true neighbours|

    For each shard ``s`` (``_shard_bounds`` of the live rows) this builds
    the shard's own index over its rows and walks ``n_probes`` over
    ``probe_grid`` (the sharded-legal axis) in ascending order, keeping
    the first point whose owned-neighbour recall clears ``target_recall``
    (else the last).  Shard ``s`` draws from ``seal_seed(index.seed, s)``,
    or from ``draws(s, n_rows)`` (a ``SegmentDraws``; not the index's own:
    its sid 0 is the first build's stream, not shard 0's).

    ``mesh`` (a ``core.sharded_index.Mesh``) also validates the merged
    result: the per-shard points collapse to the uniform operating point
    (``serve.runtime.uniform_shard_params``), a sharded index over the
    live rows answers the queries, and the final report row holds its
    ``mesh_recall``.  Returns ``(shard_params, report)``; ``persist``
    stores ``index.shard_params`` and, when the index has no tuned point,
    the uniform one as ``tuned_params``.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    q = torch.from_numpy(_host_queries(queries)).to(index.device)
    gids, rows = index.live_points()
    if rows.shape[0] < n_shards:
        raise ValueError(f"cannot split {rows.shape[0]} live rows into "
                         f"{n_shards} shards")
    rows_dev = torch.from_numpy(rows).to(index.device)
    k_oracle = min(k, rows.shape[0])
    _, pos = exact_knn(q, rows_dev, k=k_oracle, metric=metric)
    pos = pos.cpu().numpy()                     # oracle in row positions
    n_true = pos.size

    grid = sorted({int(p) for p in probe_grid if p >= 1})
    if not grid:
        raise ValueError("tuner grid is empty — probe_grid prunes "
                         "every sharded-legal combination")
    shard_params: list[SearchParams] = []
    report: list[dict] = []
    for s, (lo, hi) in enumerate(_shard_bounds(rows.shape[0], n_shards)):
        if draws is not None:
            sub = build_index(rows_dev[lo:hi], index.spec,
                              device=index.device, draws=draws(s, hi - lo))
        else:
            gen = torch.Generator(device=index.device).manual_seed(
                seal_seed(index.seed, s))
            sub = build_index(rows_dev[lo:hi], index.spec,
                              device=index.device, generator=gen)
        owned = (pos >= lo) & (pos < hi)
        n_owned = int(owned.sum())
        chosen = None
        for p in grid:
            params = SearchParams(k=k, metric=metric, mode=mode, n_probes=p)
            _, ids = sub.search(q, params)
            ids = ids.cpu().numpy()
            # shard-local ids -> row positions; the owned-neighbour hits
            found = (pos[..., None] - lo == ids[:, None, :]).any(-1) & owned
            rec_owned = float(found.sum()) / n_owned if n_owned else 1.0
            row = {"shard": s, "params": params, "recall_owned": rec_owned,
                   "n_owned": n_owned,
                   "meets_target": rec_owned >= target_recall}
            report.append(row)
            chosen = params
            if row["meets_target"]:
                break
        shard_params.append(chosen)

    # the contribution-weighted global recall the per-shard picks imply
    implied = sum(r["recall_owned"] * r["n_owned"] / max(1, n_true)
                  for r in report
                  if r["params"] is shard_params[r["shard"]])
    report.append({"shard": -1, "params": None,
                   "implied_global_recall": round(implied, 4)})

    # deferred: serve.runtime imports the index package
    from repro_torch.serve.runtime import uniform_shard_params
    if mesh is not None:
        from repro_torch.core.sharded_index import (build_sharded_index,
                                                    make_query_fn)
        uni = uniform_shard_params(shard_params)
        db = rows_dev.to(mesh.device)
        sharded = build_sharded_index(index.seed, db, index.spec.forest,
                                      mesh, db_axes=db_axes,
                                      tree_axis=tree_axis)
        qfn = make_query_fn(sharded.cfg, sharded.n_local, mesh,
                            db_axes=db_axes, tree_axis=tree_axis, params=uni)
        _, ids = qfn(sharded, q.to(mesh.device), db)
        mesh_rec = _recall(ids.cpu().numpy(), pos)
        report.append({"shard": -1, "params": uni,
                       "mesh_recall": round(mesh_rec, 4),
                       "meets_target": mesh_rec >= target_recall})

    if persist:
        index.shard_params = tuple(shard_params)
        if index.tuned_params is None:
            index.tuned_params = uniform_shard_params(shard_params)
    return shard_params, report
