"""ServingRuntime: the tuned, overload-safe serving front-end (port of
``repro/serve/runtime.py``).

The runtime closes the tune -> serve loop (DESIGN.md §12):

  * loads an index (or takes a built one) and resolves its operating point
    — per-shard tuned params (manifest v4) > host tuned params (v3) >
    explicit ``params`` > defaults;
  * serves host-local through ``index.search`` (mutable while serving),
    or with ``mesh=`` row-sharded through a ``core.sharded_index.
    ShardedIndex`` over the index's live points at stand-up, and returns
    each answer on the host.  The copy to the host is also the
    synchronisation that makes ``warmup`` and ``calibrate`` time the
    device's work, not only its launches;
  * fronts everything with the DynamicBatcher, plus **overload
    degradation**: a ladder of operating points descending in cost (step
    ``n_probes`` down, then ``n_trees``); when queue depth breaches what
    the SLO model says is drainable in time, the runtime steps one rung
    down instead of letting p999 explode, and steps back up once the queue
    clears.  Every shed decision is counted (``stats()``: shed_steps /
    recover_steps / requests_degraded / batches_by_rung) so capacity
    decisions are made from evidence.

Every rung is warmed at startup on the caller's thread (one batch per rung
builds and loads its kernels, a second is timed), so a rung switch under
fire never builds a kernel in the batcher's worker, and the timings seed
the queue-depth threshold and the planner's traffic model.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.core.sharded_index import ShardedIndex
from repro_torch.index import (CapabilityError, SearchParams, Violation,
                               load_index)
from repro_torch.serve import planner as planner_mod
from repro_torch.serve.batching import DynamicBatcher

__all__ = ["ServingRuntime", "build_ladder", "uniform_shard_params"]


def _ladder_cost(p: SearchParams, total_trees: int) -> float:
    """Relative cost of a rung: candidate rows/query (tuner cost units)."""
    trees = p.n_trees or total_trees
    if p.probe_schedule:
        # per-query scheduling (DESIGN.md §14): the cap bounds the final
        # width, but most queries converge well below it — charge an
        # empirical ~0.6 of the cap (the tuner's measured mean replaces
        # this estimate once tune() has run with a schedule_grid)
        cost = float(trees * p.probe_schedule) * 0.6
    else:
        cost = float(trees * p.n_probes)
    if p.adaptive_wave:
        # early exit can only reduce trees actually visited
        cost *= 0.75
    return cost


def build_ladder(params: SearchParams, total_trees: int,
                 max_rungs: int = 6) -> tuple[SearchParams, ...]:
    """Degradation ladder: rung 0 = the tuned point, then strictly cheaper.

    Policy: halve the probe axis to 1 first (multi-probe buys recall
    cheaply, so it is also the cheapest recall to give back — DESIGN.md
    §9); on a scheduled base point that axis is the ``probe_schedule`` cap
    (the rungs keep the per-query convergence gate, a cap of 1 degenerates
    to the single descent), otherwise the fixed ``n_probes``.  Then halve
    the trees queried (``n_trees``; skipped when the base point has
    adaptive waves, which already scale trees).  Rungs are deduplicated and
    strictly cost-decreasing; the last rung is the cheapest the backend can
    answer at all (1 probe, >=1/4 of the trees).
    """
    rungs = [params]
    p = params
    while p.probe_schedule > 1:
        p = dataclasses.replace(p,
                                probe_schedule=max(1, p.probe_schedule // 2))
        rungs.append(p)
    while p.n_probes > 1:
        p = dataclasses.replace(p, n_probes=max(1, p.n_probes // 2))
        rungs.append(p)
    if not params.adaptive_wave:
        trees = p.n_trees or total_trees
        floor = max(1, total_trees // 4)
        while trees // 2 >= floor and trees > 1:
            trees = trees // 2
            p = dataclasses.replace(p, n_trees=trees)
            rungs.append(p)
    out, seen = [], set()
    last = float("inf")
    for p in rungs:
        c = _ladder_cost(p, total_trees)
        if p in seen or c >= last and out:
            continue
        seen.add(p)
        out.append(p)
        last = c
    return tuple(out[:max_rungs])


def uniform_shard_params(shard_params: Sequence[SearchParams]
                         ) -> SearchParams:
    """One operating point covering every shard's tuned one.

    A row-sharded step runs one program on every shard, so per-shard knobs
    collapse to a uniform point: the elementwise MAX of the cost knobs
    (n_probes, expand, chunk) — every shard gets at least what its own
    tuning asked for, so the per-shard recall guarantees still hold.  A
    manifest's ``shard_params`` resolve through it on a local runtime too.
    """
    if not shard_params:
        raise ValueError("empty shard_params")
    base = shard_params[0]
    return dataclasses.replace(
        base,
        n_probes=max(p.n_probes for p in shard_params),
        expand=max(p.expand for p in shard_params),
        chunk=max(p.chunk for p in shard_params)).sharded()


class ServingRuntime:
    """One process's serving stack: index -> (sharded) query step ->
    degradation ladder -> dynamic batcher.

    ``submit(q)`` / ``__call__(q)`` serve single 1-D query vectors and
    return ``(dists (k,), global_ids (k,))`` as host arrays;
    ``stop(drain=...)`` shuts the batcher down without abandoning queued
    requests.
    """

    def __init__(self, index, *, params: SearchParams | None = None,
                 use_tuned: bool = True, slo_p99_ms: float | None = None,
                 max_batch: int = 64, max_wait_s: float = 0.002,
                 ladder: Sequence[SearchParams] | None = None,
                 degrade: bool = True, mesh=None,
                 db_axes: Sequence[str] = ("data",),
                 tree_axis: str = "model", warmup: bool = True,
                 shed_depth: int | None = None):
        self.index = index
        self.mesh = mesh
        self.max_batch = int(max_batch)
        self.slo_p99_ms = slo_p99_ms
        total_trees = int(getattr(index.spec.forest, "n_trees", 1))
        self.params = self._resolve_params(index, params, use_tuned)
        # the ONE capabilities() matrix (DESIGN.md §13/§15), checked at
        # stand-up so a bad operating point fails here, not per-request in
        # the batcher
        bad = self.params.capabilities("serving")
        if (mesh is not None and self.params.filter is not None
                and getattr(index, "meta_store", None) is None):
            bad.append(Violation(
                "filter", "sharded",
                "params.filter is set but this index carries no metadata",
                "build with build_index(..., metadata={col: values}) to "
                "serve filtered queries on a mesh"))
        if bad:
            raise CapabilityError(bad, "serving")
        if ladder is None:
            ladder = build_ladder(self.params, total_trees)
        if not degrade:
            ladder = ladder[:1]
        if mesh is not None:
            # the perf knobs projected onto the mesh-legal set; .sharded()
            # keeps filter and probe_schedule, which ShardedIndex serves
            ladder = tuple(dict.fromkeys(p.sharded() for p in ladder))
        self.ladder: tuple[SearchParams, ...] = tuple(ladder)
        self._rung = 0
        self._counters = {
            "shed_steps": 0, "recover_steps": 0, "requests_degraded": 0,
            "requests_total": 0, "batches_by_rung": [0] * len(self.ladder),
        }
        self._service_s: list[float] = [0.0] * len(self.ladder)
        if mesh is not None:
            # the facade owns the padded rows, the validity bitmap, the id
            # remap and a step per rung; the rungs are already projected,
            # so strict mode guards only what cannot be stripped (filter)
            self._sharded = ShardedIndex(index, mesh, db_axes=db_axes,
                                         tree_axis=tree_axis, strict=True)
        self._batcher = DynamicBatcher(self._serve_batch,
                                       max_batch=max_batch,
                                       max_wait_s=max_wait_s)
        if warmup:
            self.warmup()
        self._shed_depth = (shed_depth if shed_depth is not None
                            else self._derive_shed_depth())
        self._batcher.start()

    # ------------------------------------------------------------ resolve
    @staticmethod
    def _resolve_params(index, params: SearchParams | None,
                        use_tuned: bool) -> SearchParams:
        """Operating-point precedence: explicit > per-shard tuned (v4) >
        host tuned (v3) > SearchParams()."""
        if params is not None:
            return params
        if use_tuned:
            shard_params = getattr(index, "shard_params", None)
            if shard_params:
                return uniform_shard_params(shard_params)
            if index.tuned_params is not None:
                return index.tuned_params
        return SearchParams()

    @classmethod
    def load(cls, path: str, device=None, **kw) -> "ServingRuntime":
        """Stand a runtime up from a saved manifest, loaded onto ``device``
        (the GPU unless ``device="cpu"``): the tuned operating point,
        per-shard params and capacity plan (format 4) all apply without
        retuning; ``kw`` (``mesh=`` among them) go to the runtime."""
        index = load_index(path, device=device)
        plan = cls.manifest_plan(index)
        if plan is not None and "max_batch" not in kw:
            kw["max_batch"] = int(plan.batch)
        if plan is not None and "slo_p99_ms" not in kw:
            kw["slo_p99_ms"] = float(plan.slo_p99_ms)
        return cls(index, **kw)

    @staticmethod
    def manifest_plan(index) -> "planner_mod.CapacityPlan | None":
        sp = getattr(index, "serving_plan", None)
        if sp and sp.get("plan"):
            return planner_mod.CapacityPlan.from_dict(sp["plan"])
        return None

    @staticmethod
    def manifest_traffic_model(index) -> "planner_mod.TrafficModel | None":
        sp = getattr(index, "serving_plan", None)
        if sp and sp.get("traffic_model"):
            return planner_mod.TrafficModel.from_dict(sp["traffic_model"])
        return None

    def _search(self, q: np.ndarray, rung: int
                ) -> tuple[np.ndarray, np.ndarray]:
        """One search at rung ``rung`` (on the mesh when there is one), its
        answer copied to the host (the copy waits for the device)."""
        target = self.index if self.mesh is None else self._sharded
        d, i = target.search(q, self.ladder[rung])
        return d.cpu().numpy(), i.cpu().numpy()

    # ------------------------------------------------------------- serving
    def _serve_batch(self, payloads: list) -> list:
        rung = self._schedule_rung()
        n = len(payloads)
        q = np.stack(payloads)
        if n < self.max_batch:
            # fixed batch shape: pad by repeating the last real query (not
            # zeros) — batch-coupled paths (the adaptive-wave stop rule is
            # a batch mean) must answer as the reference's padded batch
            q = np.concatenate(
                [q, np.repeat(q[-1:], self.max_batch - n, axis=0)])
        dists, ids = self._search(q, rung)
        self._counters["batches_by_rung"][rung] += 1
        self._counters["requests_total"] += n
        if rung > 0:
            self._counters["requests_degraded"] += n
        return [(dists[j], ids[j]) for j in range(n)]

    def _schedule_rung(self) -> int:
        """One ladder step per batch, keyed on queue depth vs the SLO model
        (hysteresis at half the shed depth so the rung doesn't flap)."""
        depth = self._batcher.depth()
        if depth > self._shed_depth and self._rung < len(self.ladder) - 1:
            self._rung += 1
            self._counters["shed_steps"] += 1
        elif depth < max(1, self._shed_depth // 2) and self._rung > 0:
            self._rung -= 1
            self._counters["recover_steps"] += 1
        return self._rung

    def _derive_shed_depth(self) -> int:
        """Queue depth beyond which the SLO is unrecoverable at rung 0.

        A queued request waits ~ depth/max_batch full-batch services; with
        the p99 budget left after one service + the batching wait, the
        drainable depth is ``budget / t_batch * max_batch``.  Without an
        SLO (or before warmup timed the rungs) fall back to 4 batches —
        a queue deeper than that means arrivals outrun service anyway.
        """
        t0 = self._service_s[0]
        if self.slo_p99_ms is None or t0 <= 0:
            return 4 * self.max_batch
        budget = self.slo_p99_ms / 1e3 - self._batcher.max_wait_s - t0
        depth = int(budget / t0 * self.max_batch) if budget > 0 else 0
        return max(self.max_batch, depth)

    def warmup(self) -> list[float]:
        """Warm every ladder rung (its kernels built and loaded) and time
        one steady batch of each, on the caller's thread.

        The timings order-check the ladder, seed the shed threshold, and
        are reused by ``calibrate()`` callers; returns seconds per rung.
        """
        gids, rows = self.index.live_points()
        if rows.shape[0] == 0:
            return self._service_s
        q = rows[np.arange(self.max_batch) % rows.shape[0]].copy()
        for r in range(len(self.ladder)):
            self._search(q, r)            # build / load the kernels
            t0 = time.perf_counter()
            self._search(q, r)
            self._service_s[r] = time.perf_counter() - t0
        return list(self._service_s)

    def calibrate(self, queries: np.ndarray | None = None,
                  batch_grid: Sequence[int] = (1, 8, 32),
                  repeats: int = 5) -> "planner_mod.TrafficModel":
        """Fit the planner's traffic model on THIS runtime's rung-0 step."""
        if queries is None:
            _, rows = self.index.live_points()
            queries = rows[:max(batch_grid)]
        total_trees = int(getattr(self.index.spec.forest, "n_trees", 1))
        return planner_mod.calibrate(
            lambda q: self._search(np.asarray(q), 0), np.asarray(queries),
            batch_grid=batch_grid, repeats=repeats,
            max_wait_s=self._batcher.max_wait_s,
            rows_per_query=_ladder_cost(self.ladder[0], total_trees))

    # ------------------------------------------------------------- surface
    def submit(self, query: np.ndarray):
        return self._batcher.submit(np.asarray(query, np.float32))

    def __call__(self, query: np.ndarray, timeout: float = 30.0):
        return self._batcher(np.asarray(query, np.float32), timeout=timeout)

    def depth(self) -> int:
        return self._batcher.depth()

    @property
    def rung(self) -> int:
        return self._rung

    @property
    def shed_depth(self) -> int:
        return self._shed_depth

    def stats(self) -> dict:
        c = dict(self._counters)
        c["batches_by_rung"] = list(c["batches_by_rung"])
        total = max(1, c["requests_total"])
        return {
            "rung": self._rung,
            "n_rungs": len(self.ladder),
            "shed_depth": self._shed_depth,
            "shed_fraction": c["requests_degraded"] / total,
            "service_s_by_rung": list(self._service_s),
            "sharded": self.mesh is not None,
            **c,
            "batcher": dict(self._batcher.stats),
        }

    def stop(self, drain: bool = True) -> None:
        self._batcher.stop(drain=drain)
