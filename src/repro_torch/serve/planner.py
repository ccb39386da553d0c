"""Traffic-model capacity planner: QPS x p99 SLO -> shards/replicas/params
(port of ``repro/serve/planner.py``; plain host math).

The paper promises *efficient searching at scale*; this module makes the
fleet-sizing half of that measurable instead of guessed.  From a few short
calibration runs it fits an affine batch-latency model per operating point
(degradation rung), then answers the operator's question directly:

    model = calibrate(search_fn, queries, batch_grid=(1, 8, 32))
    plan  = plan(model, qps=2000, slo_p99_ms=25, n_rows=index.n_rows)
    # -> CapacityPlan(n_shards=2, n_replicas=3, rated_qps_per_replica=812,
    #                 predicted_p99_ms=21.4, ...)

Traffic model (DESIGN.md §12).  One batched search of size ``b`` costs

    t(b) = c0 + c1 * b                       (seconds; least-squares fit)

``c0`` is the fixed dispatch/kernel-launch floor, ``c1`` the marginal
per-query cost (linear in rows touched per query, which is the tuner's
cost proxy — DESIGN.md §9).  Under open-loop Poisson arrivals at rate
``lam`` served in batches of up to ``B``, a replica's utilization is
``rho = lam * t(B) / B`` and the modeled p99 sojourn is

    p99(lam) ~= w + t(B) / (1 - rho)         (w = batcher max_wait)

— the standard single-server heavy-traffic inflation: service time
stretched by the queueing factor 1/(1-rho), plus the batching delay.  The
model is deliberately coarse (it is fit from ~seconds of calibration) but
it is *monotone* in lam, so inverting it for the rated QPS at a given SLO
is exact, and the serving_slo benchmark closes the loop by measuring the
real p99 at the plan's rated QPS.

Sharding enters through ``c1``: DB rows shard evenly across ``s`` shards
(core/sharded_index.py), each cell reranks ~1/s of the candidate rows, so
the per-query marginal cost scales like ``c1 / s`` while the floor ``c0``
(traversal depth, merge, dispatch) does not.  ``plan`` picks the smallest
shard count whose modeled service time fits inside the SLO with queueing
headroom, then the replica count that carries the offered QPS.

Everything here is plain host math — no torch — so the planner can run in
a control plane far from the accelerators.  ``TrafficModel``/``CapacityPlan``
round-trip through dicts and ride the index manifest (format 4).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np

__all__ = ["TrafficModel", "CapacityPlan", "calibrate", "plan",
           "rated_qps"]


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Affine batch-latency model of one operating point on one host.

    c0_s / c1_s      fit of t(b) = c0 + c1*b (seconds)
    max_wait_s       batching delay budget the model was asked about
    batch_grid       batch sizes measured
    measured_s       median latency at each grid point (evidence, kept for
                     refits and for the manifest)
    rows_per_query   the operating point's cost proxy (tuner units); lets a
                     refit rescale c1 when the operating point changes
                     without re-measuring
    """

    c0_s: float
    c1_s: float
    max_wait_s: float = 0.002
    batch_grid: tuple[int, ...] = ()
    measured_s: tuple[float, ...] = ()
    rows_per_query: float = 0.0

    def service_s(self, batch: int, n_shards: int = 1) -> float:
        """Modeled latency of one batch of ``batch`` on ``n_shards`` shards
        (marginal cost scales 1/s, the fixed floor does not)."""
        return self.c0_s + self.c1_s * batch / max(1, n_shards)

    def p99_s(self, qps: float, batch: int, n_shards: int = 1) -> float:
        """Modeled p99 sojourn at offered ``qps`` (inf past saturation)."""
        t = self.service_s(batch, n_shards)
        rho = qps * t / batch
        if rho >= 1.0:
            return float("inf")
        return self.max_wait_s + t / (1.0 - rho)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrafficModel":
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        d["batch_grid"] = tuple(d.get("batch_grid", ()))
        d["measured_s"] = tuple(d.get("measured_s", ()))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """``plan()``'s answer: the fleet shape for (qps, slo) + its evidence.

    Persisted into the index manifest (format 4) so a loaded index carries
    not just its tuned operating point but the fleet it was sized for.
    """

    qps: float                   # offered load the plan was sized for
    slo_p99_ms: float            # the latency promise
    n_shards: int                # DB shards per replica (latency axis)
    n_replicas: int              # identical serving replicas (throughput)
    batch: int                   # serving batch size
    rated_qps_per_replica: float  # max QPS one replica sustains in-SLO
    predicted_p99_ms: float      # modeled p99 at the offered per-replica QPS
    utilization: float           # headroom derate used when sizing
    recall_target: float = 0.0   # the tune() target this plan serves (0 =
    #                              unknown); the serving_slo gate checks it

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CapacityPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def fit_affine(batch_sizes: Sequence[int],
               latencies_s: Sequence[float]) -> tuple[float, float]:
    """Least-squares (c0, c1) of t(b) = c0 + c1*b, clamped nonnegative.

    With a single grid point the whole latency is charged to c1 (the
    conservative split: predicted big-batch latency is then an upper
    bound).
    """
    b = np.asarray(batch_sizes, np.float64)
    t = np.asarray(latencies_s, np.float64)
    if b.size == 0:
        raise ValueError("cannot fit a latency model from zero points")
    if b.size == 1:
        return 0.0, float(t[0] / max(b[0], 1.0))
    a = np.stack([np.ones_like(b), b], axis=1)
    (c0, c1), *_ = np.linalg.lstsq(a, t, rcond=None)
    return float(max(c0, 0.0)), float(max(c1, 1e-9))


def calibrate(search_fn: Callable[[np.ndarray], Any], queries: np.ndarray,
              batch_grid: Sequence[int] = (1, 8, 32), repeats: int = 5,
              max_wait_s: float = 0.002,
              rows_per_query: float = 0.0) -> TrafficModel:
    """Short calibration run -> TrafficModel.

    ``search_fn(q_batch)`` must block until results are on the host (the
    serving runtime passes its warmed per-rung step, which ends in a copy
    to the host): a CUDA search returns before the device finishes, and
    timing only its launches would make the model's service times far too
    small.  Each grid point is measured ``repeats`` times and the MEDIAN
    kept (a first kernel build or load and GC pauses land in the discarded
    tail).  Wall cost: ~grid x repeats
    searches — seconds, by design, so planning can rerun on every deploy.
    """
    queries = np.asarray(queries)
    grid = sorted({int(b) for b in batch_grid if b >= 1})
    med = []
    for b in grid:
        reps = min(b, queries.shape[0])
        q = queries[np.arange(b) % queries.shape[0]] if reps else queries[:b]
        search_fn(q)                       # warm the shape
        ts = []
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            search_fn(q)
            ts.append(time.perf_counter() - t0)
        med.append(float(np.median(ts)))
    c0, c1 = fit_affine(grid, med)
    return TrafficModel(c0_s=c0, c1_s=c1, max_wait_s=max_wait_s,
                        batch_grid=tuple(grid), measured_s=tuple(med),
                        rows_per_query=rows_per_query)


def rated_qps(model: TrafficModel, slo_p99_ms: float, batch: int,
              n_shards: int = 1, utilization: float = 0.7) -> float:
    """Max in-SLO QPS for one replica: invert p99(lam) <= slo, derated.

    The inversion of ``w + t/(1-rho) <= slo`` gives the critical rate
    ``lam* = (1 - t/(slo - w)) * B / t``; the ``utilization`` derate keeps
    headroom for burstiness the Poisson mean doesn't capture (0.7 is the
    classic serving-fleet target).  Returns 0.0 when the SLO is infeasible
    at this batch/shard point (service alone exceeds it).
    """
    slo_s = slo_p99_ms / 1e3
    t = model.service_s(batch, n_shards)
    budget = slo_s - model.max_wait_s
    if budget <= t:
        return 0.0
    lam_crit = (1.0 - t / budget) * batch / t
    return max(0.0, lam_crit * utilization)


def plan(model: TrafficModel, qps: float, slo_p99_ms: float,
         batch_grid: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
         max_shards: int = 64, max_replicas: int = 4096,
         utilization: float = 0.7, recall_target: float = 0.0
         ) -> CapacityPlan:
    """Answer "given QPS X and p99 SLO Y, what fleet?".

    Walks shard counts upward (1, 2, 4, ...) until some batch size serves
    in-SLO with queueing headroom, picks the batch with the highest rated
    QPS at that shard count (fewest replicas), then sizes the replica
    count for the offered load.  Raises ValueError when no point within
    ``max_shards`` can meet the SLO — an honest "this SLO is not
    servable", rather than a plan that will melt.
    """
    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    shards = 1
    while shards <= max_shards:
        best: tuple[float, int] | None = None      # (rated, batch)
        for b in sorted({int(x) for x in batch_grid if x >= 1}):
            r = rated_qps(model, slo_p99_ms, b, shards, utilization)
            if r > 0 and (best is None or r > best[0]):
                best = (r, b)
        if best is not None:
            per_replica, batch = best
            n_replicas = int(np.ceil(qps / per_replica))
            if n_replicas <= max_replicas:
                lam = qps / n_replicas
                return CapacityPlan(
                    qps=float(qps), slo_p99_ms=float(slo_p99_ms),
                    n_shards=shards, n_replicas=n_replicas, batch=batch,
                    rated_qps_per_replica=round(per_replica, 3),
                    predicted_p99_ms=round(
                        model.p99_s(lam, batch, shards) * 1e3, 3),
                    utilization=utilization,
                    recall_target=float(recall_target))
        shards *= 2
    raise ValueError(
        f"no plan within {max_shards} shards meets p99<={slo_p99_ms}ms at "
        f"{qps} qps (model floor c0={model.c0_s * 1e3:.2f}ms, "
        f"max_wait={model.max_wait_s * 1e3:.2f}ms) — relax the SLO or "
        "cheapen the operating point")
