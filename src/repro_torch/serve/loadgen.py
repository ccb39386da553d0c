"""Open-loop load generation: Poisson arrivals, coordinated-omission-free
(port of ``repro/serve/loadgen.py``).

A closed-loop generator (fire request, wait, fire next — what the old
launch/serve.py did with a thread per request) measures the SERVER's pace,
not the traffic's: when the server slows down, a closed loop politely slows
its offered load and the tail you report is fiction.  This generator is
open-loop: arrivals follow a seeded Poisson process at the target QPS
regardless of completions, and each request's latency is charged from its
*scheduled* arrival time — so dispatcher lag and queueing both land in the
tail where they belong (no coordinated omission).

    report = run_open_loop(runtime, queries, qps=500, n_requests=2000)
    # report: achieved_qps, p50/p99/p999_ms, shed_fraction, recall...

Determinism: the arrival schedule and the query assigned to each request
are pure functions of (qps, n_requests, seed) — ``arrival_schedule`` is
exposed separately so tests can pin that.  Latencies are wall-clock and of
course are not.

``sweep`` walks a QPS ladder past saturation; the achieved-vs-offered gap,
the shed fraction and the p999 curve together locate the knee — the
measured rated capacity the planner's model is validated against
(benchmarks/serving_slo.py).
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

__all__ = ["arrival_schedule", "run_open_loop", "sweep"]


def arrival_schedule(qps: float, n_requests: int,
                     seed: int = 0) -> np.ndarray:
    """Cumulative arrival offsets (s) of a Poisson process at ``qps``.

    Deterministic in (qps, n_requests, seed); exponential inter-arrivals,
    first arrival at t=0 so a 1-request schedule is instant.
    """
    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / qps, size=max(0, n_requests - 1))
    return np.concatenate([[0.0], np.cumsum(gaps)])


def _percentiles(lat_ms: np.ndarray) -> dict:
    if lat_ms.size == 0:
        return {"p50_ms": float("nan"), "p99_ms": float("nan"),
                "p999_ms": float("nan"), "max_ms": float("nan")}
    return {"p50_ms": round(float(np.percentile(lat_ms, 50)), 3),
            "p99_ms": round(float(np.percentile(lat_ms, 99)), 3),
            "p999_ms": round(float(np.percentile(lat_ms, 99.9)), 3),
            "max_ms": round(float(lat_ms.max()), 3)}


def run_open_loop(runtime, queries: np.ndarray, qps: float,
                  n_requests: int = 1000, seed: int = 0,
                  timeout_s: float = 120.0,
                  true_ids: np.ndarray | None = None) -> dict:
    """Drive ``runtime`` (ServingRuntime or DynamicBatcher) open-loop.

    Request ``j`` uses ``queries[j % len(queries)]`` and is submitted at
    ``t0 + schedule[j]`` (if the dispatcher falls behind it submits
    immediately but latency is STILL charged from the scheduled time).
    ``true_ids`` (Q, k') enables recall-vs-oracle over the completed
    requests.  Returns the standard report dict; shed/degradation counters
    are read as a delta around the run when the runtime exposes them.
    """
    queries = np.asarray(queries, np.float32)
    sched = arrival_schedule(qps, n_requests, seed)
    # ServingRuntime.stats is a method; a bare DynamicBatcher exposes a
    # plain stats dict with no shed counters — only read the former
    stats_fn = getattr(runtime, "stats", None)
    stats_fn = stats_fn if callable(stats_fn) else None
    shed0 = stats_fn().get("requests_degraded", 0) if stats_fn else 0

    reqs = [None] * n_requests
    t0 = time.perf_counter()
    for j in range(n_requests):
        delay = t0 + sched[j] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        reqs[j] = runtime.submit(queries[j % len(queries)])
    dispatch_s = time.perf_counter() - t0

    deadline = time.perf_counter() + timeout_s
    n_failed = n_timeout = 0
    lat_ms = np.full(n_requests, np.nan)
    results = [None] * n_requests
    for j, req in enumerate(reqs):
        if not req.event.wait(max(0.0, deadline - time.perf_counter())):
            n_timeout += 1
            continue
        if req.error is not None:
            n_failed += 1
            continue
        # open-loop accounting: latency from the SCHEDULED arrival (done_t
        # is stamped by the batcher worker, so waiting for events in
        # submission order doesn't skew later completions)
        lat_ms[j] = (req.done_t - (t0 + sched[j])) * 1e3
        results[j] = req.result
    done = np.isfinite(lat_ms)
    n_ok = int(done.sum())
    # wall clock of the run = last completion offset (arrival + sojourn)
    wall_s = (float(np.nanmax(sched + lat_ms / 1e3)) if n_ok
              else dispatch_s)
    wall_s = max(wall_s, dispatch_s, 1e-9)

    report = {
        "offered_qps": round(float(qps), 3),
        "achieved_qps": round(n_ok / wall_s, 3) if wall_s > 0 else 0.0,
        "n_requests": n_requests, "n_ok": n_ok, "n_failed": n_failed,
        "n_timeout": n_timeout, "seed": seed,
        "dispatch_lag_ms": round(
            max(0.0, float(dispatch_s - sched[-1]) * 1e3), 3),
        **_percentiles(lat_ms[done]),
    }
    if stats_fn:
        after = stats_fn()
        window = max(1, n_ok)
        report["shed_fraction"] = round(
            (after.get("requests_degraded", 0) - shed0) / window, 4)
        report["rung_final"] = after.get("rung", 0)
        report["shed_steps_total"] = after.get("shed_steps", 0)
    if true_ids is not None and n_ok:
        true_ids = np.asarray(true_ids)
        hits = []
        for j in range(n_requests):
            if results[j] is None:
                continue
            got = np.asarray(results[j][1]).ravel()
            truth = true_ids[j % len(queries)]
            hits.append(np.isin(truth, got).mean())
        report["recall_vs_oracle"] = round(float(np.mean(hits)), 4)
    return report


def sweep(runtime, queries: np.ndarray, qps_list: Sequence[float],
          n_requests: int = 500, seed: int = 0,
          true_ids: np.ndarray | None = None,
          settle_s: float = 0.25) -> list[dict]:
    """One ``run_open_loop`` per QPS point, letting the queue drain between
    points (``settle_s``) so saturation at rate i doesn't bleed into the
    rate i+1 measurement.  Returns the report rows in sweep order."""
    rows = []
    for i, qps in enumerate(qps_list):
        rows.append(run_open_loop(runtime, queries, qps,
                                  n_requests=n_requests, seed=seed + i,
                                  true_ids=true_ids))
        time.sleep(settle_s)
    return rows
