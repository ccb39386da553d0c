"""Live autoscaling: the control loop that closes the planner's loop (port
of ``repro/serve/autoscaler.py``; host code).

The planner answers "given QPS X and SLO Y, what fleet?" — but on its own
it emits a static plan nothing acts on: a 2x-rated burst against a
statically-planned fleet sheds (degrades recall) forever, because the
degradation ladder is a LATENCY actuator, not a CAPACITY one.  This module
adds the capacity actuator (DESIGN.md §15):

  * :class:`ReplicaFleet` — N identical ``ServingRuntime`` replicas behind
    one least-depth ``submit``; ``scale_to`` adds replicas (warmed by
    their own warmup) or drains retired ones in the background without
    dropping queued requests.
  * :class:`Autoscaler` — a control loop over the fleet's own counters:
    each ``step()`` measures demand over the window as
    ``completions + queue growth`` (completions alone under-report an
    overloaded fleet — the queue is where the excess went), re-runs
    ``planner.plan`` against the measured traffic model, and resizes with
    hysteresis (a dead band around the current rated capacity) plus
    asymmetric cooldowns (scale-up after ``cooldown_s``; scale-down only
    after ``scale_down_cooldown_s`` of calm) so a burst scales up instead
    of shedding forever, and the burst's end doesn't flap the fleet.

Determinism for tests: the clock is injectable (``clock=``), ``step()`` is
pure control logic over ``fleet.stats()``, and every decision is recorded
in ``Autoscaler.history`` with its inputs.  The background ``start()``
thread is a convenience wrapper that just calls ``step()`` on a period.

Config-driven stand-up (the yml schema -> ``plan()`` / ``ServingRuntime``
wiring) lives in :mod:`repro_torch.serve.config`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

from repro_torch.serve import planner as planner_mod

__all__ = ["AutoscalerConfig", "Autoscaler", "ReplicaFleet"]


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Control-loop knobs (all times in seconds).

    slo_p99_ms            the SLO the planner re-plans against
    min_replicas          floor (never drain below)
    max_replicas          ceiling (planner targets clamp here)
    interval_s            ``start()``'s control period
    cooldown_s            min time between resizes (scale-up direction)
    scale_down_cooldown_s min CALM time before a scale-down — longer than
                          the up cooldown on purpose: adding capacity late
                          sheds requests, removing it late only costs money
    hysteresis            dead band: scale up only when measured demand
                          exceeds current rated capacity by this fraction,
                          down only when it fits the smaller fleet with
                          this much room — demand inside the band never
                          resizes, which bounds oscillation
    utilization           the planner's derate (headroom for burstiness)
    shed_panic            windowed shed fraction that overrides the dead
                          band (not the cooldown): the fleet is visibly
                          degrading, scale on the next legal tick
    demand_smoothing      EWMA weight of the newest window's demand
                          estimate (1.0 = no smoothing)
    """

    slo_p99_ms: float
    min_replicas: int = 1
    max_replicas: int = 8
    interval_s: float = 0.25
    cooldown_s: float = 1.0
    scale_down_cooldown_s: float = 4.0
    hysteresis: float = 0.15
    utilization: float = 0.7
    shed_panic: float = 0.05
    demand_smoothing: float = 0.5

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AutoscalerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class ReplicaFleet:
    """N identical serving replicas behind one least-depth dispatcher.

    ``make_replica`` is a zero-arg (or ``batch=``-accepting) factory
    returning a started ``ServingRuntime``; the fleet owns the replicas'
    lifecycle.  Retiring replicas drain in the background (their queued
    requests complete) and their counters fold into the fleet totals, so
    ``stats()`` stays monotone across resizes — the property the loadgen's
    delta-based shed accounting and the autoscaler's demand estimator both
    rely on.
    """

    def __init__(self, make_replica: Callable, n_replicas: int = 1,
                 batch: int | None = None):
        self._make = make_replica
        self._batch = batch
        self._lock = threading.Lock()
        self._retired = {"requests_total": 0, "requests_degraded": 0,
                         "shed_steps": 0, "recover_steps": 0}
        self._drainers: list[threading.Thread] = []
        self.resizes: list[dict] = []
        self._replicas = [self._spawn() for _ in range(max(1, n_replicas))]

    def _spawn(self):
        if self._batch is not None:
            try:
                return self._make(batch=self._batch)
            except TypeError:
                pass   # factory ignores batch re-planning
        return self._make()

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    @property
    def replicas(self) -> list:
        return list(self._replicas)

    # ---------------------------------------------------------- dispatch
    def submit(self, query):
        with self._lock:
            target = min(self._replicas, key=lambda r: r.depth())
        return target.submit(query)

    def __call__(self, query, timeout: float = 30.0):
        req = self.submit(query)
        if not req.event.wait(timeout):
            raise TimeoutError(f"no result within {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------ sizing
    def scale_to(self, n: int, batch: int | None = None) -> int:
        """Resize to ``n`` replicas (>=1); returns the new count.

        Growth spawns (and warms up) new replicas before they join the
        dispatch set; shrink retires the deepest-queued last, draining each
        retiree in a background thread so in-flight requests finish.
        """
        n = max(1, int(n))
        if batch is not None:
            self._batch = int(batch)
        with self._lock:
            before = len(self._replicas)
            while len(self._replicas) < n:
                self._replicas.append(self._spawn())
            retirees = []
            if len(self._replicas) > n:
                # retire the shallowest queues first: least work to drain
                keep = sorted(self._replicas, key=lambda r: -r.depth())
                self._replicas, retirees = keep[:n], keep[n:]
            if before != n:
                self.resizes.append({"t": time.monotonic(),
                                     "from": before, "to": n})
        for r in retirees:
            st = r.stats()
            for key in self._retired:
                self._retired[key] += st.get(key, 0)
            th = threading.Thread(target=r.stop, kwargs={"drain": True},
                                  daemon=True)
            th.start()
            self._drainers.append(th)
        return n

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            reps = list(self._replicas)
        per = [r.stats() for r in reps]
        agg = dict(self._retired)
        for st in per:
            for key in self._retired:
                agg[key] += st.get(key, 0)
        agg["n_replicas"] = len(reps)
        agg["depth"] = sum(r.depth() for r in reps)
        agg["rung"] = max((st.get("rung", 0) for st in per), default=0)
        total = max(1, agg["requests_total"])
        agg["shed_fraction"] = agg["requests_degraded"] / total
        agg["resizes"] = len(self.resizes)
        return agg

    def stop(self, drain: bool = True) -> None:
        with self._lock:
            reps, self._replicas = self._replicas, []
        for r in reps:
            r.stop(drain=drain)
        for th in self._drainers:
            th.join(timeout=30.0)


class Autoscaler:
    """Measured-demand -> planner -> resize, with hysteresis + cooldown.

    ``step()`` is one control tick; ``start()`` runs ticks on
    ``config.interval_s`` in a daemon thread.  The traffic model is the
    calibrated/manifest one the static plan used — re-planning against it
    with MEASURED demand is exactly "re-run the planner against the
    measured traffic model".
    """

    def __init__(self, fleet: ReplicaFleet, model: "planner_mod.TrafficModel",
                 config: AutoscalerConfig, batch: int | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.fleet = fleet
        self.model = model
        self.config = config
        self.batch = int(batch) if batch else None
        self._clock = clock
        self._prev: tuple | None = None     # (t, total, depth, degraded)
        self._demand: float = 0.0           # EWMA demand estimate (qps)
        self._last_resize_t: float | None = None
        self._calm_since: float | None = None
        self.history: list[dict] = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ control
    def _serving_batch(self) -> int | None:
        """The batch the fleet actually serves at, or None if unknowable.

        Planning against the full batch grid lets the planner claim
        capacity the live replicas don't have (a replica built at batch 32
        cannot serve at batch 8's rated qps) — so the re-plan is pinned to
        the fleet's real batch whenever it can be observed.
        """
        if self.batch:
            return self.batch
        b = getattr(self.fleet, "_batch", None)
        if b:
            return int(b)
        for r in getattr(self.fleet, "replicas", []) or []:
            mb = getattr(r, "max_batch", None)
            if mb:
                return int(mb)
        return None

    def _plan_for(self, qps: float) -> tuple[int, float, int]:
        """(target replicas, rated qps/replica, batch) for measured qps —
        the planner re-run, clamped to the config's fleet bounds."""
        cfg = self.config
        kw = {}
        b = self._serving_batch()
        if b:
            kw["batch_grid"] = (b,)
        try:
            plan = planner_mod.plan(
                self.model, qps=max(qps, 1e-3), slo_p99_ms=cfg.slo_p99_ms,
                max_shards=1, max_replicas=cfg.max_replicas,
                utilization=cfg.utilization, **kw)
            return (min(max(plan.n_replicas, cfg.min_replicas),
                        cfg.max_replicas),
                    plan.rated_qps_per_replica, plan.batch)
        except ValueError:
            # demand exceeds what max_replicas serves in-SLO (or the SLO is
            # infeasible outright): pin the ceiling, shed handles the rest
            return cfg.max_replicas, 0.0, 0

    def step(self) -> dict:
        """One control tick; returns (and records) the decision."""
        cfg = self.config
        now = self._clock()
        st = self.fleet.stats()
        total, depth = st["requests_total"], st["depth"]
        degraded = st["requests_degraded"]
        n_now = self.fleet.n_replicas
        decision = {"t": now, "n_replicas": n_now, "action": "hold",
                    "reason": "", "demand_qps": 0.0, "shed_window": 0.0}
        if self._prev is None:
            # first tick only baselines the counters
            self._prev = (now, total, depth, degraded)
            self._calm_since = now
            decision["reason"] = "baseline"
            self.history.append(decision)
            return decision
        t0, total0, depth0, degraded0 = self._prev
        dt = max(now - t0, 1e-6)
        self._prev = (now, total, depth, degraded)
        served = (total - total0) / dt
        # demand = completions + queue growth: an overloaded fleet completes
        # at capacity, the excess shows up as queue depth
        inst = max(0.0, served + (depth - depth0) / dt)
        a = cfg.demand_smoothing
        self._demand = a * inst + (1.0 - a) * self._demand
        shed_win = ((degraded - degraded0) / max(1, total - total0))
        decision["demand_qps"] = round(self._demand, 3)
        decision["shed_window"] = round(shed_win, 4)

        target, per_replica, batch = self._plan_for(self._demand)
        decision["planned_replicas"] = target
        decision["planned_batch"] = batch
        capacity = n_now * per_replica
        panicking = shed_win > cfg.shed_panic
        if panicking or self._demand > capacity:
            self._calm_since = None
        elif self._calm_since is None:
            self._calm_since = now
        since_resize = (now - self._last_resize_t
                        if self._last_resize_t is not None else float("inf"))

        if target > n_now:
            over = (per_replica <= 0.0
                    or self._demand > capacity * (1.0 + cfg.hysteresis))
            if (panicking or over) and since_resize >= cfg.cooldown_s:
                self.fleet.scale_to(target, batch=batch or None)
                self._last_resize_t = now
                decision.update(action="up", n_replicas=target,
                                reason="panic" if panicking else "demand")
            else:
                decision["reason"] = ("cooldown" if since_resize
                                      < cfg.cooldown_s else "dead-band")
        elif target < n_now and n_now > cfg.min_replicas:
            smaller = n_now - 1        # step down one at a time
            fits = (per_replica > 0.0
                    and self._demand < smaller * per_replica
                    * (1.0 - cfg.hysteresis))
            calm = (self._calm_since is not None
                    and now - self._calm_since >= cfg.scale_down_cooldown_s)
            if fits and calm and since_resize >= cfg.scale_down_cooldown_s:
                self.fleet.scale_to(smaller, batch=batch or None)
                self._last_resize_t = now
                decision.update(action="down", n_replicas=smaller,
                                reason="calm")
            else:
                decision["reason"] = "awaiting-calm" if not calm else \
                    ("cooldown" if since_resize < cfg.scale_down_cooldown_s
                     else "dead-band")
        else:
            decision["reason"] = "at-target"
        self.history.append(decision)
        return decision

    # --------------------------------------------------------- background
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.interval_s):
                try:
                    self.step()
                except Exception:       # control must not die mid-burst
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def stats(self) -> dict:
        ups = sum(1 for d in self.history if d["action"] == "up")
        downs = sum(1 for d in self.history if d["action"] == "down")
        return {"ticks": len(self.history), "scale_ups": ups,
                "scale_downs": downs, "n_replicas": self.fleet.n_replicas,
                "demand_qps": round(self._demand, 3)}
