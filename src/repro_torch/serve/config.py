"""Config-driven fleet stand-up: a small yml schema -> plan() + runtimes
(port of ``repro/serve/config.py``).

A serving fleet used to be hand-wired kwargs across ``ServingRuntime``,
``planner.plan`` and the mesh helpers; this module makes it a file
(DESIGN.md §15):

    # fleet.yml
    index: runs/wiki.idx            # saved manifest (ServingRuntime.load
                                    # semantics: plan/tuned params apply)
    serving:
      slo_p99_ms: 25.0
      max_batch: 32
      max_wait_s: 0.002
      degrade: true
    mesh:                           # optional: serve row-sharded
      shape: [4, 2]                 # (core/sharded_index.Mesh on the
      axes: [data, model]           # index's device)
    autoscale:                      # optional: close the planner loop
      enabled: true
      qps: 500.0                    # initial sizing target for plan()
      min_replicas: 1
      max_replicas: 8
      cooldown_s: 1.0
      scale_down_cooldown_s: 4.0
      hysteresis: 0.15

    handle = build_fleet("fleet.yml")     # plan -> replicas -> autoscaler
    handle.fleet(query)                   # serve
    handle.stop()

Parsing prefers PyYAML when importable and falls back to a built-in
parser covering exactly this schema's subset (nested maps by 2-space
indentation, scalars, inline ``[a, b]`` lists, ``#`` comments) — the
serving stack adds no hard dependency.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["load_config", "build_fleet", "FleetHandle"]


# --------------------------------------------------------------- parsing
def _scalar(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        return [_scalar(t) for t in inner.split(",")] if inner else []
    if (tok.startswith('"') and tok.endswith('"')) or \
            (tok.startswith("'") and tok.endswith("'")):
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none", "~", ""):
        return None
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            return tok


def _parse_simple_yaml(text: str) -> dict:
    """Indentation-nested ``key: value`` maps — the fleet.yml subset."""
    root: dict = {}
    stack: list[tuple[int, dict]] = [(-1, root)]
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, rest = line.strip().partition(":")
        while stack and indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if rest.strip():
            parent[key.strip()] = _scalar(rest)
        else:
            child: dict = {}
            parent[key.strip()] = child
            stack.append((indent, child))

    def _none_empty(d: dict):
        # a key that never got children parses as None (PyYAML parity)
        return {k: (_none_empty(v) or None) if isinstance(v, dict) else v
                for k, v in d.items()}

    return _none_empty(root)


def load_config(path: str) -> dict:
    """Parse a fleet.yml (PyYAML when available, built-in subset parser
    otherwise)."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
        return yaml.safe_load(text) or {}
    except ImportError:
        return _parse_simple_yaml(text)


# ---------------------------------------------------------------- wiring
@dataclasses.dataclass
class FleetHandle:
    """Everything ``build_fleet`` stood up, with one ``stop()``."""

    fleet: Any                       # ReplicaFleet
    autoscaler: Any | None           # Autoscaler (started) or None
    plan: Any | None                 # initial CapacityPlan or None
    model: Any | None                # TrafficModel the plan/loop use
    config: dict                     # the parsed config, as wired
    index: Any                       # the loaded/received Index

    def __call__(self, query, timeout: float = 30.0):
        return self.fleet(query, timeout=timeout)

    def stop(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.fleet.stop()


def build_fleet(config: str | dict, index=None, model=None,
                device=None) -> FleetHandle:
    """Stand a fleet up from a fleet.yml path (or parsed dict).

    The stand-up order is the planner's pipeline made config-driven: load
    the manifest onto ``device`` (the GPU unless ``device="cpu"``; tuned
    params + serving plan apply via ``ServingRuntime``'s own resolution),
    obtain a traffic model (manifest first, calibration on a probe runtime
    otherwise), ``plan()`` the initial replica count for the configured
    qps, then optionally start the autoscaler that keeps re-running that
    plan against measured demand.

    ``index`` / ``model`` override the manifest for callers that already
    hold one (tests, benchmarks).  A ``mesh:`` section serves every
    replica row-sharded over a ``Mesh(shape, axes)`` on the index's device
    (db axis ``data``, tree axis ``model``).
    """
    from repro_torch.serve import planner as planner_mod
    from repro_torch.serve.autoscaler import (Autoscaler,
                                              AutoscalerConfig, ReplicaFleet)
    from repro_torch.serve.runtime import ServingRuntime

    cfg = load_config(config) if isinstance(config, str) else dict(config)
    serving = dict(cfg.get("serving") or {})
    mesh_cfg = cfg.get("mesh") or {}
    auto_cfg = dict(cfg.get("autoscale") or {})

    if index is None:
        path = cfg.get("index")
        if not path:
            raise ValueError("fleet config needs an 'index: <manifest>' "
                             "entry (or pass index=)")
        from repro_torch.index import load_index
        index = load_index(path, device=device)

    mesh = None
    if mesh_cfg:
        from repro_torch.core.sharded_index import Mesh
        shape = tuple(int(s) for s in mesh_cfg.get("shape", ()))
        axes = tuple(str(a) for a in mesh_cfg.get("axes",
                                                  ("data", "model")))
        mesh = Mesh(shape, axes, device=index.device)   # raises on mismatch

    manifest_plan = ServingRuntime.manifest_plan(index)
    slo = serving.get("slo_p99_ms",
                      manifest_plan.slo_p99_ms if manifest_plan else 25.0)
    rt_kw = dict(
        slo_p99_ms=float(slo),
        max_batch=int(serving.get(
            "max_batch", manifest_plan.batch if manifest_plan else 64)),
        max_wait_s=float(serving.get("max_wait_s", 0.002)),
        degrade=bool(serving.get("degrade", True)),
        use_tuned=bool(serving.get("use_tuned", True)),
        mesh=mesh)

    def make_replica(batch: int | None = None):
        kw = dict(rt_kw)
        if batch:
            kw["max_batch"] = int(batch)
        return ServingRuntime(index, **kw)

    if model is None:
        model = ServingRuntime.manifest_traffic_model(index)
    plan = None
    n0 = int(auto_cfg.get("min_replicas", 1))
    target_qps = auto_cfg.get("qps", serving.get("qps"))
    fleet = None
    if model is None and (target_qps or auto_cfg.get("enabled")):
        # no manifest model: calibrate on a probe replica, which then
        # joins the fleet as replica 0 (calibration is read-only traffic)
        probe = make_replica()
        model = probe.calibrate()
        seed = [probe]

        def seeded(batch: int | None = None):
            return seed.pop() if seed else make_replica(batch)

        fleet = ReplicaFleet(seeded, n_replicas=1)
    if model is not None and target_qps:
        try:
            plan = planner_mod.plan(
                model, qps=float(target_qps), slo_p99_ms=float(slo),
                max_shards=1,
                max_replicas=int(auto_cfg.get("max_replicas", 8)),
                utilization=float(auto_cfg.get("utilization", 0.7)))
            n0 = max(n0, plan.n_replicas)
        except ValueError:
            n0 = int(auto_cfg.get("max_replicas", 8))
    if fleet is None:
        fleet = ReplicaFleet(make_replica, n_replicas=n0)
    elif fleet.n_replicas < n0:
        fleet.scale_to(n0)

    scaler = None
    if auto_cfg.get("enabled") and model is not None:
        ac = AutoscalerConfig.from_dict({"slo_p99_ms": float(slo),
                                         **auto_cfg})
        scaler = Autoscaler(fleet, model, ac).start()
    return FleetHandle(fleet=fleet, autoscaler=scaler, plan=plan,
                       model=model, config=cfg, index=index)
