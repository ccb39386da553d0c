"""Serving runtime subsystem (port of ``repro/serve``; DESIGN.md §12,
§15).

    runtime.ServingRuntime   tuned serving + overload degradation, local
                             or row-sharded over a mesh
    planner                  traffic-model capacity planner (QPS x SLO)
    autoscaler               replica fleet + the control loop that re-runs
                             the planner against measured demand
    config                   fleet.yml -> plan() -> fleet stand-up
    loadgen                  open-loop Poisson load generation
    batching.DynamicBatcher  continuous-batching front-end
    ann_serve                legacy index+batcher bridge (kept; the runtime
                             is the serving surface going forward)
"""
from repro_torch.serve.autoscaler import (Autoscaler, AutoscalerConfig,
                                          ReplicaFleet)
from repro_torch.serve.batching import BatcherStopped, DynamicBatcher
from repro_torch.serve.config import FleetHandle, build_fleet, load_config
from repro_torch.serve.loadgen import arrival_schedule, run_open_loop, sweep
from repro_torch.serve.planner import (CapacityPlan, TrafficModel, calibrate,
                                       plan)
from repro_torch.serve.runtime import (ServingRuntime, build_ladder,
                                       uniform_shard_params)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "BatcherStopped", "CapacityPlan",
    "DynamicBatcher", "FleetHandle", "ReplicaFleet", "ServingRuntime",
    "TrafficModel", "arrival_schedule", "build_fleet", "build_ladder",
    "calibrate", "load_config", "plan", "run_open_loop", "sweep",
    "uniform_shard_params",
]
