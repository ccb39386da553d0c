"""One run of one cell: set-up, warm-up, the timed window, the traced
window, the judge, and the result line.

A driver (``drivers/<name>.py``, named by the traffic's ``driver``) does
the cell's work through ``run(ctx) -> Outcome``; this module picks the
metrics the cell reports, reads the per-layer ones from the traced window,
and decides ``correct`` from the judge's numbers and their limits.
"""
from __future__ import annotations

import dataclasses
import sys
import time

from bench import judge, manifest, trace


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object            # torch.device
    t0: float                 # perf_counter at process start
    system: object            # systems/<name>.py System, or a stand-in
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        """The end of a phase of set-up, for its breakdown on stderr."""
        self.marks.append((phase, now()))

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Outcome:
    e2e: dict                          # end-to-end metric -> value
    attempted: int
    failed: int
    numbers: dict                      # compared number -> value
    memory_peak_bytes: int = 0
    observation: trace.Observation | None = None


class Fence:
    """An event after the work enqueued so far (nothing on the CPU, where
    the work is done when the call returns)."""

    def __init__(self, ctx: Context):
        self.event = None
        if ctx.cuda:
            import torch
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def make_data(ctx: Context):
    """(rows, queries) of the configuration, made on the device from the
    seed."""
    import torch
    cfg = ctx.config
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    data = manifest.module("data", cfg["data"]["generator"])
    return data.make(cfg["data"], cfg["n"], cfg["n_queries"], cfg["d"], gen,
                     ctx.device)


def run_cell(man: manifest.Manifest, cell_name: str, seed: int,
             seconds: float, traced: bool, device, t0: float,
             system=None, config: dict | None = None,
             traffic: dict | None = None, marks=()) -> dict:
    """The result line's object; its last key, ``checks``, holds each
    compared number beside its limit.  ``system``, ``config`` and
    ``traffic`` replace the cell's own (the tests' stand-ins and tiny
    sizes); ``marks`` are the (phase, end) of set-up before this call."""
    import torch
    cell = man.cell(cell_name)
    config = config or man.config(cell["config"])
    traffic = traffic or man.traffic(cell["traffic"])
    if system is None:
        system = manifest.module("systems", config["system"]).System(
            config, traffic)
    ctx = Context(config=config, traffic=traffic, seed=seed,
                  seconds=seconds, trace=traced, device=torch.device(device),
                  t0=t0, system=system, marks=list(marks))
    ctx.mark("program")
    out = manifest.module("drivers", traffic["driver"]).run(ctx)
    ends = [t for _, t in ctx.marks]
    print("bench: set-up by phase: " + ", ".join(
        f"{phase} {end - start:.3f} s" for (phase, end), start in
        zip(ctx.marks, [t0] + ends)), file=sys.stderr)

    checks = judge.verdict(out.numbers, config["limits"])
    correct = all(c["ok"] for c in checks) and out.failed == 0
    metrics: dict = {}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics}
    dev = {"platform": "gpu" if ctx.cuda else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.cuda
                    else ctx.device.type),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    if not traced:
        for m in man.end_to_end(cell_name):
            if m["name"] not in out.e2e:
                raise KeyError(f"the driver gave no {m['name']!r}")
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    else:
        obs = out.observation
        for m in man.per_layer(cell_name):
            value = manifest.metric_reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = obs.busy_us() / 1e6
        dev["window_s"] = obs.window_us / 1e6
        result["breakdown"] = trace.breakdown(obs)
    result["device"] = dev
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def now() -> float:
    return time.perf_counter()
