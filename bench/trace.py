"""The traced window: ``torch.profiler`` over a span of the timed loop,
reduced to what the per-layer metrics read.

The metrics read a span traced on the device alone; a second, shorter
span also records the host's ops, for the breakdown's idle gaps only.
There the harness marks its own host spans with names that start with
``bench.``: ``bench.window`` around the whole span (its host interval is
that window), ``bench.search`` / ``bench.copy`` / ``bench.wait`` /
``bench.build`` around its calls.  Device operations are the profiler's
CUDA events other than those spans' device mirrors; kernels are the device
operations other than copies and fills (``Memcpy`` / ``Memset``).
"""
from __future__ import annotations

import contextlib
import dataclasses

WINDOW = "bench.window"


@dataclasses.dataclass
class Observation:
    """What a traced window saw, in microseconds on the profiler's clock."""

    kind: str                       # "search" or "build"
    units: int                      # batches or builds in the window
    window: tuple[float, float]
    device_ops: list               # (name, start, end), clipped to window
    # a second traced span with the host's ops: (window, device ops,
    # host ops), read only for the breakdown's idle gaps
    gaps: tuple | None = None
    host: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def kernels(self) -> list:
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]

    def busy_us(self, ops=None) -> float:
        """Length of the union of the ops' intervals."""
        return sum(b - a for a, b in merged(ops if ops is not None
                                            else self.device_ops))

    def kernel_us(self, pattern: str) -> float:
        """Summed durations of the kernels whose name holds ``pattern``."""
        return sum(e - s for n, s, e in self.kernels if pattern in n)


def merged(ops) -> list[tuple[float, float]]:
    """The union of the ops' (start, end) intervals, in order."""
    out: list[list[float]] = []
    for _, s, e in sorted(ops, key=lambda op: op[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(a, b) for a, b in out]


def span(name: str, on: bool):
    """A host span for the profiler, or nothing when not tracing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def profile(fn, host: bool = False):
    """Run ``fn()`` under the profiler; (fn's result, window, device ops,
    host ops) with the ops as (name, start_us, end_us).

    Without ``host`` only the device is traced, which costs the host least:
    the window runs from the first device operation's start to the last
    one's end, and no host ops are returned.  With ``host`` the host's ops
    are recorded too (each costs the host some microseconds, so the device
    idles longer than untraced) and the window is the ``bench.window``
    span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    activities = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                  else [])
    if host or not activities:        # the CPU tests: nothing on a device
        activities.append(ProfilerActivity.CPU)
    with _profile(activities=activities) as prof:
        with span(WINDOW, host):
            out = fn()
    device, hosts, window = [], [], None
    for ev in prof.events():
        tr = ev.time_range
        item = (ev.name, float(tr.start), float(tr.end))
        if ev.device_type == DeviceType.CUDA:
            if not ev.name.startswith("bench."):
                device.append(item)
        elif ev.name == WINDOW:
            window = (item[1], item[2])
        else:
            hosts.append(item)
    if not host:
        window = (min((s for _, s, _ in device), default=0.0),
                  max((e for _, _, e in device), default=0.0))
        return out, window, device, []
    if window is None:
        raise RuntimeError("the profiler recorded no bench.window span")
    a, b = window
    device = [(n, max(s, a), min(e, b)) for n, s, e in device
              if e > a and s < b]
    hosts = [op for op in hosts if op[2] > a and op[1] < b]
    return out, window, device, hosts


def breakdown(obs: Observation, top: int = 10) -> dict:
    """The device operations that took most time (seconds summed by name)
    and, from the span traced with the host (``obs.gaps``), the idle gaps
    summed by what the host was doing: the innermost host op over each
    gap's middle, under the harness span around it."""
    by_op: dict[str, float] = {}
    for name, s, e in obs.device_ops:
        by_op[name[:200]] = by_op.get(name[:200], 0.0) + (e - s) / 1e6
    window, device_ops, host_ops = obs.gaps or (obs.window, [], [])
    gaps, prev = [], window[0]
    for a, b in merged(device_ops) + [(window[1], window[1])]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    by_host: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        over = [op for op in host_ops if op[1] <= mid <= op[2]]
        inner = min(over, key=lambda op: op[2] - op[1], default=None)
        outer = [op for op in over if op[0].startswith("bench.")]
        label = (min(outer, key=lambda op: op[2] - op[1])[0] if outer
                 else "host")
        if inner is not None and inner[0] != label:
            label = f"{label} > {inner[0]}"
        by_host[label[:200]] = by_host.get(label[:200], 0.0) + (b - a) / 1e6
    return {"device_ops": [[k, v] for k, v in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                by_host.items(), key=lambda kv: -kv[1])[:top]]}
