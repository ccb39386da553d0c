"""Device idle ms a build that the level loop's host syncs cause: the idle
gaps of the span traced with the host's ops (the complement of the union of
its device operations, as ``trace.breakdown`` finds them) that begin while
the host is inside a ``build.sync`` span (the program's spans,
``repro_torch/tracing.py``) and not inside one of the profiler's own host
ops, over its ``build.forest`` spans."""
import bisect

from bench.metrics.api_host_ms import PROFILER
from bench.trace import merged


def _inside(t, spans, starts) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans[i][1]


def read(obs):
    if obs.kind != "build" or not obs.gaps:
        return None
    window, device_ops, host = obs.gaps
    builds = sum(op[0] == "build.forest" for op in host)
    syncs = merged([op for op in host if op[0] == "build.sync"])
    if not builds or not syncs:
        return None
    stalls = merged([op for op in host if op[0] in PROFILER])
    gaps, prev = [], window[0]
    for a, b in merged(device_ops) + [(window[1], window[1])]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    sync_starts = [s for s, _ in syncs]
    stall_starts = [s for s, _ in stalls]
    idle = sum(b - a for a, b in gaps
               if _inside(a, syncs, sync_starts)
               and not _inside(a, stalls, stall_starts))
    return idle / builds / 1e3
