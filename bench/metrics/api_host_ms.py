"""Host ms a batch inside the index API: the ``index.search`` spans' own
time less the ``pipeline.query`` spans inside them, in the span traced
with the host's ops (the program's spans, ``repro_torch/tracing.py``),
over the ``index.search`` spans it holds."""
from bench.trace import merged

# The profiler's own host ops: a stall while it asks for or flushes its
# trace buffers, which lands inside whatever span is open at the time.
PROFILER = ("Activity Buffer Request", "Buffer Flush")


def self_us(spans, children) -> float:
    """The spans' summed duration less the union of the children's
    intervals inside them."""
    inside = [(n, max(s, a), min(e, b)) for _, a, b in spans
              for n, s, e in children if s < b and e > a]
    return (sum(b - a for _, a, b in spans)
            - sum(b - a for a, b in merged(inside)))


def own_us(spans, host, children=()) -> float:
    """``self_us`` with the profiler's own host ops (``PROFILER``) among
    the children, so that no layer's time carries the profiler's stall."""
    return self_us(spans, [op for op in host
                           if op[0] in PROFILER or op[0] in children])


def read(obs):
    if obs.kind != "search" or not obs.gaps:
        return None
    host = obs.gaps[2]
    spans = [op for op in host if op[0] == "index.search"]
    if not spans:
        return None
    return own_us(spans, host, ("pipeline.query",)) / len(spans) / 1e3
