"""Host ms a batch in the wrappers of kernels A and B: the summed
``kernel.forest_traverse`` and ``kernel.fused_gather_topk`` spans' own
time, in the span traced with the host's ops (the program's spans,
``repro_torch/tracing.py``), over the ``index.search`` spans it holds."""
from bench.metrics.api_host_ms import own_us

KERNELS = ("kernel.forest_traverse", "kernel.fused_gather_topk")


def read(obs):
    if obs.kind != "search" or not obs.gaps:
        return None
    host = obs.gaps[2]
    batches = sum(op[0] == "index.search" for op in host)
    spans = [op for op in host if op[0] in KERNELS]
    if not batches or not spans:
        return None
    return own_us(spans, host) / batches / 1e3
