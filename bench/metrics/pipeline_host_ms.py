"""Host ms a batch inside the search pipeline: the ``pipeline.query``
spans' own time less the kernel spans (``kernel.forest_traverse``,
``kernel.fused_gather_topk``) inside them, in the span traced with the
host's ops (the program's spans, ``repro_torch/tracing.py``), over the
``index.search`` spans it holds."""
from bench.metrics.api_host_ms import own_us
from bench.metrics.kernel_host_ms import KERNELS


def read(obs):
    if obs.kind != "search" or not obs.gaps:
        return None
    host = obs.gaps[2]
    batches = sum(op[0] == "index.search" for op in host)
    spans = [op for op in host if op[0] == "pipeline.query"]
    if not batches or not spans:
        return None
    return own_us(spans, host, KERNELS) / batches / 1e3
