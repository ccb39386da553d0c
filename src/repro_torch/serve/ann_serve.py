"""End-to-end ANN serving: a unified-API index behind a dynamic batcher
(port of ``repro/serve/ann_serve.py``).

This is the paper's system as a service: build any registered backend over a
corpus (IndexSpec), then serve batched k-NN queries through the fused
single-pass pipeline (core/pipeline.py).  Batches are PADDED to ``max_batch``
by repeating their last query, as the reference pads them, so a
batch-coupled path (the adaptive-wave stop rule is a batch mean) answers as
the reference's does.

Also provides the recsys retrieval bridge — MIND interest vectors -> RPF
candidate pruning -> exact rerank.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import ForestConfig
from repro_torch.core.service import AnnService
from repro_torch.index import Index, IndexSpec, SearchParams, build_index
from repro_torch.kernels import build
from repro_torch.serve.batching import DynamicBatcher


def make_ann_server(db: np.ndarray, spec: IndexSpec | ForestConfig,
                    k: int = 10, metric: str = "l2", max_batch: int = 128,
                    max_wait_s: float = 0.002, mode: str = "auto",
                    params: SearchParams | None = None,
                    index: Index | None = None,
                    device: str | torch.device | None = None,
                    generator: torch.Generator | None = None, draws=None
                    ) -> tuple[Index, DynamicBatcher]:
    """Returns (index, batcher). Submit 1-D query vectors; get (d, ids).

    ``spec`` selects the backend (a bare ForestConfig is accepted as
    shorthand for the rpf backend); ``params`` carries the per-query knobs
    (k/metric/mode arguments are the legacy shorthand for the common ones).
    Pass a prebuilt ``index`` to serve an existing (possibly mutated)
    index instead of building a fresh one from ``db`` on ``device`` (the
    GPU unless ``device="cpu"``), drawing from ``generator`` or ``draws``
    (``build_index``'s).  On the GPU the kernel libraries are built before
    the batcher starts, so no request waits on nvcc inside the worker.

    The served index is fully mutable while serving: ``index.add`` /
    ``delete`` / ``upsert`` publish new immutable views that in-flight
    batches pick up on their next search, and ``index.compact(block=False)``
    rebuilds in the background without stalling the batcher threads
    (searches read published views, never the writer lock — DESIGN.md §8).
    """
    if isinstance(spec, ForestConfig):
        spec = IndexSpec(backend="rpf", forest=spec)
    if params is None:
        params = SearchParams(k=k, metric=metric, mode=mode)
    if index is None:
        index = build_index(db, spec, device=device, generator=generator,
                            draws=draws)
    if index.device.type == "cuda":
        build.build_all()

    def serve_batch(payloads: list) -> list:
        # fixed batch shape: pad to max_batch, slice results.  Pad rows
        # REPEAT the last real query (not zeros): batch-coupled paths (the
        # adaptive-wave stop criterion is a batch mean; the lsh cascade
        # probes per row) must not be skewed by synthetic points.
        n = len(payloads)
        q = np.stack(payloads)
        q = np.concatenate(
            [q, np.repeat(q[-1:], max_batch - n, axis=0)]) if n < max_batch \
            else q
        dists, ids = index.search(q, params)
        dists, ids = dists.cpu().numpy(), ids.cpu().numpy()
        return [(dists[j], ids[j]) for j in range(n)]

    batcher = DynamicBatcher(serve_batch, max_batch=max_batch,
                             max_wait_s=max_wait_s).start()
    return index, batcher


def retrieval_via_index(service: "AnnService | Index", interests: np.ndarray,
                        k: int = 100) -> tuple[np.ndarray, np.ndarray]:
    """Multi-interest retrieval (MIND): query the index once per interest,
    merge by max-score (= min inner-product distance)."""
    b, n_int, d = interests.shape
    flat = interests.reshape(b * n_int, d)
    if isinstance(service, Index):
        dists, ids = (t.cpu().numpy() for t in service.search(
            flat, SearchParams(k=k)))
    else:
        dists, ids = service.query(flat, k=k)
    dists = dists.reshape(b, n_int * k)
    ids = ids.reshape(b, n_int * k)
    order = np.argsort(dists, axis=1)[:, :k]
    return (np.take_along_axis(dists, order, axis=1),
            np.take_along_axis(ids, order, axis=1))
