"""PyTorch/CUDA port of the random-partition-forest ANN system (Zhong 2015).

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core/``, ``kernels/``, ``index/``, ``filter/``, ``serve/``,
``launch/``, ``data/``, ``configs/``) and never imports it or JAX.  The
paper's query path -- forest descent, candidate union, exact rerank -- runs
on hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch version beside it.

Entry points (``build_index``, ``build_forest``, ``fused_query``,
``core.sharded_index.Mesh`` and ``ShardedIndex`` -- the index split over a
mesh of (DB shard, tree shard) cells, in one process or over a
``torch.distributed`` group -- ``serve.ServingRuntime.load``, ``python -m
repro_torch.launch.serve``) run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
