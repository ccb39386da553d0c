"""Mode-dispatched entry points to the kernels (port of ``repro/kernels/ops.py``).

Policy (``mode``):
  * "auto"   -- the CUDA kernel for tensors on a CUDA device, the plain
                PyTorch version for tensors on the CPU;
  * "kernel" -- the CUDA kernel; raises for CPU tensors.  "pallas" is
                accepted as its alias, so a reference ``SearchParams``
                carried across stays valid;
  * "ref"    -- the plain version on any device (tests, and the kernels'
                comparisons on the card).
No path falls back from a kernel that fails to build or launch.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import chi2_topk as _chi2
from repro_torch.kernels import distance_topk as _dist
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import forest_traverse as _trav_smem
from repro_torch.kernels import forest_traverse_hbm as _trav
from repro_torch.kernels import fused_query as _fused
from repro_torch.kernels import fused_query_int8 as _fused_i8
from repro_torch.kernels import matmul_topk as _mm
from repro_torch.kernels import ref as _ref

MODES = ("auto", "kernel", "ref")
_ALIASES = {"pallas": "kernel"}


def canonical_mode(mode: str) -> str:
    m = _ALIASES.get(mode, mode)
    if m not in MODES:
        raise ValueError(f"mode must be auto|kernel|ref (or pallas), "
                         f"got {mode!r}")
    return m


def use_kernel(mode: str, t: torch.Tensor) -> bool:
    """Whether ``mode`` sends work on tensor ``t`` to the CUDA kernel."""
    mode = canonical_mode(mode)
    if mode == "ref":
        return False
    if mode == "kernel" and not t.is_cuda:
        raise ValueError("mode='kernel' needs CUDA tensors; use mode='auto' "
                         "or 'ref' on the CPU")
    return t.is_cuda


def topk(q: torch.Tensor, db: torch.Tensor, k: int, metric: str = "l2",
         mode: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force scan + top-k, metric in {l2, dot, chi2}: l2 and
    dot go to kernel D (``matmul_topk``), chi2 to kernel E
    (``chi2_topk``).  Ties to the smaller id; +inf / -1 where k > N."""
    kernel = use_kernel(mode, q)
    if metric == "chi2":
        if kernel:
            return _chi2.chi2_topk(q, db, k)
        return _ref.chi2_topk_ref(q, db, k)
    if kernel:
        return _mm.matmul_topk(q, db, k, metric)
    return _ref.matmul_topk_ref(q, db, k, metric)


def rerank_candidates(q: torch.Tensor, cand: torch.Tensor, ids: torch.Tensor,
                      mask: torch.Tensor, k: int, metric: str = "l2",
                      mode: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Distance + masked top-k over candidate rows the caller gathered:
    cand (B, M, d), ids (B, M) int32, mask (B, M) bool, metric l2 or chi2
    (kernel G, ``distance_topk``).  Ties to the smaller id; +inf / -1
    past the valid slots and where k > M."""
    if use_kernel(mode, q):
        return _dist.distance_topk(q, cand, ids, mask, k, metric)
    return _ref.distance_topk_ref(q, cand, ids, mask, k, metric)


def fused_rerank(q: torch.Tensor, ids: torch.Tensor, db: torch.Tensor, k: int,
                 metric: str = "l2", mode: str = "auto"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused db-row gather + distance + top-k over one candidate chunk;
    ids (B, M) int32 with -1 marking empty slots."""
    with tracing.span("kernel.fused_gather_topk"):
        if use_kernel(mode, q):
            return _fused.fused_gather_topk(q, ids, db, k, metric)
        return _ref.fused_gather_topk_ref(q, ids, db, k, metric)


def fused_scan(q: torch.Tensor, db: torch.Tensor, k: int, metric: str = "l2",
               valid: torch.Tensor | None = None, mode: str = "auto"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused rerank over ids = arange(N) for every query, the exact
    scan of the ``bruteforce`` backend: each pair scores bit for bit what
    ``fused_rerank`` gives it; ``valid`` an optional (N,) bool row mask;
    ties to the smaller id, +inf / -1 past the live rows."""
    if use_kernel(mode, q):
        return _fused.fused_scan(q, db, k, metric, valid)
    return _ref.fused_scan_ref(q, db, k, metric, valid)


def fused_rerank_int8(q: torch.Tensor, ids: torch.Tensor, q8: torch.Tensor,
                      scale: torch.Tensor, k: int, metric: str = "l2",
                      mode: str = "auto"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused int8-row gather + dequantize + distance + top-k over one
    candidate chunk; ids (B, M) int32 with -1 marking empty slots, q8
    (N, d) int8 rows with per-row f32 scales."""
    if use_kernel(mode, q):
        return _fused_i8.fused_gather_topk_int8(q, ids, q8, scale, k, metric)
    return _ref.fused_gather_topk_int8_ref(q, ids, q8, scale, k, metric)


def traverse(feat: torch.Tensor, thresh: torch.Tensor,
             child_base: torch.Tensor, queries: torch.Tensor, max_depth: int,
             n_probes: int = 1, mode: str = "auto") -> torch.Tensor:
    """K = 1 forest descent -> (L, B), or (L, B, n_probes) leaf ids."""
    with tracing.span("kernel.forest_traverse"):
        if use_kernel(mode, queries):
            return _trav.forest_traverse_hbm(feat, thresh, child_base,
                                             queries, max_depth, n_probes)
        return _ref.forest_traverse_ref(feat, thresh, child_base, queries,
                                        max_depth, n_probes)


def embedding_bag(ids: torch.Tensor, weights: torch.Tensor,
                  table: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """Weighted multi-hot bag (B, H) x (V, D) -> (B, D) f32 (kernel H)."""
    if use_kernel(mode, ids):
        return _bag.embedding_bag(ids, weights, table)
    return _ref.embedding_bag_ref(ids, weights, table)


TREE_KERNELS = ("auto", "smem", "hbm")


def traverse_tree(feat: torch.Tensor, thresh: torch.Tensor,
                  child_base: torch.Tensor, queries: torch.Tensor,
                  max_depth: int, mode: str = "auto", n_probes: int = 1,
                  kernel: str = "auto") -> torch.Tensor:
    """Single-tree K = 1 descent -> (B,) leaf ids for ``n_probes == 1``,
    else (B, n_probes) (primary first, then ascending margin, -1 for
    absent probes).

    ``kernel`` picks the CUDA kernel: "smem" copies the tree into shared
    memory (kernel F, up to ``forest_traverse.smem_node_cap`` allocated
    nodes: it raises above the cap), "hbm" reads it from device memory
    (kernel A at L = 1, any size), "auto" takes "smem" when the tree fits
    and "hbm" otherwise.  The two are bitwise equal to each other and to
    the plain version, which ``mode="ref"`` and CPU tensors run.
    """
    if kernel not in TREE_KERNELS:
        raise ValueError(f"kernel must be auto|smem|hbm, got {kernel!r}")
    if not use_kernel(mode, queries):
        return _ref.forest_traverse_tree_ref(feat, thresh, child_base,
                                             queries, max_depth, n_probes)
    if kernel == "auto":
        fits = feat.shape[0] <= _trav_smem.smem_node_cap(queries.device)
        kernel = "smem" if fits else "hbm"
    if kernel == "hbm":
        return _trav.forest_traverse_hbm_tree(feat, thresh, child_base,
                                              queries, max_depth, n_probes)
    return _trav_smem.forest_traverse(feat, thresh, child_base, queries,
                                      max_depth, n_probes)
