"""The index API: ``build_index``, ``Index`` (search and the mutable
lifecycle), ``load_index``, ``SearchParams``, the capability matrix,
``tune`` and ``tune_sharded``."""
from repro_torch.index.api import (Index, SegmentDraws, available_backends,
                                   build_index, get_backend, load_index)
from repro_torch.index.params import (CAPABILITY_MATRIX, CONTEXTS,
                                      CapabilityError, IndexSpec,
                                      SearchParams, Violation,
                                      capability_table_md)
from repro_torch.index.segments import IndexView
from repro_torch.index.tune import tune, tune_report, tune_sharded

__all__ = ["CAPABILITY_MATRIX", "CONTEXTS", "CapabilityError", "Index",
           "IndexSpec", "IndexView", "SearchParams", "SegmentDraws",
           "Violation", "available_backends", "build_index",
           "capability_table_md", "get_backend", "load_index", "tune",
           "tune_report", "tune_sharded"]
