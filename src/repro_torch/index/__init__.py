"""The index API: ``build_index``, ``Index`` (search and the mutable
lifecycle), ``load_index``, ``SearchParams`` and the capability matrix."""
from repro_torch.index.api import (Index, SegmentDraws, available_backends,
                                   build_index, get_backend, load_index)
from repro_torch.index.params import (CAPABILITY_MATRIX, CONTEXTS,
                                      CapabilityError, IndexSpec,
                                      SearchParams, Violation,
                                      capability_table_md)
from repro_torch.index.segments import IndexView

__all__ = ["CAPABILITY_MATRIX", "CONTEXTS", "CapabilityError", "Index",
           "IndexSpec", "IndexView", "SearchParams", "SegmentDraws",
           "Violation", "available_backends", "build_index",
           "capability_table_md", "get_backend", "load_index"]
