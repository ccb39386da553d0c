"""The index API: ``build_index``, ``Index.search``, ``SearchParams``."""
from repro_torch.index.api import Index, build_index, get_backend
from repro_torch.index.params import IndexSpec, SearchParams

__all__ = ["Index", "IndexSpec", "SearchParams", "build_index", "get_backend"]
