"""Filtered search: metadata columns and predicate ASTs on the validity path
(port of ``repro/filter``, numpy only).

    from repro_torch.filter import And, Eq, Range

    index = build_index(db, spec, metadata={"tenant": tenants,
                                            "ts": timestamps})
    d, i = index.search(q, SearchParams(k=10, filter=And(
        Eq("tenant", "acme"), Range("ts", lo=t0))))

Predicates compile to per-segment bitmaps that ride the kernels' ``valid``
path, as tombstones do, on every backend, with selectivity-aware widening.
"""
from repro_torch.filter.metadata import KINDS, MetaBlock, MetadataStore
from repro_torch.filter.predicate import (And, Eq, In, Not, Or, Predicate,
                                          Range, from_dict, widen_params)

__all__ = ["KINDS", "MetaBlock", "MetadataStore", "Predicate", "Eq", "In",
           "Range", "And", "Or", "Not", "from_dict", "widen_params"]
