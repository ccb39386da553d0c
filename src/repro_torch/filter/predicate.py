"""Structured predicate AST compiled to per-segment validity bitmaps (port
of ``repro/filter/predicate.py``, numpy only, kept as the reference's).

A metadata predicate masks more rows for one query, the way tombstones do:
the AST is evaluated on the host against a segment's columnar metadata
(``repro_torch.filter.metadata``) into an (n_rows,) bool bitmap, ANDed with
the segment's ``live`` bitmap, and handed to the ``valid=`` path every
backend already serves.  A masked row's slot becomes id -1 before the
kernel, moves no bytes and scores +inf; no kernel learns about predicates.

The AST is small and closed: ``Eq`` / ``In`` / ``Range`` leaves over one
column, ``And`` / ``Or`` / ``Not`` combinators.  Nodes are frozen
(hashable), so a predicate rides the frozen ``SearchParams`` and keys the
per-segment bitmap caches; ``to_dict`` / ``from_dict`` give the tagged
JSON form, the same in both packages, so a predicate written by either
rebuilds in the other.

Selectivity-aware widening lives here too (:func:`widen_params`): a filter
that keeps a fraction ``s`` of the live rows leaves ~s of each candidate
set, so ``n_probes`` / ``min_candidates`` widen like 1/s, and below
:data:`BRUTE_FORCE_SELECTIVITY` (or at most :data:`BRUTE_FORCE_MAX_ROWS`
matching rows) the search skips the index and scans the matching rows
exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

__all__ = ["Predicate", "Eq", "In", "Range", "And", "Or", "Not",
           "from_dict", "widen_params",
           "BRUTE_FORCE_SELECTIVITY", "BRUTE_FORCE_MAX_ROWS", "MAX_PROBES"]

# below this match fraction (or below this many matching rows) the filtered
# query exact-scans the matching rows instead of widening the index probe —
# guaranteed recall, and cost proportional to the matches, not the corpus
BRUTE_FORCE_SELECTIVITY = 0.05
BRUTE_FORCE_MAX_ROWS = 4096

# widening never pushes the per-tree probe count past this (leaf sets start
# overlapping heavily long before; past it, brute force over matches wins)
MAX_PROBES = 16


class Predicate:
    """Base class: evaluation + JSON tagging shared by every node."""

    def evaluate(self, block, store) -> np.ndarray:
        """(n_rows,) bool match bitmap over ``block``'s rows.

        ``block`` is a ``repro_torch.filter.metadata.MetaBlock`` (columnar codes),
        ``store`` the index's ``MetadataStore`` (schema + categorical
        vocab).  Unknown columns raise; a categorical value the vocab has
        never seen matches nothing (correct under the store's append-only
        interning: codes of existing rows never change).
        """
        raise NotImplementedError

    def columns(self) -> frozenset[str]:
        raise NotImplementedError

    def to_dict(self) -> dict[str, Any]:
        raise NotImplementedError


def _scalar(value) -> Any:
    """Normalize a leaf comparison value to a hashable python scalar."""
    if isinstance(value, (np.generic,)):
        return value.item()
    if isinstance(value, np.datetime64):
        return int(value.astype("datetime64[ns]").astype(np.int64))
    return value


@dataclasses.dataclass(frozen=True)
class Eq(Predicate):
    """column == value (any column kind)."""

    column: str
    value: Any

    def __post_init__(self):
        object.__setattr__(self, "value", _scalar(self.value))

    def evaluate(self, block, store) -> np.ndarray:
        codes = block.column(self.column)
        return codes == store.encode_value(self.column, self.value)

    def columns(self) -> frozenset[str]:
        return frozenset((self.column,))

    def to_dict(self) -> dict[str, Any]:
        return {"op": "eq", "column": self.column, "value": self.value}


@dataclasses.dataclass(frozen=True)
class In(Predicate):
    """column ∈ values (any column kind)."""

    column: str
    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values",
                           tuple(_scalar(v) for v in self.values))

    def evaluate(self, block, store) -> np.ndarray:
        codes = block.column(self.column)
        wanted = np.asarray(sorted({store.encode_value(self.column, v)
                                    for v in self.values}), codes.dtype)
        return np.isin(codes, wanted)

    def columns(self) -> frozenset[str]:
        return frozenset((self.column,))

    def to_dict(self) -> dict[str, Any]:
        return {"op": "in", "column": self.column,
                "values": list(self.values)}


@dataclasses.dataclass(frozen=True)
class Range(Predicate):
    """lo <= column <= hi over an ordered (int/timestamp) column.

    ``None`` bounds are open; categorical columns reject (codes are
    interning order, not value order).
    """

    column: str
    lo: Any = None
    hi: Any = None

    def __post_init__(self):
        if self.lo is None and self.hi is None:
            raise ValueError("Range needs at least one bound "
                             "(lo=None, hi=None matches everything)")
        object.__setattr__(self, "lo", _scalar(self.lo))
        object.__setattr__(self, "hi", _scalar(self.hi))

    def evaluate(self, block, store) -> np.ndarray:
        if store.kind(self.column) == "categorical":
            raise ValueError(f"Range over categorical column "
                             f"{self.column!r} is not ordered")
        vals = block.column(self.column)
        out = np.ones(vals.shape[0], bool)
        if self.lo is not None:
            out &= vals >= store.encode_value(self.column, self.lo)
        if self.hi is not None:
            out &= vals <= store.encode_value(self.column, self.hi)
        return out

    def columns(self) -> frozenset[str]:
        return frozenset((self.column,))

    def to_dict(self) -> dict[str, Any]:
        return {"op": "range", "column": self.column, "lo": self.lo,
                "hi": self.hi}


def _children(ps) -> tuple:
    ps = tuple(ps)
    if not ps or not all(isinstance(p, Predicate) for p in ps):
        raise TypeError("combinator children must be a non-empty sequence "
                        "of Predicate nodes")
    return ps


@dataclasses.dataclass(frozen=True)
class And(Predicate):
    children: tuple

    def __init__(self, *children):
        object.__setattr__(self, "children", _children(children))

    def evaluate(self, block, store) -> np.ndarray:
        out = self.children[0].evaluate(block, store)
        for child in self.children[1:]:
            out = out & child.evaluate(block, store)
        return out

    def columns(self) -> frozenset[str]:
        return frozenset().union(*(c.columns() for c in self.children))

    def to_dict(self) -> dict[str, Any]:
        return {"op": "and", "children": [c.to_dict()
                                          for c in self.children]}


@dataclasses.dataclass(frozen=True)
class Or(Predicate):
    children: tuple

    def __init__(self, *children):
        object.__setattr__(self, "children", _children(children))

    def evaluate(self, block, store) -> np.ndarray:
        out = self.children[0].evaluate(block, store)
        for child in self.children[1:]:
            out = out | child.evaluate(block, store)
        return out

    def columns(self) -> frozenset[str]:
        return frozenset().union(*(c.columns() for c in self.children))

    def to_dict(self) -> dict[str, Any]:
        return {"op": "or", "children": [c.to_dict() for c in self.children]}


@dataclasses.dataclass(frozen=True)
class Not(Predicate):
    child: Predicate

    def __post_init__(self):
        if not isinstance(self.child, Predicate):
            raise TypeError("Not() wraps a Predicate node")

    def evaluate(self, block, store) -> np.ndarray:
        return ~self.child.evaluate(block, store)

    def columns(self) -> frozenset[str]:
        return self.child.columns()

    def to_dict(self) -> dict[str, Any]:
        return {"op": "not", "child": self.child.to_dict()}


_OPS = {"eq": Eq, "in": In, "range": Range, "and": And, "or": Or, "not": Not}


def from_dict(d: dict[str, Any]) -> Predicate:
    """Inverse of ``Predicate.to_dict`` (tagged JSON -> AST)."""
    op = d.get("op")
    if op == "eq":
        return Eq(d["column"], d["value"])
    if op == "in":
        return In(d["column"], tuple(d["values"]))
    if op == "range":
        return Range(d["column"], d.get("lo"), d.get("hi"))
    if op == "and":
        return And(*(from_dict(c) for c in d["children"]))
    if op == "or":
        return Or(*(from_dict(c) for c in d["children"]))
    if op == "not":
        return Not(from_dict(d["child"]))
    raise ValueError(f"unknown predicate op {op!r} "
                     f"(known: {sorted(_OPS)})")


# ---------------------------------------------------------------------------
# selectivity-aware widening
# ---------------------------------------------------------------------------


def use_brute_force(selectivity: float, n_match: int) -> bool:
    """Should a filter this selective skip the index and exact-scan the
    matching rows?  (The scan rides the same fused kernel with every
    non-match masked to id -1 — no DMA — so its cost is ~n_match rows.)"""
    return (selectivity <= BRUTE_FORCE_SELECTIVITY
            or n_match <= BRUTE_FORCE_MAX_ROWS)


def widen_params(params, selectivity: float):
    """Scale the candidate budget so recall-under-filter holds.

    With a match fraction ``s``, a candidate set of size C holds ~s*C
    matching rows — the index must surface ~1/s more candidates to keep
    the effective shortlist at its unfiltered size.  Forest backends widen
    ``n_probes`` by 1/sqrt(s) (probes overlap, so full 1/s overshoots) and
    drop any search-time tree restriction; the lsh cascade raises its stop
    threshold to the caller's budget scaled by 1/s (floored at ~2k/s, so a
    tiny caller budget still surfaces enough matches).  Returns a new
    ``SearchParams`` (the original is frozen); no-op at s >= 1.
    """
    if selectivity >= 1.0:
        return params
    s = max(float(selectivity), 1e-6)
    n_probes = min(MAX_PROBES,
                   int(math.ceil(params.n_probes / math.sqrt(s))))
    min_candidates = max(int(math.ceil(params.min_candidates / s)),
                         int(math.ceil(2.0 * params.k / s)))
    return dataclasses.replace(params, n_probes=n_probes,
                               min_candidates=min_candidates, n_trees=0)
