"""Columnar per-row metadata: the store (schema + vocab) and per-segment
blocks (port of ``repro/filter/metadata.py``, numpy only, kept as the
reference's).

Attributes ride the index with the same lifecycle as the tombstone bitmap:
every sealed segment carries one immutable ``MetaBlock``
— a dict of column arrays aligned with the segment's rows — and the delta
buffer grows the same columns row-by-row.  Blocks are shared, not copied,
by ``SealedSegment.with_tombstones`` (metadata never changes after seal;
only liveness does), survive ``flush()``/``compact()`` by plain gather/
concat of the column arrays, and land in the manifest (format 5) as
ordinary checkpoint leaves.

Column kinds and their storage:

  int          int64 as given
  timestamp    int64 nanoseconds (``datetime64`` input converted)
  categorical  int32 codes into an APPEND-ONLY per-column vocabulary kept
               by the ``MetadataStore`` (interned on ingest, persisted in
               the manifest JSON)

The append-only vocab is what makes the per-block predicate-bitmap cache
sound: a sealed block's codes never change, and a query value the vocab
has not seen encodes to -1 (matches nothing) — if that value is added
later it is interned for the NEW rows only, so a cached all-False bitmap
for an old block stays correct forever.
"""
from __future__ import annotations

import threading
from typing import Any, Mapping

import numpy as np

__all__ = ["KINDS", "MetadataStore", "MetaBlock"]

KINDS = ("int", "categorical", "timestamp")

_DTYPES = {"int": np.int64, "timestamp": np.int64, "categorical": np.int32}


def _infer_kind(values: np.ndarray) -> str:
    if np.issubdtype(values.dtype, np.datetime64):
        return "timestamp"
    if np.issubdtype(values.dtype, np.integer):
        return "int"
    return "categorical"


class MetadataStore:
    """Schema + categorical vocabulary of one index's metadata columns.

    The store is the only mutable piece of the metadata subsystem, and its
    only mutation is append-only vocab growth (under a lock: ``add``
    interns from mutator threads).  Everything row-shaped lives in
    immutable ``MetaBlock``s / the delta buffer's columns.
    """

    def __init__(self, columns: Mapping[str, str],
                 vocab: Mapping[str, list] | None = None):
        for name, kind in columns.items():
            if kind not in KINDS:
                raise ValueError(f"column {name!r}: unknown kind {kind!r} "
                                 f"(known: {KINDS})")
        self.columns: dict[str, str] = dict(columns)
        self._lock = threading.Lock()
        self._vocab: dict[str, list] = {
            name: list((vocab or {}).get(name, ()))
            for name, kind in self.columns.items() if kind == "categorical"}
        self._code: dict[str, dict] = {
            name: {v: i for i, v in enumerate(vals)}
            for name, vals in self._vocab.items()}

    # -------------------------------------------------------------- schema
    def kind(self, name: str) -> str:
        if name not in self.columns:
            raise KeyError(f"unknown metadata column {name!r} "
                           f"(schema: {sorted(self.columns)})")
        return self.columns[name]

    def dtype(self, name: str):
        return _DTYPES[self.kind(name)]

    # ------------------------------------------------------------ encoding
    def encode_rows(self, name: str, values) -> np.ndarray:
        """Column values -> stored codes, interning new categoricals."""
        kind = self.kind(name)
        if kind == "categorical":
            vals = np.asarray(values, object).reshape(-1)
            with self._lock:
                code = self._code[name]
                out = np.empty(vals.shape[0], np.int32)
                for i, v in enumerate(vals):
                    if isinstance(v, np.generic):
                        v = v.item()
                    c = code.get(v)
                    if c is None:
                        c = len(self._vocab[name])
                        self._vocab[name].append(v)
                        code[v] = c
                    out[i] = c
            return out
        arr = np.asarray(values)
        if np.issubdtype(arr.dtype, np.datetime64):
            arr = arr.astype("datetime64[ns]").astype(np.int64)
        return np.asarray(arr, np.int64).reshape(-1)

    def encode_row(self, name: str, value) -> int:
        """One row's value -> its stored code (interning; the add path)."""
        return int(self.encode_rows(name, [value])[0])

    def encode_value(self, name: str, value) -> int:
        """A QUERY value -> code; never interns.  Unseen categorical -> -1
        (matches no stored code, which is the correct empty match)."""
        kind = self.kind(name)
        if kind == "categorical":
            if isinstance(value, np.generic):
                value = value.item()
            return self._code[name].get(value, -1)
        if isinstance(value, np.datetime64):
            return int(value.astype("datetime64[ns]").astype(np.int64))
        return int(value)

    # -------------------------------------------------------------- ingest
    @classmethod
    def from_arrays(cls, metadata: Mapping[str, Any], n_rows: int,
                    schema: Mapping[str, str] | None = None
                    ) -> tuple["MetadataStore", "MetaBlock"]:
        """Build a store + the first block from build-time column arrays.

        ``schema`` (optional) pins column kinds; otherwise they are
        inferred (datetime64 -> timestamp, integer -> int, anything else
        -> categorical).  Every column must cover all ``n_rows``.
        """
        columns = {}
        arrays = {name: np.asarray(vals) if not isinstance(vals, np.ndarray)
                  else vals for name, vals in metadata.items()}
        for name, vals in arrays.items():
            kind = (schema or {}).get(name) or _infer_kind(
                vals if vals.dtype != object else np.asarray([0]))
            if vals.dtype == object and (schema or {}).get(name) is None:
                kind = "categorical"
            columns[name] = kind
        store = cls(columns)
        return store, store.make_block(arrays, n_rows)

    def make_block(self, metadata: Mapping[str, Any], n_rows: int
                   ) -> "MetaBlock":
        """Encode full-length column arrays into a block (build/seal path)."""
        missing = set(self.columns) - set(metadata)
        extra = set(metadata) - set(self.columns)
        if missing or extra:
            raise ValueError(
                f"metadata columns must match the schema exactly: "
                f"missing {sorted(missing)}, unknown {sorted(extra)}")
        cols = {}
        for name in self.columns:
            codes = self.encode_rows(name, metadata[name])
            if codes.shape[0] != n_rows:
                raise ValueError(f"column {name!r} has {codes.shape[0]} "
                                 f"values for {n_rows} rows")
            cols[name] = codes
        return MetaBlock(cols)

    def encode_point(self, metadata: Mapping[str, Any] | None
                     ) -> dict[str, int]:
        """One point's metadata dict -> {column: code} (the add path).

        Metadata-carrying indexes require every column on every add —
        predicates are total (no null semantics to reason about)."""
        metadata = metadata or {}
        missing = set(self.columns) - set(metadata)
        extra = set(metadata) - set(self.columns)
        if missing or extra:
            raise ValueError(
                f"point metadata must cover the schema exactly: "
                f"missing {sorted(missing)}, unknown {sorted(extra)}")
        return {name: self.encode_row(name, metadata[name])
                for name in self.columns}

    # ----------------------------------------------------------- manifest
    def to_json(self) -> dict:
        with self._lock:
            return {"columns": dict(self.columns),
                    "vocab": {k: list(v) for k, v in self._vocab.items()}}

    @classmethod
    def from_json(cls, d: dict) -> "MetadataStore":
        return cls(d["columns"], d.get("vocab") or {})


class MetaBlock:
    """Immutable columnar metadata of one sealed segment + bitmap cache.

    The cache maps a predicate (hashable AST node) to its (n_rows,) match
    bitmap over THIS block's rows.  Blocks are shared across
    ``with_tombstones`` copies of a segment — metadata is liveness-
    independent — so the cache warms once per (segment, predicate)
    regardless of how often the segment's tombstone bitmap is reissued.
    """

    __slots__ = ("cols", "n_rows", "_cache", "_cache_lock")

    def __init__(self, cols: dict[str, np.ndarray]):
        self.cols = {name: np.ascontiguousarray(arr)
                     for name, arr in cols.items()}
        sizes = {arr.shape[0] for arr in self.cols.values()}
        if len(sizes) > 1:
            raise ValueError(f"ragged metadata columns: {sizes}")
        self.n_rows = sizes.pop() if sizes else 0
        self._cache: dict = {}
        self._cache_lock = threading.Lock()

    def column(self, name: str) -> np.ndarray:
        if name not in self.cols:
            raise KeyError(f"unknown metadata column {name!r} "
                           f"(have: {sorted(self.cols)})")
        return self.cols[name]

    def match(self, predicate, store: MetadataStore) -> np.ndarray:
        """Cached (n_rows,) bool match bitmap for ``predicate``."""
        with self._cache_lock:
            hit = self._cache.get(predicate)
        if hit is not None:
            return hit
        out = predicate.evaluate(self, store)
        out = np.ascontiguousarray(np.asarray(out, bool))
        with self._cache_lock:
            self._cache[predicate] = out
        return out

    def take(self, idx: np.ndarray) -> "MetaBlock":
        """Gather rows into a fresh block (the compaction path)."""
        return MetaBlock({name: arr[idx] for name, arr in self.cols.items()})

    @staticmethod
    def concat(parts: list["MetaBlock"]) -> "MetaBlock":
        """Stitch gathered parts back into one block (compaction/seal)."""
        if not parts:
            return MetaBlock({})
        names = parts[0].cols.keys()
        return MetaBlock({name: np.concatenate([p.cols[name] for p in parts])
                          for name in names})
