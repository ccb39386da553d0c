"""Segmented mutable-index state: sealed segments, the delta buffer, views
(port of ``repro/index/segments.py``).

The mutable index is LSM-shaped:

  * ``SealedSegment`` -- an immutable block of rows with a backend-built
    search engine, a global-id column and a tombstone bitmap.  A delete
    makes a new ``SealedSegment`` sharing the engine, rows and ids with a
    copied ``live`` bitmap, so published views stay frozen.
  * ``DeltaBuffer`` -- the one mutable piece: a capacity-doubling host
    buffer of freshly added rows, scanned exactly through the same fused
    rerank as every sealed backend.  Its device copy is cached per
    (buffer, count): uploaded once after a burst of adds, never re-stacked
    per search, and replaced when the buffer doubles.
  * ``IndexView`` -- an immutable snapshot of (sealed segments, delta
    prefix, tombstones).  ``Index.search`` reads the current view with one
    attribute load (readers never take the writer lock) and
    ``Index.snapshot()`` hands it out for repeatable reads.

Engines answer ``search(q, params, valid=None) -> (dists, local ids)`` and
hold their rows on the device as ``db``.  Every score -- sealed, delta and
brute force -- comes from kernel B's arithmetic (the fused gather or its
query-tiled scan, which scores every pair bit for bit as the gather does),
so a row's distance does not depend on the segment that holds it.  Segment
results map to global ids and merge with the associative top-k, ties to
the earlier part: segments in order, then the delta.

Filtered search rides the same ``valid=`` path: a sealed segment carries
an immutable ``MetaBlock`` of per-row metadata columns (the delta buffer
grows the same columns row by row), a ``SearchParams.filter`` predicate
compiles per segment into a match bitmap (cached on the block), is ANDed
with ``live`` and goes to the card once per (segment, predicate) as a
``torch.bool`` mask, cached on the segment object.  ``IndexView.search``
counts the matches (the exact selectivity) and either scans only the
matching rows (few matches: ``filter.predicate.use_brute_force``) or runs
each segment's engine under ``widen_params``.  No kernel learns about
predicates.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core.search import merge_topk_pairs
from repro_torch.filter import predicate as pred_mod
from repro_torch.filter.metadata import MetaBlock, MetadataStore
from repro_torch.index.params import CapabilityError, SearchParams, Violation
from repro_torch.kernels import ops
from repro_torch.kernels.common import POS_INF

# location tag for rows living in the (unsealed) delta buffer
DELTA_SID = -1

_DELTA_MIN_CAP = 64


def _remap_gids(local_ids: torch.Tensor, gids_dev: torch.Tensor
                ) -> torch.Tensor:
    """Segment-local result ids -> global ids (-1 slots pass through)."""
    safe = local_ids.clamp_min(0).long()
    return torch.where(local_ids >= 0, gids_dev[safe], -1)


def _merge_parts(cat_d: torch.Tensor, cat_i: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, m) parts side by side -> (B, k), ties to the earlier part."""
    return merge_topk_pairs(cat_d, cat_i, k)


def brute_force_topk(q: torch.Tensor, rows: torch.Tensor,
                     params: SearchParams, valid: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact scan through the fused rerank's arithmetic: (B, k) dists + row
    ids.

    The scan is ``ops.fused_scan``: the fused rerank over ids = arange(N)
    for every query (mask = ``valid``, dedup off, +inf / -1 past the live
    rows), so a row scores the same whichever backend holds it.  On the
    card that is kernel B's query-tiled scan, which scores every pair bit
    for bit as the gather kernel does; on the CPU, the gather's plain
    version over arange(N).  ``params.chunk`` does not change the answer
    and is not read.
    """
    return ops.fused_scan(q, rows, params.k, params.metric, valid,
                          params.mode)


class SealedSegment:
    """Immutable sealed segment: engine + global ids + tombstone bitmap, and
    the rows' metadata columns (``meta``, a ``MetaBlock``) on an index that
    has them.

    ``live`` is copy-on-write: ``with_tombstones`` returns a new segment
    sharing the engine, gids (and the gids' cached device copy) and
    metadata with a fresh bitmap, so views published before a delete keep
    the old liveness.
    """

    __slots__ = ("sid", "engine", "gids", "live", "n_dead", "identity_gids",
                 "meta", "_gids_dev_cell", "_live_dev", "_filter_dev")

    def __init__(self, sid: int, engine, gids: np.ndarray,
                 live: np.ndarray | None = None,
                 identity_gids: bool | None = None,
                 meta: MetaBlock | None = None,
                 _gids_dev_cell: list | None = None):
        self.sid = sid
        self.engine = engine
        self.gids = np.ascontiguousarray(np.asarray(gids, np.int32))
        if live is None:
            live = np.ones(self.gids.shape[0], bool)
        self.live = live
        self.n_dead = int(live.size - np.count_nonzero(live))
        if identity_gids is None:
            identity_gids = bool(np.array_equal(
                self.gids, np.arange(self.gids.shape[0], dtype=np.int32)))
        self.identity_gids = identity_gids
        # shared across with_tombstones copies: metadata never changes after
        # the seal, so its predicate bitmaps cache once per segment
        self.meta = meta
        # one-element cell shared across with_tombstones copies
        self._gids_dev_cell = (_gids_dev_cell if _gids_dev_cell is not None
                               else [None])
        self._live_dev = None
        # predicate -> (live match count, device mask, device (rows, gids)
        # of the live matches); per object, since it folds in this object's
        # liveness
        self._filter_dev: dict = {}

    @property
    def n_rows(self) -> int:
        return self.gids.shape[0]

    @property
    def n_live(self) -> int:
        return self.n_rows - self.n_dead

    @property
    def rows(self) -> torch.Tensor:
        """The segment's rows on the device (tombstoned rows included)."""
        return self.engine.db

    @property
    def gids_dev(self) -> torch.Tensor:
        if self._gids_dev_cell[0] is None:
            self._gids_dev_cell[0] = torch.tensor(self.gids,
                                                  device=self.rows.device)
        return self._gids_dev_cell[0]

    @property
    def live_dev(self) -> torch.Tensor:
        if self._live_dev is None:
            self._live_dev = torch.tensor(self.live, device=self.rows.device)
        return self._live_dev

    def with_tombstones(self, rows: np.ndarray) -> "SealedSegment":
        """New segment object with ``rows`` (local indices) marked dead."""
        live = self.live.copy()
        live[rows] = False
        return SealedSegment(self.sid, self.engine, self.gids, live=live,
                             identity_gids=self.identity_gids,
                             meta=self.meta,
                             _gids_dev_cell=self._gids_dev_cell)

    def _filter(self, predicate, store: MetadataStore) -> tuple:
        cached = self._filter_dev.get(predicate)
        if cached is None:
            combined = self.meta.match(predicate, store) & self.live
            n = int(np.count_nonzero(combined))
            dev = self.rows.device
            rows = torch.from_numpy(np.flatnonzero(combined)).to(dev)
            cached = (n, torch.tensor(combined, device=dev) if n else None,
                      (rows, self.gids_dev[rows]))
            self._filter_dev[predicate] = cached
        return cached

    def filter_valid(self, predicate, store: MetadataStore
                     ) -> tuple[int, torch.Tensor | None]:
        """(live match count, device mask ``match & live``, None when
        nothing matches) for ``predicate``: the filter and the tombstones
        in one bitmap for the engines' ``valid=`` path, uploaded once per
        (segment object, predicate)."""
        return self._filter(predicate, store)[:2]

    def filter_rows(self, predicate, store: MetadataStore
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(local rows, global ids) of the live rows matching
        ``predicate``, ascending, on the device; cached as the mask is."""
        return self._filter(predicate, store)[2]

    def search(self, q: torch.Tensor, params: SearchParams,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(dists, GLOBAL ids) over this segment's live rows; ``valid``
        (the filtered path's combined bitmap) overrides the tombstone
        bitmap, which applies when a row is dead."""
        if valid is None:
            valid = self.live_dev if self.n_dead else None
        d, li = self.engine.search(q, params, valid=valid)
        return d, _remap_gids(li, self.gids_dev)


class DeltaBuffer:
    """Growable host buffer of freshly added rows (the LSM memtable).

    Appends go to a capacity-doubling numpy buffer; rows are never edited
    in place (an upsert appends a new row and tombstones the old), so any
    prefix of the buffer is immutable and can be shared with views.  The
    device copy is cached per (buffer object, uploaded count) and uploaded
    synchronously: later appends write rows the copy does not cover, and a
    doubling replaces the buffer object, which invalidates the copy.  On an
    index with metadata the columns (the store's codes) grow with the rows.
    """

    def __init__(self, dim: int, device: torch.device,
                 meta_store: MetadataStore | None = None):
        self.device = device
        self._rows = np.zeros((_DELTA_MIN_CAP, dim), np.float32)
        self._gids = np.full(_DELTA_MIN_CAP, -1, np.int32)
        self._live = np.zeros(_DELTA_MIN_CAP, bool)
        self._meta: dict[str, np.ndarray] | None = None
        if meta_store is not None:
            self._meta = {name: np.zeros(_DELTA_MIN_CAP,
                                         meta_store.dtype(name))
                          for name in meta_store.columns}
        self.count = 0
        self.n_live = 0
        self._dev_lock = threading.Lock()
        self._dev_cache: tuple | None = None   # (buf_obj, count, rows, gids)

    def append(self, x: np.ndarray, gid: int,
               meta: dict[str, int] | None = None) -> int:
        if self.count == self._rows.shape[0]:
            self._rows = np.concatenate([self._rows,
                                         np.zeros_like(self._rows)])
            self._gids = np.concatenate([self._gids,
                                         np.full(self.count, -1, np.int32)])
            self._live = np.concatenate([self._live,
                                         np.zeros(self.count, bool)])
            if self._meta is not None:
                self._meta = {name: np.concatenate([col,
                                                    np.zeros_like(col)])
                              for name, col in self._meta.items()}
        row = self.count
        self._rows[row] = x
        self._gids[row] = gid
        if self._meta is not None:
            for name, col in self._meta.items():
                col[row] = meta[name]
        self._live[row] = True
        self.count = row + 1
        self.n_live += 1
        return row

    def kill(self, row: int) -> None:
        if self._live[row]:
            self._live[row] = False
            self.n_live -= 1

    def live_rows(self) -> tuple[np.ndarray, np.ndarray,
                                 dict[str, np.ndarray] | None]:
        """(rows (m, d), gids (m,), metadata columns or None) of the live
        prefix: the seal payload."""
        idx = np.flatnonzero(self._live[:self.count])
        meta = (None if self._meta is None
                else {name: col[idx].copy()
                      for name, col in self._meta.items()})
        return (np.ascontiguousarray(self._rows[idx]),
                self._gids[idx].copy(), meta)

    def meta_block(self, count: int) -> MetaBlock:
        """The metadata columns of the first ``count`` rows (views)."""
        return MetaBlock({name: col[:count]
                          for name, col in self._meta.items()})

    def view(self) -> "DeltaView | None":
        """Immutable snapshot of the current live prefix (None if empty)."""
        if self.n_live == 0:
            return None
        return DeltaView(self, self.count, self._live[:self.count].copy())

    def device_rows(self, min_count: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Cached device copy of the buffer covering >= min_count rows."""
        with self._dev_lock:
            cache = self._dev_cache
            if (cache is not None and cache[0] is self._rows
                    and cache[1] >= min_count):
                return cache[2], cache[3]
            buf, count = self._rows, self.count
            # torch.tensor copies: the upload is done with the host rows
            # before it returns, whatever later appends write
            rows_dev = torch.tensor(buf, device=self.device)
            gids_dev = torch.tensor(self._gids, device=self.device)
            self._dev_cache = (buf, count, rows_dev, gids_dev)
            return rows_dev, gids_dev


class DeltaView:
    """Frozen (buffer, count, liveness) triple: one snapshot of the delta."""

    __slots__ = ("_buffer", "count", "live", "_arrays", "_filter_cache")

    def __init__(self, buffer: DeltaBuffer, count: int, live: np.ndarray):
        self._buffer = buffer
        self.count = count
        self.live = live
        self._arrays = None
        self._filter_cache: dict = {}

    @property
    def n_live(self) -> int:
        return int(np.count_nonzero(self.live))

    @property
    def gids(self) -> np.ndarray:
        return self._buffer._gids[:self.count]

    @property
    def rows(self) -> np.ndarray:
        return self._buffer._rows[:self.count]

    def _device_arrays(self
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self._arrays is None:
            rows_dev, gids_dev = self._buffer.device_rows(self.count)
            valid = np.zeros(rows_dev.shape[0], bool)
            valid[:self.count] = self.live
            self._arrays = (rows_dev, gids_dev,
                            torch.tensor(valid, device=rows_dev.device))
        return self._arrays

    def match(self, predicate, store: MetadataStore) -> np.ndarray:
        """Host match bits of ``predicate`` over the view's ``count`` rows
        (the buffer's columns; the view is immutable, the next mutation
        publishes a new one)."""
        return self._buffer.meta_block(self.count).match(predicate, store)

    def filter_valid(self, predicate, store: MetadataStore
                     ) -> tuple[int, torch.Tensor | None]:
        """(live match count, device mask over the buffer's capacity, None
        when nothing matches), cached per view: the mask the exact scan
        takes in place of the liveness mask."""
        cached = self._filter_cache.get(predicate)
        if cached is None:
            combined = self.match(predicate, store) & self.live
            n = int(np.count_nonzero(combined))
            dev = None
            if n:
                rows_dev, _, _ = self._device_arrays()
                valid = np.zeros(rows_dev.shape[0], bool)
                valid[:self.count] = combined
                dev = torch.tensor(valid, device=rows_dev.device)
            cached = (n, dev)
            self._filter_cache[predicate] = cached
        return cached

    def search(self, q: torch.Tensor, params: SearchParams,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(dists, GLOBAL ids) over the live delta rows (exact scan);
        ``valid`` (the filtered path's combined bitmap) overrides the
        liveness mask."""
        rows_dev, gids_dev, live_valid = self._device_arrays()
        d, li = brute_force_topk(q, rows_dev, params,
                                 valid=live_valid if valid is None else valid)
        return d, _remap_gids(li, gids_dev)


class IndexView:
    """An immutable snapshot of the whole index: what ``search`` reads.

    ``Index`` publishes a fresh view after every mutation; a view handed
    out by ``Index.snapshot()`` keeps answering from its frozen state while
    the index mutates or compacts.
    """

    __slots__ = ("segments", "delta", "device", "dim", "store")

    def __init__(self, segments: tuple[SealedSegment, ...],
                 delta: DeltaView | None, device: torch.device, dim: int,
                 store: MetadataStore | None = None):
        self.segments = segments
        self.delta = delta
        self.device = device
        self.dim = dim
        # the index's schema and categorical vocab (None: no metadata);
        # the vocab only grows, so a frozen view may share the live store
        self.store = store

    @property
    def n_live(self) -> int:
        n = sum(s.n_live for s in self.segments)
        return n + (self.delta.n_live if self.delta is not None else 0)

    def live_points(self) -> tuple[np.ndarray, np.ndarray]:
        """Canonical (gids, rows) of the live point set, segment order, as
        host arrays: the order ``compact()`` rebuilds in, and the order a
        fresh build of the same points takes."""
        gids, rows = [], []
        for seg in self.segments:
            idx = np.flatnonzero(seg.live)
            gids.append(seg.gids[idx])
            rows.append(seg.rows[torch.from_numpy(idx).to(seg.rows.device)]
                        .cpu().numpy())
        if self.delta is not None:
            idx = np.flatnonzero(self.delta.live)
            gids.append(self.delta.gids[idx])
            rows.append(self.delta.rows[idx])
        if not gids:
            return np.zeros(0, np.int32), np.zeros((0, self.dim), np.float32)
        return np.concatenate(gids), np.concatenate(rows)

    def filter_match_live(self, predicate) -> np.ndarray:
        """Host match bits of ``predicate`` over the live point set, in
        :meth:`live_points` order (from the per-segment cached bitmaps)."""
        if self.store is None:
            raise ValueError(
                "predicate given but this index carries no metadata — "
                "build with build_index(..., metadata={col: values}) to "
                "enable filtered search")
        parts = [seg.meta.match(predicate, self.store)[seg.live]
                 for seg in self.segments if seg.n_live]
        if self.delta is not None:
            parts.append(self.delta.match(predicate, self.store)
                         [self.delta.live])
        return np.concatenate(parts) if parts else np.zeros(0, bool)

    def search(self, queries, params: SearchParams | None = None,
               **params_kw) -> tuple[torch.Tensor, torch.Tensor]:
        """queries (B, d) or (d,) -> (dists (B, k), ids (B, k)) on the
        view's device; invalid slots: +inf / -1.

        A pristine index (one segment, no delta, no tombstones, ids
        0..N-1) goes straight to its engine.  Otherwise the search fans
        out over the sealed segments (tombstones masked inside the fused
        rerank, so they never take a result slot) and the delta's exact
        scan, and merges with the associative top-k.  A filtered search
        takes ``_search_filtered``.
        """
        params = params if params is not None else SearchParams(**params_kw)
        params.require("local")
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        q = torch.atleast_2d(q).contiguous()
        if params.filter is not None:
            return self._search_filtered(q, params)
        segments = self.segments
        if (len(segments) == 1 and self.delta is None
                and segments[0].n_dead == 0 and segments[0].identity_gids):
            return segments[0].engine.search(q, params)
        parts = [seg.search(q, params) for seg in segments if seg.n_live]
        if self.delta is not None:
            parts.append(self.delta.search(q, params))
        return self._merge(q, parts, params.k)

    @staticmethod
    def _merge(q: torch.Tensor, parts: list, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
        if not parts:
            return (q.new_full((q.shape[0], k), POS_INF),
                    torch.full((q.shape[0], k), -1, dtype=torch.int32,
                               device=q.device))
        if len(parts) == 1:
            return parts[0]
        return _merge_parts(torch.cat([p[0] for p in parts], dim=1),
                            torch.cat([p[1] for p in parts], dim=1), k)

    def _search_filtered(self, q: torch.Tensor, params: SearchParams
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """The predicate-filtered fan-out.

        Each segment's match bitmap, ANDed with its tombstones, is the
        ``valid`` mask of its search; the match counts give the filter's
        exact selectivity over the live rows.  At most
        ``BRUTE_FORCE_MAX_ROWS`` matches, or a selectivity at most
        ``BRUTE_FORCE_SELECTIVITY``, scans the matching rows exactly;
        otherwise each segment's engine runs under ``widen_params``, so
        ~1/s fewer surviving candidates still fill k slots.  The delta is
        scanned with the caller's params.

        The brute regime gathers each segment's matching rows and scans
        only those: kernel B's scan loads no dead row but still scores it,
        so a masked scan would cost the whole segment.  A pair scores the
        same bits in either scan, and the gathered rows keep their order,
        so ties still go to the smaller id: the answer is the masked
        scan's, and a fresh ``bruteforce`` build's over the matching rows.
        """
        if self.store is None:
            raise CapabilityError([Violation(
                "filter", "local",
                "params.filter is set but this index carries no metadata",
                "build with build_index(..., metadata={col: values}) to "
                "enable filtered search")], "local")
        pred = params.filter
        seg_parts, n_match = [], 0
        for seg in self.segments:
            if seg.n_live == 0:
                continue
            cnt, vdev = seg.filter_valid(pred, self.store)
            if cnt:
                seg_parts.append((seg, vdev))
                n_match += cnt
        delta_cnt, delta_valid = 0, None
        if self.delta is not None:
            delta_cnt, delta_valid = self.delta.filter_valid(pred,
                                                             self.store)
            n_match += delta_cnt
        if n_match == 0:
            return self._merge(q, [], params.k)
        selectivity = n_match / max(self.n_live, 1)
        brute = pred_mod.use_brute_force(selectivity, n_match)
        eff = params if brute else pred_mod.widen_params(params, selectivity)
        parts = []
        for seg, vdev in seg_parts:
            if brute:
                rows, gids = seg.filter_rows(pred, self.store)
                d, li = brute_force_topk(q, seg.rows.index_select(0, rows),
                                         params)
                parts.append((d, _remap_gids(li, gids)))
            else:
                parts.append(seg.search(q, eff, valid=vdev))
        if delta_cnt:
            parts.append(self.delta.search(q, params, valid=delta_valid))
        return self._merge(q, parts, params.k)
