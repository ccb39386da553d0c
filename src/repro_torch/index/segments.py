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

Metadata columns and filtered search (``filter_valid``,
``filter_match_live``, ``_search_filtered``) are not ported yet (ROADMAP.md
queue 1 item 5); ``SearchParams.filter`` is a capability violation before
it could reach a view.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core.search import merge_topk_pairs
from repro_torch.index.params import SearchParams
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
    """Immutable sealed segment: engine + global ids + tombstone bitmap.

    ``live`` is copy-on-write: ``with_tombstones`` returns a new segment
    sharing the engine and gids (and the gids' cached device copy) with a
    fresh bitmap, so views published before a delete keep the old liveness.
    """

    __slots__ = ("sid", "engine", "gids", "live", "n_dead", "identity_gids",
                 "_gids_dev_cell", "_live_dev")

    def __init__(self, sid: int, engine, gids: np.ndarray,
                 live: np.ndarray | None = None,
                 identity_gids: bool | None = None,
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
        # one-element cell shared across with_tombstones copies
        self._gids_dev_cell = (_gids_dev_cell if _gids_dev_cell is not None
                               else [None])
        self._live_dev = None

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
                             _gids_dev_cell=self._gids_dev_cell)

    def search(self, q: torch.Tensor, params: SearchParams,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(dists, GLOBAL ids) over this segment's live rows; ``valid``
        overrides the tombstone bitmap, which applies when a row is dead."""
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
    doubling replaces the buffer object, which invalidates the copy.
    """

    def __init__(self, dim: int, device: torch.device):
        self.device = device
        self._rows = np.zeros((_DELTA_MIN_CAP, dim), np.float32)
        self._gids = np.full(_DELTA_MIN_CAP, -1, np.int32)
        self._live = np.zeros(_DELTA_MIN_CAP, bool)
        self.count = 0
        self.n_live = 0
        self._dev_lock = threading.Lock()
        self._dev_cache: tuple | None = None   # (buf_obj, count, rows, gids)

    def append(self, x: np.ndarray, gid: int) -> int:
        if self.count == self._rows.shape[0]:
            self._rows = np.concatenate([self._rows,
                                         np.zeros_like(self._rows)])
            self._gids = np.concatenate([self._gids,
                                         np.full(self.count, -1, np.int32)])
            self._live = np.concatenate([self._live,
                                         np.zeros(self.count, bool)])
        row = self.count
        self._rows[row] = x
        self._gids[row] = gid
        self._live[row] = True
        self.count = row + 1
        self.n_live += 1
        return row

    def kill(self, row: int) -> None:
        if self._live[row]:
            self._live[row] = False
            self.n_live -= 1

    def live_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """(rows (m, d), gids (m,)) of the live prefix: the seal payload."""
        idx = np.flatnonzero(self._live[:self.count])
        return np.ascontiguousarray(self._rows[idx]), self._gids[idx].copy()

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

    __slots__ = ("_buffer", "count", "live", "_arrays")

    def __init__(self, buffer: DeltaBuffer, count: int, live: np.ndarray):
        self._buffer = buffer
        self.count = count
        self.live = live
        self._arrays = None

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

    def search(self, q: torch.Tensor, params: SearchParams,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(dists, GLOBAL ids) over the live delta rows (exact scan)."""
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

    __slots__ = ("segments", "delta", "device", "dim")

    def __init__(self, segments: tuple[SealedSegment, ...],
                 delta: DeltaView | None, device: torch.device, dim: int):
        self.segments = segments
        self.delta = delta
        self.device = device
        self.dim = dim

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

    def search(self, queries, params: SearchParams | None = None,
               **params_kw) -> tuple[torch.Tensor, torch.Tensor]:
        """queries (B, d) or (d,) -> (dists (B, k), ids (B, k)) on the
        view's device; invalid slots: +inf / -1.

        A pristine index (one segment, no delta, no tombstones, ids
        0..N-1) goes straight to its engine.  Otherwise the search fans
        out over the sealed segments (tombstones masked inside the fused
        rerank, so they never take a result slot) and the delta's exact
        scan, and merges with the associative top-k.
        """
        params = params if params is not None else SearchParams(**params_kw)
        params.require("local")
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        q = torch.atleast_2d(q).contiguous()
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
