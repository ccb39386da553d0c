"""The index API (port of ``repro/index/api.py``): one search surface over
every backend, and the segmented mutable lifecycle.

  * ``build_index(db, spec, device=...)`` -- registry-dispatched
    constructor (on ``cuda`` unless ``device="cpu"``),
  * ``index.search(queries, params)`` -- (dists (B, k), ids (B, k)); reads
    a published immutable ``IndexView``, never the writer lock,
  * ``index.add(x)`` / ``index.upsert(id, x)`` / ``index.delete(ids)`` --
    adds land in a delta buffer (searched at once by an exact scan), which
    is sealed into an immutable segment with its own engine once it
    outgrows ``spec.delta_cap`` (or ``rebuild_frac`` of the sealed rows);
    deletes and upserts tombstone the old row in its segment's bitmap,
    which the fused rerank masks,
  * ``index.snapshot()`` -- the current ``IndexView``, frozen,
  * ``index.compact(block=...)`` -- rebuild the live point set into one
    segment off the writer lock; deletes that raced the rebuild are folded
    in, adds sealed during it stay segments of their own,
  * ``index.tuned_params`` / ``shard_params`` / ``serving_plan`` -- plain
    data carried through save and load; a bare ``search(queries)`` applies
    ``tuned_params``,
  * ``index.save(path)`` / ``load_index(path)`` -- the reference's format-5
    multi-segment manifest (format 1-4 manifests load too), so an index
    saved by either package loads into the other,
  * ``build_index(..., metadata={col: values})`` -- per-row int,
    categorical or timestamp columns that ``SearchParams.filter``
    predicates (``repro_torch.filter``) select on; ``add`` and ``upsert``
    then take the new row's ``metadata``.

Randomness.  An ``rpf`` engine's forest draws from a ``torch.Generator``.
The first build draws from the caller's generator (else one seeded with
``spec.seed``) and its state before that build is kept: a compaction
rebuilds from a fresh generator set to it, so a compacted index is bitwise
a fresh build of its live rows.  Segment ``sid``'s seal draws from a
generator seeded with ``seal_seed(seed, sid)``.  ``SegmentDraws`` injects
every build's draws instead (sid 0: the first build and every compaction),
which is how the tests feed the reference's streams.  A manifest keeps the
seed as the reference keeps its key: two uint32 words (``key_data``), read
back bit for bit; a loaded index draws from that seed.

Thread safety: mutations serialize on a per-index lock and publish a
fresh view; searches read the latest view with one attribute load.
``compact(block=False)`` rebuilds on a daemon thread on the current
stream, then retunes ``tuned_params`` if the live rows drifted by more than
a quarter since this session's ``tune()`` (``index/tune.py``).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.device import resolve_device
from repro_torch.filter.metadata import MetaBlock, MetadataStore
from repro_torch.index.params import IndexSpec, SearchParams
from repro_torch.index.segments import (DELTA_SID, DeltaBuffer, IndexView,
                                        SealedSegment)

_BACKENDS: dict[str, type["Index"]] = {}
_BUILTINS_LOADED = False
FORMAT = 5


def register_backend(name: str):
    """Class decorator: register an Index subclass under ``name``."""

    def deco(cls: type["Index"]) -> type["Index"]:
        cls.backend = name
        _BACKENDS[name] = cls
        return cls

    return deco


def _ensure_backends_loaded() -> None:
    # a flag, not `if not _BACKENDS`: a user-registered backend must not
    # suppress the built-in registrations
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        _BUILTINS_LOADED = True
        import repro_torch.index.backends  # noqa: F401  (registers)


def get_backend(name: str) -> type["Index"]:
    _ensure_backends_loaded()
    if name not in _BACKENDS:
        raise KeyError(f"unknown index backend {name!r} (known: "
                       f"{sorted(_BACKENDS)})")
    return _BACKENDS[name]


def available_backends() -> list[str]:
    _ensure_backends_loaded()
    return sorted(_BACKENDS)


class SegmentDraws:
    """Injected randomness for every engine build of an index:
    ``fn(sid, n_rows)`` returns the level draws (``core.forest.
    build_forest``'s ``draws``) of the forest over the ``n_rows`` rows of
    segment ``sid`` -- the row count fixes the forest's shape.  Sid 0
    serves the first build and every compaction, a seal its own sid."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, sid: int, n_rows: int):
        return self.fn(sid, n_rows)


def seal_seed(seed: int, sid: int) -> int:
    """The generator seed of segment ``sid``'s seal: a hash of (seed,
    sid), below 2**63."""
    word = np.random.SeedSequence([seed, sid]).generate_state(1, np.uint64)
    return int(word[0]) >> 1


def key_words(seed: int) -> np.ndarray:
    """``seed`` as the reference's key data: (2,) uint32, high word first
    (the words of ``jax.random.key(seed)`` for seed < 2**32)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _device_rows(db, dev: torch.device) -> torch.Tensor:
    if isinstance(db, torch.Tensor):
        return db.to(device=dev, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(db, np.float32), device=dev
                           ).contiguous()


def _host_row(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32).reshape(-1)


def build_index(db, spec: IndexSpec | None = None, *,
                device: str | torch.device | None = None,
                generator: torch.Generator | None = None, draws=None,
                metadata: dict | None = None,
                meta_schema: dict | None = None, **spec_kw) -> "Index":
    """Build an index over ``db`` (N, d) per ``spec`` (or
    ``IndexSpec(**spec_kw)``) on ``device`` (the GPU unless
    ``device="cpu"``).

    The forest draws from ``generator``, else from a generator seeded with
    ``spec.seed``.  ``draws`` injects randomness instead: a ``SegmentDraws``
    for every build of the index, or one build's level draws (see
    ``core.forest.build_forest``), which serve the first build only.
    ``metadata`` attaches per-row columns ({name: N values}) for
    ``SearchParams.filter``; their kinds (int, categorical, timestamp) are
    inferred from the dtypes or pinned by ``meta_schema`` ({name: kind}).
    """
    spec = spec if spec is not None else IndexSpec(**spec_kw)
    rows = _device_rows(db, resolve_device(device))
    return get_backend(spec.backend)(rows, spec, generator=generator,
                                     draws=draws, metadata=metadata,
                                     meta_schema=meta_schema)


def load_index(path: str, device: str | torch.device | None = None
               ) -> "Index":
    """Restore an index saved by ``Index.save`` (the backend from its
    manifest) onto ``device`` (the GPU unless ``device="cpu"``); manifests
    the reference wrote load too."""
    manifest = Checkpointer(path).manifest()
    spec = IndexSpec.from_dict(manifest["extra"]["spec"])
    return get_backend(spec.backend)._load(path, spec, manifest,
                                           resolve_device(device))


class Index:
    """Base class: the segmented mutable lifecycle; backends plug in engines.

    Subclass contract (see ``index/backends.py``):
      * ``engine_cls`` -- the per-segment engine, built as
        ``engine_cls(spec, rows, generator=, draws=)`` over device rows,
        answering ``search(q, params, valid=None) -> (dists, local ids)``,
        holding its rows as ``db``, with ``state_tree()`` /
        ``state_skeleton(spec)`` / ``from_state(spec, state, device)``,
      * ``_v1_skeleton(spec)`` -- the tree of a format-1 checkpoint,
      * ``_extra_stats()`` -- backend-specific ``stats()`` keys.
    """

    backend: str = ""
    engine_cls: type | None = None

    def __init__(self, rows: torch.Tensor, spec: IndexSpec, *,
                 generator: torch.Generator | None = None, draws=None,
                 metadata: dict | None = None,
                 meta_schema: dict | None = None):
        meta_store = meta_block = None
        if metadata is not None:
            meta_store, meta_block = MetadataStore.from_arrays(
                metadata, int(rows.shape[0]), schema=meta_schema)
        self._init_base(spec, rows.device, int(rows.shape[1]))
        self._draws = draws if isinstance(draws, SegmentDraws) else None
        if generator is None:
            generator = torch.Generator(device=rows.device).manual_seed(
                spec.seed)
        self._init_seed(generator.initial_seed(), generator.get_state())
        if self._draws is not None:
            engine = self._new_engine(rows, 0)
        else:
            engine = self.engine_cls(spec, rows, generator=generator,
                                     draws=draws)
        seg = SealedSegment(sid=0, engine=engine,
                            gids=np.arange(rows.shape[0], dtype=np.int32),
                            meta=meta_block)
        self._init_runtime([seg], next_gid=rows.shape[0], next_sid=1,
                           meta_store=meta_store)

    def _init_base(self, spec: IndexSpec, device: torch.device, dim: int
                   ) -> None:
        self.spec = spec
        self._lock = threading.Lock()
        self._device = device
        self._d = dim
        self._draws = None

    def _init_seed(self, seed: int, state0: torch.Tensor | None,
                   key_data: np.ndarray | None = None) -> None:
        """The seed later builds draw from; ``state0`` the first build's
        generator state (None: a generator seeded with ``seed``)."""
        self.seed = int(seed)
        self._state0 = state0
        self.key_data = (key_words(self.seed) if key_data is None
                         else np.asarray(key_data, np.uint32))

    def _init_runtime(self, segments: list[SealedSegment], next_gid: int,
                      next_sid: int, meta_store: MetadataStore | None = None
                      ) -> None:
        """Shared tail of __init__ and the checkpoint loaders."""
        self._tuned_params: SearchParams | None = None
        self._shard_params: tuple[SearchParams, ...] | None = None
        self._serving_plan: dict | None = None
        # what this session's last tune() saw (sample queries, its
        # arguments, the live-row count): compact() retunes from it after
        # churn; it does not ride the manifest
        self._tune_ctx: dict | None = None
        self._tuned_n_live = 0
        self._n_retunes = 0
        self._meta_store = meta_store
        self._segments = list(segments)
        self._delta = self._new_delta()
        self._next_gid = int(next_gid)
        self._next_sid = int(next_sid)
        self._compacting = False
        self._n_seals = 0
        self._n_compactions = 0
        self._n_deleted_total = 0
        # live-row directory: global id -> (segment sid | DELTA_SID, row)
        self._loc: dict[int, tuple[int, int]] = {}
        for seg in self._segments:
            rows = np.flatnonzero(seg.live)
            self._loc.update(zip(seg.gids[rows].tolist(),
                                 ((seg.sid, int(r)) for r in rows)))
        self._publish_locked()

    @classmethod
    def _assemble(cls, spec: IndexSpec, device: torch.device, dim: int,
                  key_data, segments: list[SealedSegment], next_gid: int,
                  next_sid: int, meta_store: MetadataStore | None = None
                  ) -> "Index":
        """An index over built segments (a loaded or carried state)."""
        obj = cls.__new__(cls)
        obj._init_base(spec, device, dim)
        words = np.asarray(key_data, np.uint32).reshape(-1)
        obj._init_seed((int(words[0]) << 32) | int(words[1]), None,
                       key_data=words)
        obj._init_runtime(segments, next_gid=next_gid, next_sid=next_sid,
                          meta_store=meta_store)
        return obj

    @classmethod
    def _from_engine(cls, engine, spec: IndexSpec) -> "Index":
        """A pristine one-segment index around an engine built elsewhere."""
        n, dim = engine.db.shape
        seg = SealedSegment(sid=0, engine=engine,
                            gids=np.arange(n, dtype=np.int32))
        return cls._assemble(spec, engine.db.device, int(dim),
                             key_words(spec.seed), [seg], n, 1)

    def _new_engine(self, rows: torch.Tensor, sid: int):
        """A new engine over device ``rows`` for segment ``sid`` (0: the
        first build and every compaction)."""
        if self._draws is not None:
            return self.engine_cls(self.spec, rows,
                                   draws=self._draws(sid, rows.shape[0]))
        gen = torch.Generator(device=rows.device)
        if sid == 0 and self._state0 is not None:
            gen.set_state(self._state0)
        else:
            gen.manual_seed(self.seed if sid == 0
                            else seal_seed(self.seed, sid))
        return self.engine_cls(self.spec, rows, generator=gen)

    def _new_delta(self) -> DeltaBuffer:
        return DeltaBuffer(self._d, self._device, meta_store=self._meta_store)

    def _publish_locked(self) -> None:
        """Swap in a fresh immutable view (caller holds the writer lock)."""
        self._view = IndexView(tuple(self._segments), self._delta.view(),
                               self._device, self._d, store=self._meta_store)

    def snapshot(self) -> IndexView:
        """The current immutable view: searchable, frozen, lock-free."""
        return self._view

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def n_rows(self) -> int:
        """Number of live points (tombstoned rows excluded)."""
        return self._view.n_live

    @property
    def db(self) -> torch.Tensor:
        """All sealed rows in segment order, on the device (tombstoned rows
        included until the next ``compact()``)."""
        segments = self._view.segments
        if len(segments) == 1:
            return segments[0].rows
        if not segments:
            return torch.zeros((0, self._d), device=self._device)
        return torch.cat([s.rows for s in segments])

    def live_points(self) -> tuple[np.ndarray, np.ndarray]:
        """Canonical (gids, rows) of the live point set (segment order) as
        host arrays: the order ``compact()`` rebuilds in."""
        return self._view.live_points()

    @property
    def _primary_engine(self):
        return self._view.segments[0].engine

    @property
    def engine(self):
        """The first segment's engine (the whole index while pristine)."""
        return self._primary_engine

    @property
    def meta_store(self) -> MetadataStore | None:
        """The metadata schema and categorical vocab (None: no metadata)."""
        return self._meta_store

    def stats(self) -> dict:
        """Consistent counter snapshot (taken under the writer lock)."""
        with self._lock:
            segments = list(self._segments)
            n_static = sum(s.n_rows for s in segments)
            n_dead = sum(s.n_dead for s in segments)
            n_delta = self._delta.n_live
            return {
                "backend": self.backend,
                "n_static": n_static,
                "n_overflow": n_delta,
                "n_delta": n_delta,
                "n_live": n_static - n_dead + n_delta,
                "n_tombstones": n_dead + (self._delta.count
                                          - self._delta.n_live),
                "n_deleted_total": self._n_deleted_total,
                "n_segments": len(segments),
                "n_seals": self._n_seals,
                "n_compactions": self._n_compactions,
                "n_retunes": self._n_retunes,
                "compaction_in_progress": self._compacting,
                "metadata_columns": (sorted(self._meta_store.columns)
                                     if self._meta_store is not None else []),
                **self._extra_stats(),
            }

    def _extra_stats(self) -> dict:
        return {}

    # --------------------------------------------------------------- search
    @property
    def tuned_params(self) -> SearchParams | None:
        """The tuned operating point, or None.  When set, a bare
        ``search(queries)`` uses it; explicit params always win.  Carried
        through save and load."""
        return self._tuned_params

    @tuned_params.setter
    def tuned_params(self, params: SearchParams | None) -> None:
        if params is not None and not isinstance(params, SearchParams):
            raise TypeError(f"tuned_params must be SearchParams or None, "
                            f"got {type(params).__name__}")
        self._tuned_params = params

    @property
    def shard_params(self) -> tuple[SearchParams, ...] | None:
        """Per-shard operating points, or None (carried through save and
        load)."""
        return self._shard_params

    @shard_params.setter
    def shard_params(self, params) -> None:
        if params is not None:
            params = tuple(params)
            if not params or not all(isinstance(p, SearchParams)
                                     for p in params):
                raise TypeError("shard_params must be a non-empty sequence "
                                "of SearchParams, or None")
        self._shard_params = params

    @property
    def serving_plan(self) -> dict | None:
        """A capacity plan as a JSON-ready dict, or None (carried through
        save and load)."""
        return self._serving_plan

    @serving_plan.setter
    def serving_plan(self, plan: dict | None) -> None:
        if plan is not None and not isinstance(plan, dict):
            raise TypeError(f"serving_plan must be a JSON-ready dict or "
                            f"None, got {type(plan).__name__}")
        self._serving_plan = plan

    def search(self, queries, params: SearchParams | None = None,
               **params_kw) -> tuple[torch.Tensor, torch.Tensor]:
        """queries (B, d) or (d,) -> (dists (B, k), ids (B, k)) on the
        index's device; invalid slots: +inf / -1.

        ``params`` (or loose ``**params_kw``) selects the operating point;
        with neither, ``tuned_params`` apply when set, else
        ``SearchParams()``.  Reads the published view, never the lock.
        """
        with tracing.span("index.search"):
            if (params is None and not params_kw
                    and self._tuned_params is not None):
                params = self._tuned_params
            return self._view.search(queries, params, **params_kw)

    # ------------------------------------------------------------ mutations
    def _encode_meta_locked(self, metadata: dict | None) -> dict | None:
        """A point's metadata -> column codes.  An index with metadata needs
        every column on every add (predicates are total); metadata on an
        index without any raises rather than being dropped."""
        if self._meta_store is None:
            if metadata:
                raise ValueError("this index carries no metadata — build "
                                 "with build_index(..., metadata=...) first")
            return None
        return self._meta_store.encode_point(metadata)

    def add(self, x, metadata: dict | None = None) -> int:
        """Add one point; returns its id.  It lands in the delta buffer
        (searched at once); the delta seals into an immutable segment with
        its own engine once it outgrows the seal threshold.  ``metadata``
        ({column: value}) must cover the index's metadata schema exactly
        when it has one."""
        x = _host_row(x)
        with self._lock:
            codes = self._encode_meta_locked(metadata)
            gid = self._next_gid
            self._next_gid += 1
            row = self._delta.append(x, gid, meta=codes)
            self._loc[gid] = (DELTA_SID, row)
            self._maybe_seal_locked()
            self._publish_locked()
            return gid

    def delete(self, ids) -> int:
        """Tombstone one id or an iterable of ids; returns the count.

        Raises KeyError, before any mutation, if an id is unknown, already
        deleted or repeated; deleted rows leave the results at once and
        are dropped at the next seal or compaction.
        """
        id_list = [int(ids)] if np.isscalar(ids) else [int(g) for g in ids]
        with self._lock:
            locs, seen = [], set()
            for gid in id_list:
                loc = self._loc.get(gid)
                if loc is None or gid in seen:
                    raise KeyError(f"id {gid} is not a live point")
                seen.add(gid)
                locs.append(loc)
            # one bitmap copy per touched segment, not per id
            by_sid: dict[int, list[int]] = {}
            for gid, (sid, row) in zip(id_list, locs):
                del self._loc[gid]
                by_sid.setdefault(sid, []).append(row)
            for sid, rows in by_sid.items():
                if sid == DELTA_SID:
                    for row in rows:
                        self._delta.kill(row)
                else:
                    i = self._segment_pos_locked(sid)
                    self._segments[i] = self._segments[i].with_tombstones(
                        np.asarray(rows))
            self._n_deleted_total += len(id_list)
            self._publish_locked()
        return len(id_list)

    def upsert(self, gid: int, x, metadata: dict | None = None) -> int:
        """Insert or replace the vector of ``gid`` (the id is kept): the old
        row, if any, is tombstoned and the new one appended to the delta,
        so one row per id is live at all times.  On an index with metadata
        the new row's ``metadata`` (every column) replaces the old row's."""
        gid = int(gid)
        x = _host_row(x)
        with self._lock:
            codes = self._encode_meta_locked(metadata)
            old = self._loc.get(gid)
            if old is not None:
                self._kill_locked(old)
            row = self._delta.append(x, gid, meta=codes)
            self._loc[gid] = (DELTA_SID, row)
            if gid >= self._next_gid:
                self._next_gid = gid + 1
            self._maybe_seal_locked()
            self._publish_locked()
        return gid

    def _segment_pos_locked(self, sid: int) -> int:
        for i, seg in enumerate(self._segments):
            if seg.sid == sid:
                return i
        raise AssertionError(f"directory references unknown segment {sid}")

    def _kill_locked(self, loc: tuple[int, int]) -> None:
        sid, row = loc
        if sid == DELTA_SID:
            self._delta.kill(row)
            return
        i = self._segment_pos_locked(sid)
        self._segments[i] = self._segments[i].with_tombstones(
            np.asarray([row]))

    # ----------------------------------------------------------- seal/flush
    def _seal_threshold(self) -> float:
        if self.spec.delta_cap > 0:
            return float(self.spec.delta_cap)
        n_static = sum(s.n_rows for s in self._segments)
        return max(1.0, self.spec.rebuild_frac * n_static)

    def _maybe_seal_locked(self) -> None:
        if self._delta.count >= self._seal_threshold():
            self._seal_delta_locked()

    def _seal_delta_locked(self) -> None:
        """Freeze the delta's live rows into a new immutable segment."""
        rows, gids, meta_cols = self._delta.live_rows()
        if rows.shape[0] == 0:
            self._delta = self._new_delta()
            return
        sid = self._next_sid
        # build the engine BEFORE retiring the delta: a failed build must
        # not lose the pending adds or corrupt the directory
        engine = self._new_engine(_device_rows(rows, self._device), sid)
        self._next_sid += 1
        self._delta = self._new_delta()
        meta = MetaBlock(meta_cols) if meta_cols is not None else None
        self._segments.append(SealedSegment(sid=sid, engine=engine,
                                            gids=gids, meta=meta))
        self._loc.update(zip(gids.tolist(),
                             ((sid, j) for j in range(gids.shape[0]))))
        self._n_seals += 1

    def flush(self) -> None:
        """Seal any pending delta rows into an immutable segment."""
        with self._lock:
            self._seal_delta_locked()
            self._publish_locked()

    # ------------------------------------------------------------ compaction
    def compact(self, block: bool = True):
        """Rebuild the live point set into one fresh segment.

        The rebuild runs off the writer lock: searches keep reading the old
        view and mutations keep landing (deletes that race it are applied
        to the new segment at the swap; adds sealed during it stay their
        own segments).  ``block=False`` runs it on a daemon thread and
        returns the thread; ``block=True`` returns a stats dict.  The
        rebuild gathers the live rows on the device in canonical order and
        draws as the first build did, so a compacted index answers bitwise
        as a fresh ``build_index`` of its live rows.  Metadata columns are
        gathered and concatenated in the same order.  After the swap, a
        tuned index whose live rows drifted past the staleness threshold
        retunes (:meth:`_maybe_retune`).
        """
        with self._lock:
            if self._compacting:
                raise RuntimeError("compaction already in progress")
            self._compacting = True
            try:
                self._seal_delta_locked()
                snap = list(self._segments)
                parts = [(seg, np.flatnonzero(seg.live)) for seg in snap]
                self._publish_locked()
            except BaseException:
                self._compacting = False
                raise

        def rebuild() -> dict:
            try:
                sources = [(seg.sid, int(r)) for seg, idx in parts
                           for r in idx]
                gids = (np.concatenate([seg.gids[idx] for seg, idx in parts])
                        if parts else np.zeros(0, np.int32))
                meta = (MetaBlock.concat([seg.meta.take(idx)
                                          for seg, idx in parts])
                        if self._meta_store is not None else None)
                rows = (torch.cat([
                    seg.rows[torch.from_numpy(idx).to(self._device)]
                    for seg, idx in parts]) if parts
                    else torch.zeros((0, self._d), device=self._device))
                engine = (self._new_engine(rows.contiguous(), 0)
                          if rows.shape[0] else None)
                with self._lock:
                    snap_sids = {seg.sid for seg in snap}
                    newer = [s for s in self._segments
                             if s.sid not in snap_sids]
                    if engine is not None:
                        # a source row is still live iff the directory
                        # still points at its pre-compaction location
                        live = np.fromiter(
                            (self._loc.get(int(g)) == src
                             for g, src in zip(gids, sources)),
                            bool, count=gids.shape[0])
                        sid = self._next_sid
                        self._next_sid += 1
                        seg = SealedSegment(sid=sid, engine=engine,
                                            gids=gids, live=live, meta=meta)
                        for j, (g, alive) in enumerate(zip(gids.tolist(),
                                                           live)):
                            if alive:
                                self._loc[g] = (sid, j)
                        self._segments = [seg] + newer
                    else:
                        self._segments = newer
                    self._n_compactions += 1
                    self._publish_locked()
                    stats = {"n_rows": int(rows.shape[0]),
                             "n_segments_in": len(snap),
                             "n_segments_out": len(self._segments)}
            finally:
                self._compacting = False
            self._maybe_retune()
            return stats

        if block:
            return rebuild()
        t = threading.Thread(target=rebuild, daemon=True)
        t.start()
        return t

    # retune when the live-row count has drifted by more than this share
    # since the operating point was tuned
    _RETUNE_STALENESS = 0.25

    def _maybe_retune(self) -> None:
        """After a compaction, retune ``tuned_params`` when the live rows
        no longer resemble those the last ``tune()`` of this session
        measured: with the same sample queries and arguments, so the new
        point answers the same recall target.  Counted in
        ``stats()['n_retunes']``."""
        ctx, tuned_n = self._tune_ctx, self._tuned_n_live
        if ctx is None or tuned_n <= 0:
            return
        if abs(self.n_rows - tuned_n) / tuned_n < self._RETUNE_STALENESS:
            return
        from repro_torch.index.tune import tune_report  # tune imports us
        tune_report(self, ctx["queries"], **ctx["kwargs"])
        self._n_retunes += 1

    # -------------------------------------------------------------- save/load
    def save(self, path: str) -> str:
        """Checkpoint the index under ``path`` (the reference's format-5
        manifest): pending delta rows are sealed first, then every
        segment's engine state, global ids, tombstone bitmap and metadata
        columns, the seed's key data, ``tuned_params``, ``shard_params``,
        ``serving_plan`` and the metadata schema and vocab
        (``meta_schema``).  Returns the step's directory."""
        with self._lock:
            self._seal_delta_locked()
            self._publish_locked()
            tree: dict = {"key_data": self.key_data, "segments": {}}
            seg_meta = []
            for i, seg in enumerate(self._segments):
                tree["segments"][f"{i:03d}"] = {
                    "engine": seg.engine.state_tree(),
                    "gids": seg.gids,
                    "live": seg.live,
                }
                if self._meta_store is not None:
                    tree["segments"][f"{i:03d}"]["meta"] = dict(
                        seg.meta.cols)
                seg_meta.append({"sid": seg.sid, "n_rows": seg.n_rows})
            extra = {
                "spec": self.spec.to_dict(),
                "backend": self.backend,
                "format": FORMAT,
                "dim": self._d,
                "segments": seg_meta,
                "next_gid": self._next_gid,
                "next_sid": self._next_sid,
                "tuned_params": (self._tuned_params.to_dict()
                                 if self._tuned_params is not None else None),
                "shard_params": ([p.to_dict() for p in self._shard_params]
                                 if self._shard_params is not None else None),
                "serving_plan": self._serving_plan,
                "meta_schema": (self._meta_store.to_json()
                                if self._meta_store is not None else None),
            }
            return Checkpointer(path, keep=1).save(0, tree, extra=extra)

    @classmethod
    def load(cls, path: str, device: str | torch.device | None = None
             ) -> "Index":
        manifest = Checkpointer(path).manifest()
        return cls._load(path, IndexSpec.from_dict(manifest["extra"]["spec"]),
                         manifest, resolve_device(device))

    @classmethod
    def _load(cls, path: str, spec: IndexSpec, manifest: dict,
              device: torch.device) -> "Index":
        if manifest["extra"].get("format", 1) >= 2:
            return cls._load_v2(path, spec, manifest, device)
        return cls._load_v1(path, spec, manifest, device)

    @classmethod
    def _load_v2(cls, path: str, spec: IndexSpec, manifest: dict,
                 device: torch.device) -> "Index":
        """Loader of segmented manifests (formats 2 to 5): each format only
        adds optional extras to format 2's segment state.  The metadata
        leaves are read when the manifest has ``meta_schema``, so an older
        manifest, or one with the schema removed, loads without them."""
        extra = manifest["extra"]
        meta_schema = extra.get("meta_schema")
        store = (MetadataStore.from_json(meta_schema)
                 if meta_schema is not None else None)
        meta_cols = sorted(store.columns) if store is not None else []
        skeleton = {"key_data": 0, "segments": {
            f"{i:03d}": {"engine": cls.engine_cls.state_skeleton(spec),
                         "gids": 0, "live": 0,
                         **({"meta": {c: 0 for c in meta_cols}}
                            if store is not None else {})}
            for i in range(len(extra["segments"]))}}
        state, _ = Checkpointer(path).restore(skeleton,
                                              step=manifest["step"])
        segments = []
        for i, meta in enumerate(extra["segments"]):
            st = state["segments"][f"{i:03d}"]
            block = (MetaBlock({c: np.asarray(st["meta"][c], store.dtype(c))
                                for c in meta_cols})
                     if store is not None else None)
            segments.append(SealedSegment(
                sid=int(meta["sid"]),
                engine=cls.engine_cls.from_state(spec, st["engine"], device),
                gids=np.asarray(st["gids"], np.int32),
                live=np.asarray(st["live"], bool), meta=block))
        obj = cls._assemble(spec, device, int(extra["dim"]),
                            state["key_data"], segments,
                            next_gid=extra["next_gid"],
                            next_sid=extra["next_sid"], meta_store=store)
        tuned = extra.get("tuned_params")
        if tuned is not None:
            obj._tuned_params = SearchParams.from_dict(tuned)
        shard = extra.get("shard_params")
        if shard:
            obj._shard_params = tuple(SearchParams.from_dict(p)
                                      for p in shard)
        obj._serving_plan = extra.get("serving_plan") or None
        return obj

    @classmethod
    def _load_v1(cls, path: str, spec: IndexSpec, manifest: dict,
                 device: torch.device) -> "Index":
        """Read shim for the single-segment checkpoint format."""
        state, _ = Checkpointer(path).restore(cls._v1_skeleton(spec),
                                              step=manifest["step"])
        engine = cls.engine_cls.from_state(spec, state, device)
        n, dim = engine.db.shape
        seg = SealedSegment(sid=0, engine=engine,
                            gids=np.arange(n, dtype=np.int32))
        return cls._assemble(spec, device, int(dim), state["key_data"],
                             [seg], next_gid=n, next_sid=1)

    # ------------------------------------------------------ subclass hooks
    @classmethod
    def _v1_skeleton(cls, spec: IndexSpec) -> dict:
        raise NotImplementedError
