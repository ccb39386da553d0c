"""Distributed random-partition-forest index (port of
``repro/core/sharded_index.py``).

Sharding model:
  * DB rows are split over the ``db_axes`` of a :class:`Mesh` -- each DB
    shard builds forests over its own rows only, so the build needs no
    communication (the paper's "easily parallelizable and distributable"
    property, made concrete).
  * Within a DB shard the L trees are split over ``tree_axis``: each
    (db, tree) cell owns L // |tree_axis| trees (the remainder is dropped,
    as in the reference).
  * Query: the query batch is replicated; every cell descends its trees
    (kernel A), reranks against its DB shard's rows through the fused
    gather + distance + top-k (kernel B), and emits a local top-k of
    (distance, global row) pairs; the (B, k) lists of all cells are
    gathered in cell order and merged, with a dedup across the tree
    shards of one DB shard.

The mesh is a grid of cells, flattened db axes first and the tree axis
last (the order ``lax.all_gather`` over all the axes gives the reference's
merge).  It is one of two kinds:

  * the logical :class:`Mesh`.  Without a process group every cell runs
    in this process, one after another, on the mesh's device; with one,
    the cells are dealt to the group's ranks in contiguous blocks.  Every
    process holds every catalog row, and a cell slices its rows out of
    the whole ``db``.
  * a ``DeviceMesh`` whose dimensions are the db axes then the tree axis
    and whose ranks are the default process group's in row-major order:
    rank ``di * T + ti`` holds cell (di, ti) and nothing else, placed as
    the reference's ``shard_map`` in_specs.  ``build_sharded_index``
    builds this rank's cell from its own rows and returns the stacked
    ``Forest`` (D, T, ...) as DTensors under ``P(db_axes, tree_axis)``;
    the step takes that forest, the queries as plain tensors every rank
    holds whole, and ``db`` (and ``live``) as DTensors with their rows
    split over the db axes, of which the rank reads its own.

Either way the merge gathers the ranks' lists in rank order with
``torch.distributed.all_gather_into_tensor`` (the default group on a
``DeviceMesh``), and every rank gets the merged answer.

Two query surfaces:
  * ``make_query_fn`` -- the raw step for one operating point; it serves
    the per-cell knobs only and refuses the host-driven ones
    (``probe_schedule``, ``filter``) with a pointer to
  * ``ShardedIndex`` -- the ``Index``-protocol facade that drives those
    steps from the host: it turns predicates into the row-sharded validity
    bitmap (the tombstone mask generalized) and schedules per-query probe
    rounds over per-width steps.

Randomness: cell (di, ti) draws from a generator seeded with
``seal_seed(seal_seed(seed, di), ti)``, the counterpart of the
reference's ``fold_in(fold_in(key, di), ti)``; ``CellDraws`` injects the
draws instead, which is how the tests feed the reference's streams.  A
cell's state is a function of (DB shard, seed), so a lost cell is rebuilt
from its shard alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.forest import Forest, ForestConfig, build_forest
from repro_torch.core.pipeline import candidates, rerank_fused
from repro_torch.core.schedule import _improvement, probe_widths
# re-exported, as the reference's module re-exports it
from repro_torch.core.search import merge_topk_pairs
from repro_torch.device import resolve_device
from repro_torch.filter.predicate import use_brute_force, widen_params
from repro_torch.index.api import seal_seed
from repro_torch.index.params import (CapabilityError, SearchParams,
                                      Violation)
from repro_torch.index.segments import brute_force_topk
from repro_torch.kernels.common import POS_INF, topk_smallest
from repro_torch.models.layers import (P, is_device_mesh, is_dtensor,
                                       mesh_sizes, placements)

__all__ = ["CellDraws", "Mesh", "ShardedForest", "ShardedIndex",
           "build_sharded_index", "make_query_fn", "merge_topk_pairs"]


class Mesh:
    """A grid of ``shape`` cells over the named ``axes`` (the port's
    ``compat.make_mesh``), on ``device`` (the GPU unless ``device="cpu"``).

    ``group`` (a ``torch.distributed`` process group) spreads the cells
    over the group's ranks: flattened db axes first, tree axis last, each
    rank takes a contiguous block of ``n_cells // world`` cells, so the
    world size must divide the cell count.  Without a group every cell
    lives in this process.  ``shape`` maps axis name -> size, as the
    reference's mesh does.
    """

    def __init__(self, shape: Sequence[int],
                 axes: Sequence[str] = ("data", "model"),
                 device: str | torch.device | None = None, group=None):
        shape, axes = tuple(int(s) for s in shape), tuple(map(str, axes))
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} / axes {axes} mismatch")
        if min(shape, default=0) < 1:
            raise ValueError(f"mesh shape {shape} has an empty axis")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.device = resolve_device(device)
        self.group = group
        self.n_cells = math.prod(shape)
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        if self.n_cells % self.world:
            raise ValueError(f"{self.world} ranks do not divide the "
                             f"{self.n_cells} cells of mesh {shape}")

    def local_cells(self) -> range:
        """Flat indices of this rank's cells."""
        per = self.n_cells // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(B, m) of this rank's cells -> (B, world * m), ranks in order."""
        if self.group is None:
            return t
        return _gather_ranks(t, self.group)


def _gather_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """(B, m) of every rank of ``group`` (the default group for None) ->
    (B, world * m), ranks in order: one ``all_gather_into_tensor``."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    b, m = t.shape
    out = t.new_empty((world * b, m))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.view(world, b, m).transpose(0, 1).reshape(b, world * m)


def _grid(mesh, db_axes: Sequence[str], tree_axis: str) -> tuple[int, int]:
    """(DB shards, tree shards) of ``mesh`` (a :class:`Mesh` or a
    ``DeviceMesh``); every mesh axis must be a db axis or the tree axis."""
    sizes = mesh_sizes(mesh)
    named = tuple(db_axes) + (tree_axis,)
    if sorted(named) != sorted(sizes):
        raise ValueError(f"db_axes {tuple(db_axes)} + tree_axis "
                         f"{tree_axis!r} must name each axis of mesh "
                         f"{tuple(sizes)} once")
    return math.prod(sizes[a] for a in db_axes), sizes[tree_axis]


def _rank_cell(mesh, db_axes: Sequence[str], tree_axis: str
               ) -> tuple[int, int]:
    """This rank's cell (di, ti) of the ``DeviceMesh`` ``mesh``: rank ``di
    * T + ti``.  The merge gathers the cells' lists over the default
    process group in rank order, so the mesh must span that group, its
    ranks in row-major order, with its dimensions the db axes then the
    tree axis; any other mesh is refused."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names)
    if names != tuple(db_axes) + (tree_axis,):
        raise ValueError(f"a DeviceMesh with dimensions {names}: the "
                         f"sharded index takes its cells in rank order, so "
                         f"the dimensions must be db_axes + tree_axis, "
                         f"{tuple(db_axes) + (tree_axis,)}")
    world = dist.get_world_size()
    if mesh.mesh.flatten().tolist() != list(range(world)):
        raise ValueError(f"the DeviceMesh {names} of shape "
                         f"{tuple(mesh.shape)} does not span the default "
                         f"process group's {world} ranks in row-major "
                         f"order: the merge gathers over that group, one "
                         f"cell a rank")
    return divmod(dist.get_rank(), mesh_sizes(mesh)[tree_axis])


def _rank_shard(t, spec: tuple, mesh, what: str) -> torch.Tensor:
    """This rank's shard of ``t``, a DTensor on ``mesh`` that must be
    placed as ``spec`` says."""
    want = placements(spec, mesh)
    if not is_dtensor(t) or tuple(t.placements) != want:
        got = tuple(t.placements) if is_dtensor(t) else type(t).__name__
        raise ValueError(f"on a DeviceMesh the sharded step takes {what} "
                         f"as a DTensor placed {want}, not {got}")
    return t.to_local()


class CellDraws:
    """Injected randomness for the cells' forests: ``fn(di, ti, n_local)``
    returns the level draws (``core.forest.build_forest``'s ``draws``) of
    cell (di, ti)'s forest over its ``n_local`` rows."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, di: int, ti: int, n_local: int):
        return self.fn(di, ti, n_local)


class ShardedForest(NamedTuple):
    """This process's cells of a sharded forest."""

    cells: tuple        # ((di, ti), Forest) in cell order
    n_local: int        # rows per DB shard
    cfg: ForestConfig   # the cells' config, resolved for n_local

    @property
    def trees_per_cell(self) -> int:
        return self.cfg.n_trees


def _build_cell(seed: int, rows: torch.Tensor, local_cfg: ForestConfig,
                di: int, ti: int, draws: CellDraws | None) -> Forest:
    """Cell (di, ti)'s forest over its ``rows``, from ``seal_seed(seal_seed(
    seed, di), ti)`` or from ``draws``."""
    if draws is not None:
        return build_forest(rows, local_cfg,
                            draws=draws(di, ti, rows.shape[0]),
                            device=rows.device)
    gen = torch.Generator(device=rows.device).manual_seed(
        seal_seed(seal_seed(seed, di), ti))
    return build_forest(rows, local_cfg, generator=gen, device=rows.device)


def build_sharded_index(seed: int, db, cfg: ForestConfig, mesh,
                        db_axes: Sequence[str] = ("data",),
                        tree_axis: str = "model",
                        draws: CellDraws | None = None):
    """Build this process's cells over ``db`` (N, d): cell (di, ti) builds
    ``max(1, L // T)`` trees over rows ``di * n_local`` to ``(di + 1) *
    n_local`` (``n_local = N // D``; trailing rows past D * n_local are
    in no cell) from ``seal_seed(seal_seed(seed, di), ti)``, or from
    ``draws(di, ti, n_local)``.

    On a logical :class:`Mesh`, a ``ShardedForest`` of this process's
    cells, ``db`` moved to the mesh's device.  On a ``DeviceMesh``, the
    rank builds its own cell only, from its rows of ``db`` where ``db``
    lies, and returns the stacked ``Forest`` (D, T, ...) as DTensors under
    ``P(db_axes, tree_axis)``, each rank's shard its cell (1, 1, ...)."""
    d_shards, t_shards = _grid(mesh, db_axes, tree_axis)
    db = torch.as_tensor(db, dtype=torch.float32, device=None
                         if is_device_mesh(mesh) else mesh.device)
    n_local = db.shape[0] // d_shards
    local_cfg = cfg._replace(n_trees=max(1, cfg.n_trees // t_shards)
                             ).resolved(n_local)
    if is_device_mesh(mesh):
        from torch.distributed.tensor import DTensor
        di, ti = _rank_cell(mesh, db_axes, tree_axis)
        forest = _build_cell(seed, db[di * n_local:(di + 1) * n_local],
                             local_cfg, di, ti, draws)
        pl = placements(P(tuple(db_axes), tree_axis), mesh)
        return Forest(*(DTensor.from_local(x[None, None], mesh, pl,
                                           run_check=False)
                        for x in forest))
    cells = []
    for c in mesh.local_cells():
        di, ti = divmod(c, t_shards)
        rows = db[di * n_local:(di + 1) * n_local]
        cells.append(((di, ti), _build_cell(seed, rows, local_cfg, di, ti,
                                            draws)))
    return ShardedForest(cells=tuple(cells), n_local=n_local, cfg=local_cfg)


def _merge_cells(gd: torch.Tensor, gi: torch.Tensor, k: int, dedup: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cells' (B, k) lists side by side -> the global (B, k).

    Under ``dedup`` a stable sort by id marks every repeat of an id +inf,
    so ties go to the smaller id; without it ties go to the earlier cell.
    Invalid slots: +inf / -1."""
    gd = torch.where(gi >= 0, gd, POS_INF)
    if dedup:
        # tree shards over one row shard surface the same neighbours; kept
        # twice they would cap distinct recall at k / tree shards
        gi, order = torch.sort(gi, dim=1, stable=True)
        gd = torch.gather(gd, 1, order)
        dup = torch.zeros_like(gi, dtype=torch.bool)
        dup[:, 1:] = gi[:, 1:] == gi[:, :-1]
        gd = torch.where(dup, POS_INF, gd)
    d, pos = topk_smallest(gd, k)
    ids = torch.gather(gi, 1, pos.clamp_min(0))
    return d, torch.where(torch.isinf(d), -1, ids)


def make_query_fn(index_cfg: ForestConfig, n_local: int, mesh: Mesh,
                  db_axes: Sequence[str] = ("data",), tree_axis: str = "model",
                  k: int = 10, metric: str = "l2", dedup: bool = True,
                  kernel_mode: str = "auto", params: SearchParams | None = None,
                  with_validity: bool = False):
    """The sharded query step ``(index, queries, db) -> (dists (B, k), row
    ids (B, k))`` for one operating point.

    ``params`` overrides k / metric / dedup / kernel_mode and supplies the
    candidate chunk and ``n_probes``; a params with knobs the sharded step
    cannot serve (``capabilities("sharded")``), a ``probe_schedule`` or a
    ``filter`` raises ``CapabilityError`` (``ShardedIndex.search`` serves
    the last two around steps like this one).  ``with_validity=True``
    takes a fourth argument, an (N,) bool row bitmap (tombstones, a
    compiled predicate): each cell masks its rows' slice inside the fused
    rerank, so a dead row never takes a place.  On a logical
    :class:`Mesh`, ``index`` is a ``ShardedForest`` and ``db`` every row
    on the mesh's device; on a ``DeviceMesh`` (the reference's
    ``shard_map`` in_specs), ``index`` is ``build_sharded_index``'s
    stacked ``Forest`` under ``P(db_axes, tree_axis)``, ``db`` and
    ``live`` DTensors with their rows split over the db axes, and the
    queries plain tensors every rank holds whole; a mesh that
    ``_rank_cell`` refuses raises here.  Ids are row positions in ``db``.
    """
    chunk, n_probes = 0, 1
    if params is not None:
        bad = list(params.capabilities("sharded"))
        if params.probe_schedule and not any(v.knob == "probe_schedule"
                                             for v in bad):
            bad.append(Violation(
                "probe_schedule", "sharded",
                f"probe_schedule={params.probe_schedule} (make_query_fn "
                f"builds ONE fixed step; the schedule's round count is "
                f"data-dependent)",
                "use ShardedIndex.search, which host-schedules rounds "
                "over per-width steps"))
        if params.filter is not None and not any(v.knob == "filter"
                                                 for v in bad):
            bad.append(Violation(
                "filter", "sharded",
                "filter=<predicate> (the raw step consumes a validity "
                "bitmap, not a predicate AST)",
                "use ShardedIndex.search, which compiles the predicate "
                "into the row-sharded validity argument"))
        if bad:
            raise CapabilityError(
                bad, "sharded",
                prefix="make_query_fn cannot compile these params")
        k, metric = params.k, params.metric
        dedup, kernel_mode = params.dedup, params.mode
        chunk, n_probes = params.chunk, params.n_probes
    cfg = index_cfg.resolved(n_local)
    _grid(mesh, db_axes, tree_axis)

    def cell_topk(forest: Forest, q: torch.Tensor, rows: torch.Tensor,
                  live: torch.Tensor | None, lo: int):
        # descend the cell's trees (kernel A), slice their leaves, rerank
        # against the shard's rows (kernel B), globalize the row ids
        cand_ids, mask = candidates(forest, q, cfg.max_depth, cfg.leaf_pad,
                                    n_probes, kernel_mode)
        d, i = rerank_fused(q, cand_ids, mask, rows, k, metric=metric,
                            mode=kernel_mode, dedup=dedup, chunk=chunk,
                            valid=live)
        return d, torch.where(i >= 0, i + lo, -1)

    def as_queries(queries, device) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32, device=device)
        return torch.atleast_2d(q).contiguous()

    if is_device_mesh(mesh):
        di, _ = _rank_cell(mesh, db_axes, tree_axis)
        row_spec, cell_spec = P(tuple(db_axes), None), P(tuple(db_axes),
                                                          tree_axis)

        def step(index: Forest, queries, db, live=None):
            # this rank's cell, rows and bitmap; the cells' lists gathered
            # in rank order, which is cell order
            rows = _rank_shard(db, row_spec, mesh, "db")
            if rows.shape[0] != n_local:
                raise ValueError(f"the rank holds {rows.shape[0]} rows of "
                                 f"db, not n_local = {n_local}")
            cell = Forest(*(_rank_shard(x, cell_spec, mesh, "the forest")
                            [0, 0] for x in index))
            if live is not None:
                live = _rank_shard(live, P(tuple(db_axes)), mesh, "live")
            d, i = cell_topk(cell, as_queries(queries, rows.device), rows,
                             live, di * n_local)
            return _merge_cells(_gather_ranks(d), _gather_ranks(i), k,
                                dedup)
    else:
        def step(index: ShardedForest, queries, db: torch.Tensor,
                 live: torch.Tensor | None = None):
            q = as_queries(queries, mesh.device)
            parts = []
            for (di, _), forest in index.cells:
                lo = di * n_local
                parts.append(cell_topk(
                    forest, q, db[lo:lo + n_local],
                    None if live is None else live[lo:lo + n_local], lo))
            gd = mesh.all_gather(torch.cat([p[0] for p in parts], dim=1))
            gi = mesh.all_gather(torch.cat([p[1] for p in parts], dim=1))
            return _merge_cells(gd, gi, k, dedup)

    if with_validity:
        return step
    return lambda index, queries, db: step(index, queries, db)


def _bucket(n: int, b: int) -> int:
    """Padded height for ``n`` active queries: the next power of two,
    capped at the full batch."""
    p = 1
    while p < n:
        p *= 2
    return min(p, b)


class ShardedIndex:
    """``Index``-protocol facade over the sharded query path.

    Snapshots an ``Index``'s live point set, builds the cells' forests over
    the mesh and serves ``search(queries, params)`` / ``stats()`` /
    ``violations(params)`` like the host index, owning the padded rows,
    the validity bitmap, the id remap and one step per operating point
    served.  Beyond the raw step it serves the two host-driven knobs:

    * ``params.filter`` -- the predicate becomes a match bitmap in
      ``live_points()`` order (the order of the sharded rows), once per
      predicate, and rides the validity argument.  The match count is the
      exact selectivity: under ``use_brute_force`` the matching rows are
      scanned exactly (the local index's answer on a pristine index, bit
      for bit), otherwise ``n_probes`` widens per ``widen_params`` and the
      query rides the mesh.
    * ``params.probe_schedule`` -- convergence-gated rounds at doubling
      widths over per-width steps, as ``core.schedule.scheduled_query``:
      active queries gather into power-of-two buckets and each round
      replaces their results; at ``tol=0.0`` the last round is the fixed
      cap's step, bit for bit.

    ``strict`` (default) raises ``CapabilityError`` for knobs the mesh
    cannot honor; ``strict=False`` strips the ones ``SearchParams.
    sharded()`` neutralizes and counts them in ``stats()``.  A filter is
    never stripped; one an index without metadata cannot serve raises.
    ``draws`` (a ``CellDraws``) injects the cells' randomness.
    """

    def __init__(self, index, mesh: Mesh, db_axes: Sequence[str] = ("data",),
                 tree_axis: str = "model", strict: bool = True,
                 draws: CellDraws | None = None):
        self.index = index
        self.mesh = mesh
        self.db_axes = tuple(db_axes)
        self.tree_axis = tree_axis
        self.strict = bool(strict)
        self._view = index.snapshot()
        gids, rows = self._view.live_points()
        self.n_live = int(gids.shape[0])
        if self.n_live == 0:
            raise ValueError("cannot shard an empty index")
        d_shards, _ = _grid(mesh, self.db_axes, tree_axis)
        pad = (-self.n_live) % d_shards
        if pad:
            # pad to an even row split; the validity bitmap masks the pad
            # rows out of every cell's top-k (the tombstones' path)
            rows = np.concatenate([rows, np.repeat(rows[-1:], pad, axis=0)])
        dev = mesh.device
        pad_live = np.ones(rows.shape[0], bool)
        pad_live[self.n_live:] = False
        self._pad_live = pad_live
        self._gids = torch.from_numpy(np.asarray(gids, np.int32)).to(dev)
        self._db = torch.from_numpy(np.ascontiguousarray(rows, np.float32)
                                    ).to(dev)
        self._live = torch.from_numpy(pad_live).to(dev)
        self._forest = build_sharded_index(
            index.seed, self._db, index.spec.forest, mesh,
            db_axes=self.db_axes, tree_axis=tree_axis, draws=draws)
        self._steps: dict = {}           # step params -> step
        self._filters: dict = {}         # predicate -> (n_match, bits, rows)
        self._counters = {
            "queries": 0, "filtered_queries": 0, "brute_filtered_queries": 0,
            "scheduled_queries": 0, "probe_rounds": 0, "probes_processed": 0,
            "stripped_knobs": 0,
        }

    # --------------------------------------------------------- capability
    def _resolve(self, params, kw) -> SearchParams:
        if params is not None:
            return params
        if kw:
            return SearchParams(**kw)
        tuned = getattr(self.index, "tuned_params", None)
        return tuned if tuned is not None else SearchParams()

    def violations(self, params: SearchParams | None = None) -> list:
        """``capabilities("sharded")`` of ``params`` (default: the index's
        tuned point) plus the index-dependent entry: a filter on an index
        without metadata."""
        params = self._resolve(params, {})
        bad = params.capabilities("sharded")
        if params.filter is not None and self._view.store is None:
            bad.append(Violation(
                "filter", "sharded",
                "params.filter is set but this index carries no metadata",
                "build with build_index(..., metadata={col: values}) to "
                "enable filtered search"))
        return bad

    def _admit(self, params: SearchParams) -> SearchParams:
        """Reject or strip per ``strict``; returns the params to serve."""
        bad = self.violations(params)
        if not bad:
            return params
        if self.strict:
            raise CapabilityError(bad, "sharded")
        stripped = params.sharded()
        still = self.violations(stripped)
        if still:
            # what survives .sharded() cannot be stripped: an unservable
            # filter, an unknown metric
            raise CapabilityError(still, "sharded")
        self._counters["stripped_knobs"] += len(bad)
        return stripped

    # ------------------------------------------------------------- search
    def search(self, queries, params: SearchParams | None = None,
               **params_kw) -> tuple[torch.Tensor, torch.Tensor]:
        """queries (B, d) or (d,) -> (dists (B, k), global ids (B, k)) on
        the mesh's device; invalid slots: +inf / -1, over the snapshot this
        object was built from."""
        params = self._admit(self._resolve(params, params_kw))
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.mesh.device)
        q = torch.atleast_2d(q).contiguous()
        self._counters["queries"] += int(q.shape[0])
        live, eff = self._live, params
        if params.filter is not None:
            done, a, b = self._filtered_setup(q, params)
            if done:                     # zero-match and brute regimes
                return a, b
            live, eff = a, b
        if eff.probe_schedule:
            d, gi = self._search_scheduled(q, eff, live)
        else:
            d, gi = self._step(eff)(self._forest, q, self._db, live)
        return d, self._remap(gi)

    def _filtered_setup(self, q: torch.Tensor, params: SearchParams):
        """``(True, dists, ids)`` for the zero-match and brute regimes, or
        ``(False, live bitmap, widened params)`` to ride the mesh with."""
        n_match, match_dev, match_rows = self._filter_bitmap(params.filter)
        b = int(q.shape[0])
        self._counters["filtered_queries"] += b
        if n_match == 0:
            return (True, q.new_full((b, params.k), POS_INF),
                    torch.full((b, params.k), -1, dtype=torch.int32,
                               device=q.device))
        selectivity = n_match / max(self.n_live, 1)
        if use_brute_force(selectivity, n_match):
            # the matching set is small: scan it exactly, as the local
            # index's filtered search does
            self._counters["brute_filtered_queries"] += b
            d, li = brute_force_topk(q, self._db.index_select(0, match_rows),
                                     params)
            gi = self._gids[match_rows[li.clamp_min(0).long()].long()]
            return True, d, torch.where(li >= 0, gi, -1)
        # widen_params also raises the lsh stop threshold, which the mesh
        # does not serve: neutralize the knobs that are not per cell
        eff = dataclasses.replace(widen_params(params, selectivity),
                                  min_candidates=1, n_trees=0)
        return False, match_dev, eff

    def _filter_bitmap(self, predicate):
        """(match count, padded device bitmap, device row positions of the
        matches), once per predicate."""
        cached = self._filters.get(predicate)
        if cached is None:
            bits = np.zeros(self._pad_live.shape[0], bool)
            bits[:self.n_live] = self._view.filter_match_live(predicate)
            dev = self.mesh.device
            cached = (int(np.count_nonzero(bits)),
                      torch.from_numpy(bits).to(dev),
                      torch.from_numpy(np.flatnonzero(bits)).to(dev))
            self._filters[predicate] = cached
        return cached

    def _step(self, params: SearchParams):
        # the filter rides the validity argument and the schedule per-width
        # calls: neither belongs in the step's key
        key = dataclasses.replace(params, filter=None, probe_schedule=0)
        step = self._steps.get(key)
        if step is None:
            step = make_query_fn(self._forest.cfg, self._forest.n_local,
                                 self.mesh, db_axes=self.db_axes,
                                 tree_axis=self.tree_axis, params=key,
                                 with_validity=True)
            self._steps[key] = step
        return step

    def _search_scheduled(self, q: torch.Tensor, params: SearchParams,
                          live: torch.Tensor):
        """``core.schedule.scheduled_query``'s rounds over the sharded
        step; the k-th distances come to the host once a round."""
        widths = probe_widths(params.probe_schedule)
        b = int(q.shape[0])
        self._counters["scheduled_queries"] += b

        def run(q_batch, w):
            step = self._step(dataclasses.replace(params, n_probes=w))
            return step(self._forest, q_batch, self._db, live)

        best_d, best_i = run(q, widths[0])
        probes_processed = np.full(b, widths[0], np.int64)
        prev_kth = best_d[:, -1].cpu().numpy().copy()
        active = np.arange(b)
        self._counters["probe_rounds"] += 1
        for w in widths[1:]:
            if active.size == 0:
                break
            n_act = active.size
            if n_act == b:
                best_d, best_i = d_act, i_act = run(q, w)
            else:
                padded = np.concatenate(
                    [active, np.full(_bucket(n_act, b) - n_act, active[0])])
                d, i = run(q[torch.from_numpy(padded).to(q.device)], w)
                d_act, i_act = d[:n_act], i[:n_act]
                sel = torch.from_numpy(active).to(q.device)
                best_d, best_i = best_d.clone(), best_i.clone()
                best_d[sel], best_i[sel] = d_act, i_act
            probes_processed[active] += w
            self._counters["probe_rounds"] += 1
            kth = d_act[:, -1].cpu().numpy()
            converged = _improvement(prev_kth[active], kth) < params.tol
            prev_kth[active] = kth
            active = active[~converged]
        self._counters["probes_processed"] += int(probes_processed.sum())
        return best_d, best_i

    def _remap(self, i: torch.Tensor) -> torch.Tensor:
        # rows were globalized over the padded order; pad rows are masked
        # by the validity bitmap, so a position >= n_live never surfaces
        n = self._gids.shape[0]
        ok = (i >= 0) & (i < n)
        return torch.where(ok, self._gids[(i.clamp_min(0) % n).long()], -1)

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        d_shards, t_shards = _grid(self.mesh, self.db_axes, self.tree_axis)
        return {
            "sharded": True,
            "strict": self.strict,
            "n_live": self.n_live,
            "n_padded": int(self._pad_live.shape[0]) - self.n_live,
            "d_shards": d_shards,
            "t_shards": t_shards,
            "n_local": self._forest.n_local,
            "trees_per_cell": self._forest.trees_per_cell,
            "compiled_steps": len(self._steps),
            "cached_filters": len(self._filters),
            "counters": dict(self._counters),
        }
