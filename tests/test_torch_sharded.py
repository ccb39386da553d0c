"""The port's sharded index (``repro_torch.core.sharded_index``), its
``tune_sharded`` and the serving runtime's mesh mode, held against the
reference's (``repro.core.sharded_index``).

The reference runs once, in a subprocess with 8 forced host devices on a
(4, 2) mesh (as ``tests/test_multidevice.py`` does), and saves what it
computed; the port runs here on the CPU, its cells fed the reference's
streams through ``CellDraws`` (each cell's forest is the reference's
``build_forest(fold_in(fold_in(key, di), ti), rows, cell_cfg)``).  Forest
arrays and ids must be equal exactly, distances within rtol 1e-5 / atol
1e-6; the filtered brute regime and a schedule at tol 0 must equal the
port's own local / fixed-cap answers bit for bit.  Two gloo ranks holding
four cells each must answer bit for bit as one process holding all eight.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro.core import forest as jforest
from repro.serve import runtime as jruntime
from repro_torch import index as tindex
from repro_torch import serve as tserve
from repro_torch.core import forest as tforest
from repro_torch.core.sharded_index import (CellDraws, Mesh, ShardedIndex,
                                            build_sharded_index,
                                            make_query_fn)
from repro_torch.data.synthetic import clustered_gaussians
from repro_torch.filter import Eq, Range
from repro_torch.filter import predicate as tpred
from repro_torch.index.params import CapabilityError

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RTOL, ATOL = 1e-5, 1e-6
N, D, L, C, K, B = 2048, 32, 16, 12, 5, 48
MESH = (4, 2)
DEAD = list(range(0, 210, 7))          # 2,018 live rows: 2 pad rows
EXTRA_DEAD = [3, 10, 50, 400, 505, 777, 1500, 2017]   # raw-step bitmap
TUNE_GRID = (1, 2, 4)

# the searches both packages run, in this order, on one ShardedIndex; the
# counters after the last must be equal (tol 0 on the fixed searches lets
# the schedule at tol 0 reuse their steps)
CASES = [
    ("plain", dict(k=K, tol=0.0)),
    ("p4", dict(k=K, n_probes=4, tol=0.0)),
    ("brute", dict(k=K, filter=("shop", "s1"))),
    ("sched0", dict(k=K, probe_schedule=4, tol=0.0)),
    ("sched05", dict(k=K, probe_schedule=4, tol=0.05)),
]

REFERENCE = """
import os, sys, json, types
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.core import ForestConfig
from repro.core.sharded_index import ShardedIndex, make_query_fn
from repro.data.synthetic import clustered_gaussians
from repro.filter import Eq, Range
from repro.filter import predicate as pred
from repro.index import IndexSpec, SearchParams, build_index, tune_sharded
from repro.index.params import CapabilityError
N, D, L, C, K, B = {N}, {D}, {L}, {C}, {K}, {B}
CASES = {CASES}
mesh = compat.make_mesh({MESH}, ("data", "model"))
db = clustered_gaussians(N, D, seed=0)
q = db[:B] + 0.01
meta = {{"shop": np.asarray([f"s{{i % 8}}" for i in range(N)]),
        "price": np.arange(N, dtype=np.int64)}}
# the sharded index reads the live points, key, forest config and metadata
# of its index, not its engine: a bruteforce index spares a forest build
spec = IndexSpec(backend="bruteforce",
                 forest=ForestConfig(n_trees=L, capacity=C))
index = build_index(jax.random.key(0), db, spec, metadata=meta)
index.delete({DEAD})
sx = ShardedIndex(index, mesh)
out, info = {{}}, {{}}
f = sx._forest
for name in f.forest._fields:
    out["forest_" + name] = np.asarray(getattr(f.forest, name))
info["n_local"] = f.n_local
live = sx._pad_live.copy()
live[{EXTRA_DEAD}] = False
with mesh:
    for tag, kw, valid in (
            ("raw_nodedup", dict(k=K, dedup=False), None),
            ("raw_valid", dict(params=SearchParams(k=K, n_probes=4),
                               with_validity=True), live)):
        qfn = make_query_fn(f.cfg, f.n_local, mesh, **kw)
        args = (f, q, sx._db) + (() if valid is None else
                                 (jnp.asarray(valid),))
        out[tag + "_d"], out[tag + "_i"] = map(np.asarray, qfn(*args))
    refusals = {{}}
    for tag, p in (("schedule", SearchParams(k=K, probe_schedule=4)),
                   ("filter", SearchParams(k=K, filter=Eq("shop", "s1"))),
                   ("wave", SearchParams(k=K, adaptive_wave=4))):
        try:
            make_query_fn(f.cfg, f.n_local, mesh, params=p)
        except CapabilityError as e:
            refusals[tag] = [v.knob for v in e.violations]
    info["refusals"] = refusals


def params(kw):
    kw = dict(kw)
    if "filter" in kw:
        kw["filter"] = Eq(*kw["filter"])
    return SearchParams(**kw)


for tag, kw in CASES:
    out[tag + "_d"], out[tag + "_i"] = map(np.asarray,
                                           sx.search(q, params(kw)))
wavy = SearchParams(k=K, adaptive_wave=8)
try:
    sx.search(q, wavy)
except CapabilityError as e:
    info["strict"] = [v.knob for v in e.violations]
sx.strict = False
out["stripped_d"], out["stripped_i"] = map(np.asarray, sx.search(q, wavy))
sx.strict = True
pred.BRUTE_FORCE_MAX_ROWS = 100
wide = SearchParams(k=K, filter=Range("price", 0, N // 2 - 1))
out["widened_d"], out["widened_i"] = map(np.asarray, sx.search(q, wide))
info["stats"] = sx.stats()
# tune_sharded reads the live points, key and spec; its shards are rpf
rpf = types.SimpleNamespace(live_points=index.live_points, key=index.key,
                            spec=IndexSpec(backend="rpf", forest=spec.forest))
shard_params, report = tune_sharded(rpf, q, n_shards=2, k=K,
                                    probe_grid={TUNE_GRID}, persist=False)
info["tune"] = [p.to_dict() for p in shard_params]
info["tune_report"] = [dict(r, params=None if r["params"] is None
                            else r["params"].to_dict()) for r in report]
np.savez(sys.argv[1], info=np.array(json.dumps(info)), **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's answers on the (4, 2) mesh, computed once."""
    path = str(tmp_path_factory.mktemp("sharded") / "ref.npz")
    code = REFERENCE.format(N=N, D=D, L=L, C=C, K=K, B=B, CASES=CASES,
                            MESH=MESH, DEAD=DEAD, EXTRA_DEAD=EXTRA_DEAD,
                            TUNE_GRID=TUNE_GRID)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", code, path],
                         capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "info"}
        info = json.loads(str(z["info"]))
    return arrays, info


@functools.lru_cache(maxsize=None)
def _draws_fn(rc, d):
    return jax.jit(lambda keys, level: jforest._batched_level_draws(
        keys, rc, d, "compat")(level))


def _reference_draws(key, jcfg, n, d=D):
    """The reference's level draws of ``build_forest(key, rows, jcfg)``
    over ``n`` rows, as numpy arrays."""
    rc = jcfg.resolved(n)
    fn, keys = _draws_fn(rc, d), jax.random.split(key, rc.n_trees)
    return lambda level: tuple(np.array(a) for a in fn(keys, level))


JCFG = jforest.ForestConfig(n_trees=L, capacity=C)
KEY = jax.random.key(0)
CELL_DRAWS = CellDraws(lambda di, ti, n: _reference_draws(
    jax.random.fold_in(jax.random.fold_in(KEY, di), ti),
    JCFG._replace(n_trees=L // MESH[1]), n))


def _corpus():
    db = clustered_gaussians(N, D, seed=0)
    meta = {"shop": np.asarray([f"s{i % 8}" for i in range(N)]),
            "price": np.arange(N, dtype=np.int64)}
    return db, db[:B] + 0.01, meta


def _spec():
    return tindex.IndexSpec(backend="rpf", forest=tforest.ForestConfig(
        n_trees=L, capacity=C))


def _tombstoned_index():
    db, _, meta = _corpus()
    index = tindex.build_index(db, _spec(), device="cpu", metadata=meta)
    index.delete(DEAD)
    return index


def _params(kw):
    kw = dict(kw)
    if "filter" in kw:
        kw["filter"] = Eq(*kw["filter"])
    return tindex.SearchParams(**kw)


def _host(out):
    return tuple(t.cpu().numpy() for t in out)


def _assert_close(got, ref, tag):
    gd, gi = _host(got)
    np.testing.assert_array_equal(gi, ref[tag + "_i"], err_msg=tag)
    np.testing.assert_allclose(gd, ref[tag + "_d"], rtol=RTOL, atol=ATOL,
                               err_msg=tag)


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def port(ref):
    """The port's ShardedIndex over the same live rows, fed the reference's
    cell streams, driven through the reference's sequence of searches."""
    index = _tombstoned_index()
    sx = ShardedIndex(index, Mesh(MESH, device="cpu"), draws=CELL_DRAWS)
    _, q, _ = _corpus()
    out = {tag: sx.search(q, _params(kw)) for tag, kw in CASES}
    wavy = tindex.SearchParams(k=K, adaptive_wave=8)
    with pytest.raises(CapabilityError) as err:
        sx.search(q, wavy)
    out["strict"] = [v.knob for v in err.value.violations]
    sx.strict = False
    out["stripped"] = sx.search(q, wavy)
    sx.strict = True
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(tpred, "BRUTE_FORCE_MAX_ROWS", 100)
    try:
        out["widened"] = sx.search(q, tindex.SearchParams(
            k=K, filter=Range("price", 0, N // 2 - 1)))
    finally:
        mp_.undo()
    out["stats"] = sx.stats()
    return index, sx, q, out


# ---------------------------------------------------------------------------
# the cells' forests and the raw step
# ---------------------------------------------------------------------------

def test_cell_forests_are_the_references_bitwise(ref, port):
    arrays, info = ref
    _, sx, _, _ = port
    forest = sx._forest
    assert forest.n_local == info["n_local"] == (N - len(DEAD) + 2) // 4
    assert forest.trees_per_cell == L // MESH[1]
    assert [c for c, _ in forest.cells] == [(di, ti) for di in range(4)
                                           for ti in range(2)]
    for (di, ti), cell in forest.cells:
        for name, a in zip(cell._fields, cell):
            np.testing.assert_array_equal(
                a.numpy(), arrays["forest_" + name][di, ti],
                err_msg=f"cell ({di}, {ti}) {name}")


@pytest.mark.parametrize("tag,kw,extra_dead", [
    ("raw_nodedup", dict(k=K, dedup=False), False),
    ("raw_valid", dict(params=tindex.SearchParams(k=K, n_probes=4),
                       with_validity=True), True),
])
def test_make_query_fn_equals_the_reference(ref, port, tag, kw, extra_dead):
    arrays, _ = ref
    _, sx, q, _ = port
    f = sx._forest
    qfn = make_query_fn(f.cfg, f.n_local, sx.mesh, **kw)
    args = (f, q, sx._db)
    if extra_dead:
        live = sx._pad_live.copy()
        live[EXTRA_DEAD] = False
        args += (torch.from_numpy(live),)
    got = qfn(*args)
    _assert_close(got, arrays, tag)
    if extra_dead:
        assert not np.isin(got[1].numpy(), EXTRA_DEAD).any()


def test_make_query_fn_refusals_name_the_references_knobs(ref, port):
    _, info = ref
    _, sx, _, _ = port
    f = sx._forest
    for tag, p in (("schedule", tindex.SearchParams(k=K, probe_schedule=4)),
                   ("filter", tindex.SearchParams(k=K,
                                                  filter=Eq("shop", "s1"))),
                   ("wave", tindex.SearchParams(k=K, adaptive_wave=4))):
        with pytest.raises(CapabilityError) as err:
            make_query_fn(f.cfg, f.n_local, sx.mesh, params=p)
        assert [v.knob for v in err.value.violations] == \
            info["refusals"][tag], tag
        assert "ShardedIndex.search" in str(err.value) or tag == "wave"


# ---------------------------------------------------------------------------
# the ShardedIndex facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", [t for t, _ in CASES]
                         + ["stripped", "widened"])
def test_sharded_index_search_equals_the_reference(ref, port, tag):
    arrays, _ = ref
    index, _, q, out = port
    _assert_close(out[tag], arrays, tag)
    ids = out[tag][1].numpy()
    assert not np.isin(ids, DEAD).any(), "a deleted id surfaced"
    assert out[tag][1].dtype == torch.int32
    if tag == "brute":
        # the sharded brute regime scans what the local filtered search
        # scans: bit for bit its answer
        assert _bitwise(out[tag], index.search(q, _params(dict(CASES)[tag])))
        assert (ids[ids >= 0] % 8 == 1).all()
    if tag == "sched0":
        assert _bitwise(out[tag], out["p4"])
    if tag == "widened":
        assert (ids[ids >= 0] < N // 2).all()


def test_admission_and_stats_equal_the_reference(ref, port):
    _, info = ref
    _, _, _, out = port
    assert out["strict"] == info["strict"] == ["adaptive_wave"]
    assert out["stats"] == info["stats"]
    assert out["stats"]["counters"]["stripped_knobs"] == 1


def test_filter_without_metadata_refuses_and_mesh_checks():
    db, q, _ = _corpus()
    bare = tindex.build_index(db[:256], _spec(), device="cpu")
    mesh = Mesh((2, 1), device="cpu")
    sx = ShardedIndex(bare, mesh)
    with pytest.raises(CapabilityError) as err:
        sx.search(q, tindex.SearchParams(k=K, filter=Eq("shop", "s1")))
    assert [v.knob for v in err.value.violations] == ["filter"]
    assert "metadata" in str(err.value)
    lax = ShardedIndex(bare, mesh, strict=False)
    with pytest.raises(CapabilityError):    # a filter is never stripped
        lax.search(q, tindex.SearchParams(k=K, filter=Eq("shop", "s1")))
    with pytest.raises(ValueError, match="mismatch"):
        Mesh((4, 2), ("data",), device="cpu")
    with pytest.raises(ValueError, match="name each axis"):
        ShardedIndex(bare, Mesh((2, 2), ("pod", "model"), device="cpu"))
    # two builds under the same seed give the same cells, bit for bit
    a = build_sharded_index(7, db, _spec().forest, Mesh((2, 2), device="cpu"))
    b = build_sharded_index(7, db, _spec().forest, Mesh((2, 2), device="cpu"))
    assert all(_bitwise(x, y) for (_, x), (_, y) in zip(a.cells, b.cells))


def test_one_cell_mesh_is_the_local_index():
    """A (1, 1) mesh whose cell draws are the index's own build's: the
    distances are the local search's bit for bit, ids equal where untied."""
    db, q, _ = _corpus()
    index = tindex.build_index(db, _spec(), device="cpu")
    cfg = index.spec.forest

    def own(di, ti, n):
        gen = torch.Generator().manual_seed(index.seed)
        return tforest.generator_draws(gen, cfg.resolved(n), D,
                                       torch.device("cpu"))

    sx = ShardedIndex(index, Mesh((1, 1), device="cpu"), draws=CellDraws(own))
    assert _bitwise(sx._forest.cells[0][1], index.engine.forest)
    for p in (1, 4):
        params = tindex.SearchParams(k=K, n_probes=p)
        (sd, si), (ld, li) = sx.search(q, params), index.search(q, params)
        assert torch.equal(sd, ld)
        untied = torch.ones_like(sd, dtype=torch.bool)
        untied[:, 1:] &= sd[:, 1:] != sd[:, :-1]
        untied[:, :-1] &= sd[:, :-1] != sd[:, 1:]
        assert torch.equal(si[untied], li[untied])


# ---------------------------------------------------------------------------
# tune_sharded
# ---------------------------------------------------------------------------

def test_tune_sharded_equals_the_reference(ref):
    """Shard s under the reference's fold_in(key, s) stream."""
    _, info = ref
    index = _tombstoned_index()
    _, q, _ = _corpus()
    draws = tindex.SegmentDraws(lambda s, n: _reference_draws(
        jax.random.fold_in(KEY, s), JCFG, n))
    shard_params, report = tindex.tune_sharded(
        index, q, n_shards=2, k=K, probe_grid=TUNE_GRID, persist=False,
        draws=draws)
    assert [p.to_dict() for p in shard_params] == info["tune"]
    rows = [dict(r, params=None if r["params"] is None
                 else r["params"].to_dict()) for r in report]
    assert rows == info["tune_report"]
    # with a mesh: the uniform point's recall on the mesh is reported, and
    # persisting stores both points
    shard_params, report = tindex.tune_sharded(
        index, q, n_shards=2, k=K, probe_grid=TUNE_GRID,
        mesh=Mesh((2, 1), device="cpu"))
    assert 0.0 < report[-1]["mesh_recall"] <= 1.0
    assert index.shard_params == tuple(shard_params)
    assert index.tuned_params == tserve.uniform_shard_params(shard_params)
    with pytest.raises(ValueError):
        tindex.tune_sharded(index, q, n_shards=0)


# ---------------------------------------------------------------------------
# two gloo ranks, four cells each
# ---------------------------------------------------------------------------

RANK_CASES = [dict(k=K), dict(k=K, n_probes=4),
              dict(k=K, filter=("shop", "s1")),
              dict(k=K, probe_schedule=4, tol=0.05),
              dict(k=K, n_probes=2, dedup=False)]

# each rank builds the index as _rank_answers does, holds 4 of the 8 cells
# and saves the merged answers; the script imports neither JAX nor the
# reference, so its ranks start quickly
RANKS = """
import json, os, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.core.forest import ForestConfig
from repro_torch.core.sharded_index import Mesh, ShardedIndex
from repro_torch.data.synthetic import clustered_gaussians
from repro_torch.filter import Eq
from repro_torch.index import IndexSpec, SearchParams, build_index
N, D, L, C, B = {N}, {D}, {L}, {C}, {B}


def main(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out_dir, "store"), rank=rank, world_size=2)
    try:
        mesh = Mesh({MESH}, device="cpu", group=dist.group.WORLD)
        assert list(mesh.local_cells()) == list(range(4 * rank, 4 * rank + 4))
        db = clustered_gaussians(N, D, seed=0)
        meta = {{"shop": np.asarray([f"s{{i % 8}}" for i in range(N)]),
                "price": np.arange(N, dtype=np.int64)}}
        index = build_index(db, IndexSpec(backend="rpf", forest=ForestConfig(
            n_trees=L, capacity=C)), device="cpu", metadata=meta)
        index.delete({DEAD})
        sx = ShardedIndex(index, mesh)
        out = {{}}
        for j, kw in enumerate({RANK_CASES}):
            if "filter" in kw:
                kw = dict(kw, filter=Eq(*kw["filter"]))
            d, i = sx.search(db[:B] + 0.01, SearchParams(**kw))
            out[f"{{j}}_d"], out[f"{{j}}_i"] = d.numpy(), i.numpy()
        np.savez(os.path.join(out_dir, f"rank{{rank}}.npz"),
                 stats=np.array(json.dumps(sx.stats())), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(main, args=(sys.argv[1],), nprocs=2, join=True)
"""


def test_two_gloo_ranks_answer_as_one_process(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(RANKS.format(N=N, D=D, L=L, C=C, B=B, MESH=MESH,
                                   DEAD=DEAD, RANK_CASES=RANK_CASES))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    index = _tombstoned_index()
    _, q, _ = _corpus()
    sx = ShardedIndex(index, Mesh(MESH, device="cpu"))
    want = [_host(sx.search(q, _params(kw))) for kw in RANK_CASES]
    for rank in range(2):
        with np.load(tmp_path / f"rank{rank}.npz") as z:
            assert json.loads(str(z["stats"])) == sx.stats()
            for j, (d, i) in enumerate(want):
                np.testing.assert_array_equal(z[f"{j}_i"], i)
                np.testing.assert_array_equal(z[f"{j}_d"].view(np.int32),
                                              d.view(np.int32))


def test_mesh_needs_a_world_that_divides_its_cells(monkeypatch):
    monkeypatch.setattr(dist, "get_rank", lambda group: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group: 3)
    with pytest.raises(ValueError, match="do not divide"):
        Mesh(MESH, device="cpu", group=object())


# ---------------------------------------------------------------------------
# serving on a mesh
# ---------------------------------------------------------------------------

def test_mesh_runtime_serves_its_sharded_rows_bitwise():
    index = _tombstoned_index()
    _, q, _ = _corpus()
    base = tindex.SearchParams(k=K, n_probes=4, n_trees=12, adaptive_wave=0)
    rt = tserve.ServingRuntime(index, params=base, mesh=Mesh(
        MESH, device="cpu"), max_batch=8, max_wait_s=0.001,
        shed_depth=1 << 30)
    try:
        jl = jruntime.build_ladder(jindex.SearchParams(**dataclasses.asdict(
            base)), L)
        want = tuple(dict.fromkeys(p.sharded() for p in jl))
        assert [p.to_dict() for p in rt.ladder] == \
            [p.to_dict() for p in want]
        assert rt.stats()["sharded"]
        reqs = [rt.submit(x) for x in q[:20]]
        assert all(r.event.wait(60) and r.error is None for r in reqs)
        direct = _host(rt._sharded.search(q[:20], rt.ladder[0]))
        for j, r in enumerate(reqs):
            np.testing.assert_array_equal(r.result[1], direct[1][j])
            np.testing.assert_array_equal(r.result[0].view(np.int32),
                                          direct[0][j].view(np.int32))
    finally:
        rt.stop()
    # filters and schedules are served on a mesh
    p = tindex.SearchParams(k=K, filter=Eq("shop", "s1"), probe_schedule=4,
                            tol=0.0)
    rt = tserve.ServingRuntime(index, params=p, mesh=Mesh((2, 2), device="cpu"),
                               max_batch=4, max_wait_s=0.001)
    try:
        for x in q[:4]:
            _, ids = rt(x)
            assert (ids[ids >= 0] % 8 == 1).all()
    finally:
        rt.stop()
    db, _, _ = _corpus()
    bare = tindex.build_index(db[:256], _spec(), device="cpu")
    with pytest.raises(CapabilityError) as err:
        tserve.ServingRuntime(bare, params=tindex.SearchParams(
            k=K, filter=Eq("shop", "s1")), mesh=Mesh((2, 1), device="cpu"),
            warmup=False)
    assert any(v.knob == "filter" for v in err.value.violations)
    assert "metadata" in str(err.value)


def test_loaded_runtime_takes_a_mesh(tmp_path):
    index = _tombstoned_index()
    _, q, _ = _corpus()
    path = str(tmp_path / "idx")
    index.save(path)
    rt = tserve.ServingRuntime.load(path, device="cpu", mesh=Mesh(
        (2, 1), device="cpu"), max_batch=4, max_wait_s=0.001)
    try:
        assert rt.stats()["sharded"]
        d, i = rt(q[0])
        want = _host(rt._sharded.search(q[:1], rt.ladder[0]))
        np.testing.assert_array_equal(i, want[1][0])
        np.testing.assert_array_equal(d, want[0][0])
    finally:
        rt.stop()


def test_fleet_with_a_mesh_section_serves():
    index = _tombstoned_index()
    _, q, _ = _corpus()
    handle = tserve.build_fleet({
        "serving": {"max_batch": 8, "degrade": False},
        "mesh": {"shape": [2, 2], "axes": ["data", "model"]}}, index=index)
    try:
        replica = handle.fleet.replicas[0]
        assert replica.stats()["sharded"]
        assert replica._sharded.stats()["d_shards"] == 2
        answers = [handle(x) for x in q[:6]]
        direct = _host(replica._sharded.search(q[:6], replica.ladder[0]))
        for j, (d, i) in enumerate(answers):
            np.testing.assert_array_equal(i, direct[1][j])
    finally:
        handle.stop()
    with pytest.raises(ValueError, match="mismatch"):
        tserve.build_fleet({"mesh": {"shape": [2, 2], "axes": ["data"]}},
                           index=index)
