"""The port's mutable index: the reference's mutation matrix
(``tests/test_index_mutation.py``) inside ``repro_torch``, and one op
sequence on both packages.

Inside the port, each backend runs in its full-recall regime (fat leaves,
a full-width shortlist, every cascade level probed), so a mutated index
must answer bitwise as a fresh build of its live points, before and after
compaction; any difference is then a fault in the segment fan-out, the
tombstone masking or the merge.  Thread tests assert order and results
(events gate the slowed rebuild), never wall-clock times.

Across packages, the same adds, deletes, upserts, seals and compactions
give equal ids, equal ``live_points`` and equal ``stats()``, and searches
give equal ids with distances within rtol 1e-5 / atol 1e-6; ``rpf`` runs
under the reference's draws for the first build, every seal and the
compaction (``SegmentDraws``).
"""
import os
import threading

import jax
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro.core import forest as jforest
from repro_torch import index as tindex
from repro_torch.core import forest as tforest
from repro_torch.index import backends as tbackends

N_DB, DIM = 220, 12
RTOL, ATOL = 1e-5, 1e-6

FULL_RECALL = {
    "rpf": (tindex.IndexSpec(backend="rpf", forest=tforest.ForestConfig(
        n_trees=4, capacity=512)), tindex.SearchParams(k=5)),
    "rpf+int8": (tindex.IndexSpec(backend="rpf+int8",
                                  forest=tforest.ForestConfig(
                                      n_trees=4, capacity=512)),
                 tindex.SearchParams(k=5, expand=128)),
    "lsh-cascade": (tindex.IndexSpec(backend="lsh-cascade",
                                     lsh_radii=(0.5, 1.0, 2.0),
                                     lsh_tables=6, lsh_bits=6),
                    tindex.SearchParams(k=5, min_candidates=10**9)),
    "bruteforce": (tindex.IndexSpec(backend="bruteforce"),
                   tindex.SearchParams(k=5)),
}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    db = np.abs(rng.normal(size=(N_DB, DIM))).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = np.abs(db[:6] + 0.01 * rng.normal(size=(6, DIM)).astype(np.float32))
    return db, q


def _build(db, spec, **kw):
    return tindex.build_index(db, spec, device="cpu", **kw)


def _mutate(index, dim=DIM, seed=3):
    """Adds (one seal, rows left in the delta), deletes in the base
    segment, the sealed segment and the delta, and an upsert."""
    rng = np.random.default_rng(seed)
    added = [index.add(np.abs(rng.normal(size=dim)).astype(np.float32))
             for _ in range(25)]
    index.delete(list(range(0, 40, 3)) + added[::4])
    index.upsert(7, np.abs(rng.normal(size=dim)).astype(np.float32))
    return index


def _np(out):
    return tuple(t.numpy() for t in out)


def _assert_bitwise_vs_fresh(index, q, spec, params):
    gids, rows = index.live_points()
    fresh = _build(rows, spec)
    dm, im = _np(index.search(q, params))
    df, i_f = _np(fresh.search(q, params))
    i_f_g = np.where(i_f >= 0, gids[np.maximum(i_f, 0)], -1)
    np.testing.assert_array_equal(im, i_f_g)
    np.testing.assert_array_equal(dm, df)


@pytest.mark.parametrize("backend", sorted(FULL_RECALL))
def test_mutated_index_bitwise_vs_fresh(corpus, backend):
    db, q = corpus
    spec, params = FULL_RECALL[backend]
    index = _mutate(_build(db, spec))
    if backend == "lsh-cascade":
        # the delta is scanned exactly; the hashed equivalence needs the
        # adds sealed into a hashed segment
        index.flush()
    st = index.stats()
    assert st["n_segments"] == (3 if backend == "lsh-cascade" else 2)
    assert st["n_tombstones"] > 0
    _assert_bitwise_vs_fresh(index, q, spec, params)
    gids_before, _ = index.live_points()
    index.compact()
    st = index.stats()
    assert st["n_segments"] == 1 and st["n_tombstones"] == 0
    np.testing.assert_array_equal(index.live_points()[0], gids_before)
    _assert_bitwise_vs_fresh(index, q, spec, params)


def test_post_compaction_bitwise_any_config(corpus):
    """compact() draws as the first build did, over the canonical live
    order: bitwise a fresh build in any forest config, and so are two
    fresh builds of the same rows."""
    db, q = corpus
    spec = tindex.IndexSpec(backend="rpf",
                            forest=tforest.ForestConfig(n_trees=10,
                                                        capacity=8))
    index = _mutate(_build(db, spec))
    index.compact()
    _assert_bitwise_vs_fresh(index, q, spec, tindex.SearchParams(k=4))
    _, rows = index.live_points()
    for a, b, c in zip(index.forest, _build(rows, spec).forest,
                       _build(rows, spec).forest):
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.parametrize("backend,params", [
    ("rpf", tindex.SearchParams(k=5)),
    ("rpf", tindex.SearchParams(k=5, n_probes=2)),
    ("rpf+int8", tindex.SearchParams(k=5, expand=128)),
    ("lsh-cascade", tindex.SearchParams(k=5, min_candidates=10**9)),
    ("bruteforce", tindex.SearchParams(k=5)),
])
def test_delete_then_search_matches_bruteforce_oracle(corpus, backend,
                                                      params):
    db, q = corpus
    index = _build(db, FULL_RECALL[backend][0])
    deleted = list(range(0, 60, 2))
    index.delete(deleted)
    if backend == "lsh-cascade":
        index.flush()
    ids = index.search(q, params)[1].numpy()
    assert not np.isin(ids, deleted).any(), "tombstoned id surfaced"
    gids, rows = index.live_points()
    d = np.sum((q[:, None, :] - rows[None, :, :]) ** 2, axis=-1)
    oracle = gids[np.argsort(d, axis=1)[:, :params.k]]
    if backend == "lsh-cascade":
        assert np.isin(ids, gids).all()
        assert (ids == oracle).mean() > 0.5
    else:
        np.testing.assert_array_equal(ids, oracle)


def test_upsert_replaces_vector_and_keeps_id(corpus):
    db, _ = corpus
    spec, _ = FULL_RECALL["rpf"]
    index = _build(db, spec)
    new_vec = np.full(DIM, 0.9, np.float32)
    assert index.upsert(3, new_vec) == 3
    d, i = index.search(new_vec[None], tindex.SearchParams(k=1))
    assert int(i[0, 0]) == 3 and float(d[0, 0]) < 1e-9
    _, i = index.search(db[3][None], tindex.SearchParams(k=3))
    assert 3 not in i.numpy().ravel().tolist()
    gids, _ = index.live_points()
    assert np.unique(gids).size == gids.size
    # an upsert of an unknown id inserts it and moves the next id past it
    assert index.upsert(N_DB + 50, new_vec * 0.5) == N_DB + 50
    assert index.add(new_vec) == N_DB + 51


def test_delete_validation_is_atomic(corpus):
    db, _ = corpus
    index = _build(db, FULL_RECALL["rpf"][0])
    with pytest.raises(KeyError):
        index.delete([1, 2, 10**6])          # unknown id: no mutation
    assert index.stats()["n_tombstones"] == 0
    with pytest.raises(KeyError):
        index.delete([3, 3])                 # repeated in one batch
    assert index.stats()["n_tombstones"] == 0
    assert index.delete([1, 2]) == 2
    with pytest.raises(KeyError):
        index.delete(1)                      # already deleted
    assert index.stats()["n_tombstones"] == 2
    ids = index.search(db[:4], tindex.SearchParams(k=3))[1].numpy()
    assert not np.isin(ids, [1, 2]).any()
    assert np.isin(3, index.live_points()[0])


def test_snapshot_isolation(corpus):
    db, _ = corpus
    spec, params = FULL_RECALL["rpf"]
    index = _build(db, spec)
    snap = index.snapshot()
    d0, i0 = _np(snap.search(db[5][None], params))
    index.delete(5)
    index.add(db[5] * 0.5)
    d1, i1 = _np(snap.search(db[5][None], params))
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)
    assert int(i1[0, 0]) == 5
    assert 5 not in index.search(db[5][None], params)[1].numpy().ravel()


def test_stats_counters(corpus):
    db, _ = corpus
    spec = tindex.IndexSpec(backend="rpf",
                            forest=tforest.ForestConfig(n_trees=4,
                                                        capacity=64),
                            delta_cap=8)
    index = _build(db, spec)
    for j in range(20):
        index.add(db[j] + 0.01)
    st = index.stats()
    assert st["n_seals"] == 2 and st["n_segments"] == 3
    assert st["n_overflow"] == st["n_delta"] == 20 - 16
    index.delete([0, 1, 2])
    st = index.stats()
    assert st["n_tombstones"] == 3 and st["n_deleted_total"] == 3
    assert st["n_live"] == index.n_rows == N_DB + 20 - 3
    index.compact()
    st = index.stats()
    assert st["n_segments"] == 1 and st["n_compactions"] == 1
    assert st["n_tombstones"] == 0 and st["n_live"] == N_DB + 20 - 3
    assert st["n_trees"] == 4 and st["n_retunes"] == 0
    assert not st["compaction_in_progress"]
    assert st["metadata_columns"] == []


@pytest.fixture
def gated_build(monkeypatch):
    """Slow every forest build down until ``release`` is set; ``started``
    is set when one begins."""
    started, release = threading.Event(), threading.Event()
    real = tbackends.build_forest

    def gated(*a, **kw):
        started.set()
        assert release.wait(60), "the test never released the rebuild"
        return real(*a, **kw)

    monkeypatch.setattr(tbackends, "build_forest", gated)
    return started, release


def test_search_during_compaction_does_not_block(corpus, gated_build):
    db, q = corpus
    spec, params = FULL_RECALL["rpf"]
    started, release = gated_build
    release.set()
    index = _mutate(_build(db, spec))
    index.flush()
    d0, i0 = _np(index.search(q, params))
    release.clear()
    started.clear()
    t = index.compact(block=False)
    assert started.wait(60), "compaction rebuild never started"
    # the rebuild is held: a search answers from the old view, and a
    # mutation lands, while it runs
    d1, i1 = _np(index.search(q, params))
    assert index.stats()["compaction_in_progress"]
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)
    gid = index.add(np.full(DIM, 0.7, np.float32))
    assert t.is_alive()
    release.set()
    t.join(60)
    assert not t.is_alive()
    assert not index.stats()["compaction_in_progress"]
    i2 = index.search(np.full(DIM, 0.7, np.float32)[None],
                      tindex.SearchParams(k=1))[1]
    assert int(i2[0, 0]) == gid
    assert index.stats()["n_segments"] == 1      # the add is still in delta
    _assert_bitwise_vs_fresh(index, q, spec, params)


def test_delete_racing_compaction_is_folded_in(corpus, gated_build):
    db, q = corpus
    spec, params = FULL_RECALL["rpf"]
    started, release = gated_build
    index = _build_released(db, spec, release)
    t = index.compact(block=False)
    assert started.wait(60)
    index.delete([11, 13])
    release.set()
    t.join(60)
    ids = index.search(q, params)[1].numpy()
    assert not np.isin(ids, [11, 13]).any()
    st = index.stats()
    assert st["n_compactions"] == 1 and st["n_live"] == N_DB - 2
    assert st["n_tombstones"] == 2 and st["n_segments"] == 1
    _assert_bitwise_vs_fresh(index, q, spec, params)


def _build_released(db, spec, release):
    release.set()
    index = _build(db, spec)
    release.clear()
    return index


def test_compaction_refuses_a_second_one(corpus, gated_build):
    db, _ = corpus
    started, release = gated_build
    index = _build_released(db, FULL_RECALL["rpf"][0], release)
    t = index.compact(block=False)
    assert started.wait(60)
    with pytest.raises(RuntimeError, match="in progress"):
        index.compact()
    release.set()
    t.join(60)
    assert index.stats()["n_compactions"] == 1


def test_threaded_mutation_stress(corpus, tmp_path):
    db, q = corpus
    spec = tindex.IndexSpec(backend="rpf",
                            forest=tforest.ForestConfig(n_trees=4,
                                                        capacity=32),
                            delta_cap=16)
    index = _build(db, spec)
    errors: list = []
    stop = threading.Event()

    def writer(tid):
        try:
            rng = np.random.default_rng(tid)
            mine = []
            for j in range(24):
                mine.append(index.add(
                    np.abs(rng.normal(size=DIM)).astype(np.float32)))
                if j % 3 == 2:
                    index.delete(mine.pop(rng.integers(len(mine))))
                if j % 7 == 6:
                    index.upsert(mine[-1], np.abs(rng.normal(size=DIM)
                                                  ).astype(np.float32))
        except Exception as e:                       # pragma: no cover
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                _, i = index.search(q, tindex.SearchParams(k=3))
                assert i.shape == (len(q), 3)
        except Exception as e:                       # pragma: no cover
            errors.append(e)

    def saver():
        try:
            index.save(os.path.join(tmp_path, "stress"))
        except Exception as e:                       # pragma: no cover
            errors.append(e)

    writers = [threading.Thread(target=writer, args=(t,)) for t in range(3)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    saver_t = threading.Thread(target=saver)
    for t in writers + readers + [saver_t]:
        t.start()
    for t in writers + [saver_t]:
        t.join(120)
    index.compact()
    stop.set()
    for t in readers:
        t.join(120)
    assert not errors, errors
    st = index.stats()
    gids, _ = index.live_points()
    assert st["n_live"] == gids.shape[0] == N_DB + 3 * (24 - 8)
    assert np.unique(gids).size == gids.size
    live = set(gids.tolist())
    for g in index.search(q, tindex.SearchParams(k=5))[1].numpy().ravel():
        assert g == -1 or g in live
    path = os.path.join(tmp_path, "final")
    index.save(path)
    d0, i0 = _np(index.search(q, tindex.SearchParams(k=5)))
    d1, i1 = _np(tindex.load_index(path, device="cpu").search(
        q, tindex.SearchParams(k=5)))
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)


def test_delete_everything_then_readd(corpus):
    db, _ = corpus
    small = db[:16]
    index = _build(small, FULL_RECALL["rpf"][0])
    index.delete(list(range(16)))
    d, i = index.search(small[:2], tindex.SearchParams(k=3))
    assert (i == -1).all() and torch.isinf(d).all()
    index.compact()
    assert index.stats()["n_segments"] == 0
    assert index.live_points()[1].shape == (0, DIM)
    gid = index.add(small[0])
    assert int(index.search(small[:1], tindex.SearchParams(k=1))[1][0, 0]) \
        == gid


def test_pristine_index_goes_straight_to_its_engine(corpus, monkeypatch):
    """An index never mutated searches its one engine with no remap or
    merge: the same call the engine answers alone."""
    db, q = corpus
    spec, params = FULL_RECALL["rpf"]
    index = _build(db, spec)
    calls = []
    real = tindex.IndexView._merge
    monkeypatch.setattr(tindex.IndexView, "_merge", staticmethod(
        lambda *a: calls.append(1) or real(*a)))
    got = _np(index.search(q, params))
    want = _np(index.engine.search(torch.from_numpy(q), params))
    assert calls == []
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    index.delete(0)
    index.search(q, params)
    assert calls == [1]


# ---------------------------------------------------------------------------
# across packages: one op sequence on repro and repro_torch
# ---------------------------------------------------------------------------


def _reference_draws(key, cfg, n, d):
    rc = cfg.resolved(n)
    draws = jax.jit(jforest._batched_level_draws(
        jax.random.split(key, rc.n_trees), rc, d, "compat"))
    return lambda level: tuple(np.array(a) for a in draws(level))


def segment_draws(key, jcfg, dim):
    """The reference's stream of every build: key for sid 0 (the first
    build and compaction), fold_in(key, sid) for a seal."""
    return tindex.SegmentDraws(lambda sid, n: _reference_draws(
        key if sid == 0 else jax.random.fold_in(key, sid), jcfg, n, dim))


def _ops(index, rng_seed=11):
    """Adds past two seals, deletes everywhere, upserts, a compaction with
    more churn after it; returns the ids each step handed out."""
    rng = np.random.default_rng(rng_seed)
    rows = np.abs(rng.normal(size=(60, DIM))).astype(np.float32)
    out = [index.add(r) for r in rows[:40]]
    index.delete(list(range(1, 50, 4)) + out[3::5])
    out.append(index.upsert(9, rows[40]))
    out.append(index.upsert(out[7], rows[41]))
    yield out
    index.compact()
    out = [index.add(r) for r in rows[42:]]
    index.delete([0, out[2], 6])
    out.append(index.upsert(out[4], rows[0]))
    yield out


@pytest.mark.parametrize("backend", ["bruteforce", "rpf"])
def test_same_ops_give_the_same_index_in_both_packages(corpus, backend):
    db, q = corpus
    key = jax.random.key(4)
    jcfg = jforest.ForestConfig(n_trees=4, capacity=16)
    jspec = jindex.IndexSpec(backend=backend, forest=jcfg, delta_cap=16)
    tspec = tindex.IndexSpec(backend=backend,
                             forest=tforest.ForestConfig(n_trees=4,
                                                         capacity=16),
                             delta_cap=16)
    jidx = jindex.build_index(key, db, jspec)
    tidx = _build(db, tspec, draws=segment_draws(key, jcfg, DIM))
    _assert_same_search(jidx, tidx, q, {"k": 5})
    for jout, tout in zip(_ops(jidx), _ops(tidx)):
        assert jout == tout
        js, ts = jidx.stats(), tidx.stats()
        assert js == ts
        jg, jr = jidx.live_points()
        tg, tr = tidx.live_points()
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tr, jr)
        _assert_same_search(jidx, tidx, q, {"k": 5})
    _assert_same_search(jidx, tidx, q, {"k": 4, "n_probes": 2,
                                        "metric": "ip"})
    if backend == "rpf":
        assert ts["n_seals"] >= 2
        for name in tforest.Forest._fields:     # the compacted forest
            np.testing.assert_array_equal(
                getattr(tidx.forest, name).numpy(),
                np.asarray(getattr(jidx.forest, name)), err_msg=name)


def _assert_same_search(jidx, tidx, q, params):
    jd, ji = jidx.search(q, jindex.SearchParams(mode="ref", **params))
    td, ti = tidx.search(q, tindex.SearchParams(**params))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
