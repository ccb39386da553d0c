"""The port's filtered search against the reference: predicates, metadata
columns, the two regimes of ``IndexView._search_filtered`` and the
metadata's lifecycle.

``repro_torch.filter`` is a numpy copy of ``repro.filter``: encodings,
match bitmaps, the predicates' tagged dicts, ``use_brute_force`` and
``widen_params`` must be the reference's exactly.  Filtered searches run
on both packages over the same rows and columns (the port's forests under
the reference's draws) and must give the reference's ids, with distances
within rtol 1e-5 / atol 1e-6, in the brute regime (few matches: an exact
scan of the matching rows) and in the widened regime (forced at this size
by lowering the thresholds in both packages alike).
"""
import jax
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro import filter as jfilter
from repro.core import forest as jforest
from repro.data.synthetic import clustered_gaussians
from repro.filter import metadata as jmeta
from repro.filter import predicate as jpred
from repro_torch import filter as tfilter
from repro_torch import index as tindex
from repro_torch.core import forest as tforest
from repro_torch.filter import metadata as tmeta
from repro_torch.filter import predicate as tpred

N, D = 600, 16
RTOL, ATOL = 1e-5, 1e-6
BACKENDS = ["bruteforce", "rpf", "rpf+int8", "lsh-cascade"]
LSH = dict(lsh_radii=(0.5, 1.0, 2.0), lsh_tables=8, lsh_bits=8)
JCFG = jforest.ForestConfig(n_trees=10, capacity=16)
TCFG = tforest.ForestConfig(n_trees=10, capacity=16)
TS0 = 1_700_000_000_000_000_000


def _corpus(n=N):
    db = np.abs(clustered_gaussians(n, D, n_clusters=12, seed=0))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    rng = np.random.default_rng(1)
    q = np.abs(db[:8] + 0.003 * rng.normal(size=(8, D)).astype(np.float32))
    meta = {"shop": np.array([f"s{i % 5}" for i in range(n)]),
            "price": (np.arange(n) * 7 % 100).astype(np.int64),
            "ts": np.int64(TS0) + np.arange(n)}
    return db.astype(np.float32), q, meta


def _reference_draws(key, n):
    rc = JCFG.resolved(n)
    draws = jax.jit(jforest._batched_level_draws(
        jax.random.split(key, rc.n_trees), rc, D, "compat"))
    return lambda level: tuple(np.array(a) for a in draws(level))


def _indexes(backend, db, meta, **spec_kw):
    key = jax.random.key(0)
    jidx = jindex.build_index(key, db, jindex.IndexSpec(
        backend=backend, forest=JCFG, **LSH, **spec_kw), metadata=meta)
    tidx = tindex.build_index(
        db, tindex.IndexSpec(backend=backend, forest=TCFG, **LSH, **spec_kw),
        device="cpu", metadata=meta,
        draws=tindex.SegmentDraws(lambda sid, n: _reference_draws(
            key if sid == 0 else jax.random.fold_in(key, sid), n)))
    return jidx, tidx


def _both(pred_dict):
    """The reference's and the port's predicate from one tagged dict."""
    return jpred.from_dict(pred_dict), tpred.from_dict(pred_dict)


def _assert_same(tidx, jidx, q, pred_dict, **params):
    jp, tp = _both(pred_dict)
    jd, ji = jidx.search(q, jindex.SearchParams(mode="ref", filter=jp,
                                                **params))
    td, ti = tidx.search(q, tindex.SearchParams(filter=tp, **params))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    return td.numpy(), ti.numpy()


PREDICATES = [
    {"op": "eq", "column": "shop", "value": "s2"},
    {"op": "and", "children": [
        {"op": "in", "column": "shop", "values": ["s0", "s3"]},
        {"op": "range", "column": "price", "lo": 20, "hi": 60}]},
    {"op": "or", "children": [{"op": "eq", "column": "price", "value": 7},
                              {"op": "eq", "column": "price", "value": 14}]},
    {"op": "not", "child": {"op": "eq", "column": "shop", "value": "s1"}},
    {"op": "range", "column": "ts", "lo": TS0 + 100, "hi": TS0 + 400},
]


# ---------------------------------------------------------------------------
# predicates and columns
# ---------------------------------------------------------------------------


def _random_predicate(rng, depth=2):
    roll = rng.integers(0, 6 if depth > 0 else 4)
    if roll == 0:
        return {"op": "eq", "column": "cat",
                "value": str(rng.choice(["a", "b", "c", "zzz"]))}
    if roll == 1:
        return {"op": "in", "column": "price", "values": [
            int(v) for v in rng.integers(0, 31, rng.integers(1, 4))]}
    if roll == 2:
        lo = int(rng.integers(0, 16))
        return {"op": "range", "column": "price", "lo": lo,
                "hi": int(rng.integers(lo, 31))}
    if roll == 3:
        lo = TS0 + int(rng.integers(0, 200))
        return {"op": "range", "column": "ts", "lo": lo,
                "hi": None if rng.integers(0, 2) else lo + 50}
    kids = [_random_predicate(rng, depth - 1) for _ in range(2)]
    if roll == 4:
        return {"op": rng.choice(["and", "or"]), "children": kids}
    return {"op": "not", "child": kids[0]}


def test_encodings_and_bitmaps_match_reference():
    for trial in range(30):
        rng = np.random.default_rng(trial)
        n = int(rng.integers(20, 300))
        meta = {"cat": rng.choice(["a", "b", "c"], n),
                "price": rng.integers(0, 31, n).astype(np.int64),
                "ts": np.int64(TS0) + rng.integers(0, 300, n)}
        jstore, jblock = jmeta.MetadataStore.from_arrays(meta, n)
        tstore, tblock = tmeta.MetadataStore.from_arrays(meta, n)
        assert tstore.to_json() == jstore.to_json()
        for c in meta:
            np.testing.assert_array_equal(tblock.column(c),
                                          jblock.column(c))
            assert tblock.column(c).dtype == jblock.column(c).dtype
        # timestamps near 1.7e18 stay int64 end to end, no float
        assert tblock.column("ts").dtype == np.int64
        assert int(tblock.column("ts").min()) >= TS0
        for _ in range(5):
            pd = _random_predicate(rng)
            jp, tp = _both(pd)
            got = tblock.match(tp, tstore)
            np.testing.assert_array_equal(got, jblock.match(jp, jstore))
            assert got.dtype == bool and tblock.match(tp, tstore) is got
            assert tp.to_dict() == jp.to_dict()
            assert tp.columns() == jp.columns()
            assert hash(tp) == hash(tpred.from_dict(tp.to_dict()))


def test_predicate_dicts_cross_both_ways():
    for pd in PREDICATES:
        jp, tp = _both(pd)
        assert tpred.from_dict(jp.to_dict()) == tp
        assert jpred.from_dict(tp.to_dict()) == jp
        # through SearchParams' dicts too
        tsp = tindex.SearchParams(k=3, filter=tp)
        jsp = jindex.SearchParams.from_dict(tsp.to_dict())
        assert jsp.filter == jp
        assert tindex.SearchParams.from_dict(jsp.to_dict()) == tsp
    with pytest.raises(ValueError, match="unknown predicate op"):
        tpred.from_dict({"op": "xor"})
    with pytest.raises(ValueError, match="at least one bound"):
        tfilter.Range("price")
    with pytest.raises(TypeError):
        tfilter.And()


def test_metadata_store_edges_match_reference():
    for mod in (jmeta, tmeta):
        store, block = mod.MetadataStore.from_arrays(
            {"c": np.array(["x", "y", "x"]),
             "t": np.array(["2024-01-01", "2024-01-02", "2024-01-03"],
                           "datetime64[ns]")}, 3)
        assert store.columns == {"c": "categorical", "t": "timestamp"}
        assert store.encode_value("c", "zzz") == -1
        assert store.encode_point({"c": "z", "t": 5}) == {"c": 2, "t": 5}
        with pytest.raises(ValueError, match="cover the schema"):
            store.encode_point({"c": "x"})
        with pytest.raises(ValueError, match="not ordered"):
            mod.MetaBlock(block.cols).match(
                (jpred if mod is jmeta else tpred).Range("c", "a"), store)
        parts = [block.take(np.array([2, 0])), block.take(np.array([1]))]
        cat = mod.MetaBlock.concat(parts)
        np.testing.assert_array_equal(cat.column("c"), [0, 0, 1])
    assert tfilter.KINDS == jfilter.KINDS


def test_use_brute_force_and_widen_params_match_reference():
    assert (tpred.BRUTE_FORCE_SELECTIVITY, tpred.BRUTE_FORCE_MAX_ROWS,
            tpred.MAX_PROBES) == (jpred.BRUTE_FORCE_SELECTIVITY,
                                  jpred.BRUTE_FORCE_MAX_ROWS,
                                  jpred.MAX_PROBES)
    for s in (1e-9, 0.001, 0.01, 0.05, 0.0500001, 0.1, 0.3, 0.5, 0.99, 1.0,
              1.5):
        for n_match in (0, 10, 4096, 4097, 100_000):
            assert tpred.use_brute_force(s, n_match) == \
                jpred.use_brute_force(s, n_match)
        for kw in (dict(), dict(k=3, n_probes=4, n_trees=5),
                   dict(min_candidates=50, probe_schedule=6)):
            got = tpred.widen_params(tindex.SearchParams(**kw), s)
            want = jpred.widen_params(jindex.SearchParams(**kw), s)
            assert got.to_dict() == want.to_dict(), (s, kw)


# ---------------------------------------------------------------------------
# filtered search, both regimes, every backend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    db, q, meta = _corpus()
    return db, q, meta, {b: _indexes(b, db, meta) for b in BACKENDS}


def _params(backend):
    return dict(k=5, min_candidates=64) if backend == "lsh-cascade" else \
        dict(k=5, n_probes=2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_filtered_search_brute_regime_matches_reference(built, backend):
    db, q, meta, idx = built
    jidx, tidx = idx[backend]
    for pd in PREDICATES:
        for metric in ("l2", "cosine"):
            _, ids = _assert_same(tidx, jidx, q, pd, metric=metric,
                                  **_params(backend))
            match = tidx.snapshot().filter_match_live(tpred.from_dict(pd))
            assert bool(match[ids[ids >= 0]].all())


@pytest.mark.parametrize("backend", BACKENDS)
def test_filtered_search_widened_regime_matches_reference(built, backend,
                                                          monkeypatch):
    db, q, meta, idx = built
    jidx, tidx = idx[backend]
    for mod in (jpred, tpred):
        monkeypatch.setattr(mod, "BRUTE_FORCE_MAX_ROWS", 0)
        monkeypatch.setattr(mod, "BRUTE_FORCE_SELECTIVITY", 0.0)
    assert not tpred.use_brute_force(0.2, 120)
    for pd in PREDICATES:
        _, ids = _assert_same(tidx, jidx, q, pd, **_params(backend))
        match = tidx.snapshot().filter_match_live(tpred.from_dict(pd))
        got = ids[ids >= 0]
        assert bool(match[got].all())
        for row in ids:
            row = row[row >= 0]
            assert len(set(row.tolist())) == row.size


def test_empty_match_returns_empty(built):
    db, q, meta, idx = built
    for backend in BACKENDS:
        jidx, tidx = idx[backend]
        d, ids = _assert_same(tidx, jidx, q, {"op": "eq", "column": "shop",
                                              "value": "nope"}, k=5)
        assert (ids == -1).all() and np.isinf(d).all()


def test_unfiltered_search_on_a_metadata_index_is_unchanged(built):
    db, q, _, idx = built
    plain = tindex.build_index(db, tindex.IndexSpec(backend="bruteforce"),
                               device="cpu")
    _, tidx = idx["bruteforce"]
    for a, b in zip(tidx.search(q, k=5), plain.search(q, k=5)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# the metadata's lifecycle
# ---------------------------------------------------------------------------


def _lifecycle(index, db):
    """Adds past a seal (delta_cap 16), deletes everywhere, upserts, a
    flush and a compaction, with metadata on every new row."""
    rng = np.random.default_rng(7)
    new = []
    for i in range(40):
        v = np.abs(rng.normal(size=D)).astype(np.float32)
        v /= np.linalg.norm(v)
        new.append(index.add(v, metadata={"shop": "s9", "price": 1000 + i,
                                          "ts": 2 * TS0 + i}))
    index.delete([new[0], new[21], 3, 8, 13])
    index.upsert(new[1], np.abs(db[0]),
                 metadata={"shop": "s9", "price": 5000, "ts": 2 * TS0})
    index.upsert(10, np.abs(db[1]),
                 metadata={"shop": "s7", "price": 1, "ts": TS0})
    yield "mutated"
    index.flush()
    yield "flushed"
    index.compact()
    yield "compacted"


LIFECYCLE = [
    {"op": "eq", "column": "shop", "value": "s9"},
    {"op": "in", "column": "shop", "values": ["s7", "s1"]},
    {"op": "range", "column": "price", "lo": 1000, "hi": 1020},
    {"op": "range", "column": "ts", "lo": 2 * TS0 + 5},
    {"op": "not", "child": {"op": "eq", "column": "shop", "value": "s9"}},
]


@pytest.mark.parametrize("backend", ["rpf", "bruteforce"])
def test_metadata_lifecycle_matches_reference(backend):
    db, q, meta = _corpus(300)
    jidx, tidx = _indexes(backend, db, meta, delta_cap=16)
    for jstep, tstep in zip(_lifecycle(jidx, db), _lifecycle(tidx, db)):
        assert jstep == tstep
        assert tidx.stats() == jidx.stats(), tstep
        jv, tv = jidx.snapshot(), tidx.snapshot()
        for pd in LIFECYCLE:
            jp, tp = _both(pd)
            np.testing.assert_array_equal(tv.filter_match_live(tp),
                                          jv.filter_match_live(jp))
            _assert_same(tidx, jidx, q, pd, k=5)
        for seg_t, seg_j in zip(tv.segments, jv.segments):
            for c in meta:
                np.testing.assert_array_equal(seg_t.meta.column(c),
                                              seg_j.meta.column(c))
    assert tidx.stats()["n_segments"] == 1
    assert tidx.stats()["metadata_columns"] == ["price", "shop", "ts"]
    assert tidx.meta_store.to_json() == jidx.meta_store.to_json()


def test_add_without_metadata_on_a_metadata_index_raises():
    db, q, meta = _corpus(100)
    _, tidx = _indexes("bruteforce", db, meta)
    before = tidx.stats()
    with pytest.raises(ValueError, match="cover the schema"):
        tidx.add(db[0])
    with pytest.raises(ValueError, match="cover the schema"):
        tidx.upsert(3, db[0], metadata={"shop": "s1"})
    assert tidx.stats() == before
    plain = tindex.build_index(db, tindex.IndexSpec(backend="bruteforce"),
                               device="cpu")
    with pytest.raises(ValueError, match="no metadata"):
        plain.add(db[0], metadata={"shop": "s1"})
    with pytest.raises(tindex.CapabilityError, match="no metadata"):
        plain.search(q, tindex.SearchParams(filter=tfilter.Eq("shop", "s1")))
    with pytest.raises(ValueError, match="no metadata"):
        plain.snapshot().filter_match_live(tfilter.Eq("shop", "s1"))
    with pytest.raises(ValueError, match="must match the schema"):
        tindex.build_index(db, tindex.IndexSpec(backend="bruteforce"),
                           device="cpu", metadata={"shop": meta["shop"]},
                           meta_schema=None).meta_store.make_block(
                               {"nope": meta["shop"]}, 100)


def test_filter_masks_are_cached_per_segment_and_predicate(built):
    db, q, meta, idx = built
    _, tidx = idx["rpf"]
    seg = tidx.snapshot().segments[0]
    p = tfilter.Eq("shop", "s3")
    tidx.search(q, tindex.SearchParams(k=5, filter=p))
    n, mask = seg.filter_valid(p, tidx.meta_store)
    assert seg.filter_valid(p, tidx.meta_store)[1] is mask
    assert mask.dtype == torch.bool and n == N // 5
    assert seg.meta.match(p, tidx.meta_store) is seg.meta.match(
        tfilter.Eq("shop", "s3"), tidx.meta_store)
