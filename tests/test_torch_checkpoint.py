"""Index checkpoints across the two packages.

The port writes and reads the reference's format-5 manifest (one ``.npy``
per leaf under the reference's leaf names, ``manifest.json``, written to
``<dir>.tmp`` then renamed): a manifest ``repro`` saved mid-mutation loads
into ``repro_torch`` and answers the same queries (ids equal, distances
within rtol 1e-5 / atol 1e-6), and the other way round; the same index
saved by both packages gives the same leaves bit for bit; the format-1
shim loads; manifests that carry metadata columns cross both ways and
answer filtered searches equal, and a format-4 shim drops the columns as
the reference's does; ``tuned_params`` with ``expand=0`` load and serve.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro import filter as jfilter
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import forest as jforest
from repro_torch import filter as tfilter
from repro_torch import index as tindex
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.core import forest as tforest

N_DB, DIM = 220, 12
RTOL, ATOL = 1e-5, 1e-6
FOREST = dict(n_trees=4, capacity=16)
SPECS = {
    "rpf": dict(backend="rpf"),
    "rpf+int8": dict(backend="rpf+int8"),
    "bruteforce": dict(backend="bruteforce"),
    "lsh-cascade": dict(backend="lsh-cascade", lsh_radii=(0.5, 1.0, 2.0),
                        lsh_tables=6, lsh_bits=6),
}
PARAMS = {"rpf": dict(k=5, n_probes=2), "rpf+int8": dict(k=5, expand=3),
          "bruteforce": dict(k=5), "lsh-cascade": dict(k=5,
                                                       min_candidates=30)}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    db = np.abs(rng.normal(size=(N_DB, DIM))).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = np.abs(db[:6] + 0.01 * rng.normal(size=(6, DIM)).astype(np.float32))
    return db, q


def _specs(backend, **kw):
    return (jindex.IndexSpec(forest=jforest.ForestConfig(**FOREST),
                             **SPECS[backend], **kw),
            tindex.IndexSpec(forest=tforest.ForestConfig(**FOREST),
                             **SPECS[backend], **kw))


def _mutate(index, seed=3):
    rng = np.random.default_rng(seed)
    added = [index.add(np.abs(rng.normal(size=DIM)).astype(np.float32))
             for _ in range(25)]
    index.delete(list(range(0, 40, 3)) + added[::4])
    index.upsert(7, np.abs(rng.normal(size=DIM)).astype(np.float32))
    return index


def _assert_same(tidx, jidx, q, **params):
    jd, ji = jidx.search(q, jindex.SearchParams(mode="ref", **params))
    td, ti = tidx.search(q, tindex.SearchParams(**params))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", sorted(SPECS))
def test_reference_manifest_loads_into_the_port(corpus, backend, tmp_path):
    db, q = corpus
    jspec, _ = _specs(backend)
    jidx = _mutate(jindex.build_index(jax.random.key(3), db, jspec))
    tuned = jindex.SearchParams(**PARAMS[backend])
    jidx.tuned_params = tuned
    jidx.shard_params = [tuned, dataclasses.replace(tuned, k=3)]
    jidx.serving_plan = {"plan": {"replicas": 2}, "traffic_model": None}
    path = str(tmp_path / "idx")
    jidx.save(path)
    tidx = tindex.load_index(path, device="cpu")
    jidx = jindex.load_index(path)     # session counters restart at load
    assert tidx.stats() == jidx.stats()
    assert tidx.stats()["n_segments"] == 3   # save sealed the delta
    for a, b in zip(tidx.live_points(), jidx.live_points()):
        np.testing.assert_array_equal(a, np.asarray(b))
    _assert_same(tidx, jidx, q, **PARAMS[backend])
    # tuned_params ride the manifest and apply on a bare search
    assert tidx.tuned_params.to_dict() == tuned.to_dict()
    assert [p.to_dict() for p in tidx.shard_params] == \
        [p.to_dict() for p in jidx.shard_params]
    assert tidx.serving_plan == jidx.serving_plan
    jd, ji = jidx.search(q, dataclasses.replace(tuned, mode="ref"))
    td, ti = tidx.search(q)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    # both keep mutating alike: ids continue past the saved ones
    assert tidx.add(db[0] * 0.5) == jidx.add(db[0] * 0.5)
    tidx.delete([1, 2])
    jidx.delete([1, 2])
    _assert_same(tidx, jidx, q, **PARAMS[backend])


@pytest.mark.parametrize("backend", ["rpf", "bruteforce"])
def test_port_manifest_loads_into_the_reference(corpus, backend, tmp_path):
    db, q = corpus
    _, tspec = _specs(backend)
    tidx = _mutate(tindex.build_index(db, tspec, device="cpu"))
    tidx.tuned_params = tindex.SearchParams(k=4, mode="kernel")
    path = str(tmp_path / "idx")
    tidx.save(path)
    jidx = jindex.load_index(path)
    back = tindex.load_index(path, device="cpu")
    assert jidx.stats() == back.stats()
    assert jidx.tuned_params.mode == "pallas"
    _assert_same(tidx, jidx, q, **PARAMS[backend])
    # a port index round-trips within the port bit for bit
    for params in (dict(k=5), dict(k=3, n_probes=3, metric="ip")):
        want = tidx.search(q, tindex.SearchParams(**params))
        got = back.search(q, tindex.SearchParams(**params))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert back.add(db[0]) == tidx.add(db[0])


def _leaves(path):
    ck = JCheckpointer(path)
    step_dir = os.path.join(path, f"step_{ck.latest_step():010d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = {leaf["name"]: np.load(os.path.join(
        step_dir, leaf["name"].replace("/", "__") + ".npy"))
        for leaf in manifest["leaves"]}
    return manifest, arrays


def test_both_packages_write_the_same_manifest(corpus, tmp_path):
    """The same ops under the same draws: equal leaves (names, shapes,
    dtypes, order and bits), extras and tree structure."""
    db, _ = corpus
    key = jax.random.key(4)
    jspec, tspec = _specs("rpf", seed=4)
    jcfg = jforest.ForestConfig(**FOREST)
    jidx = _mutate(jindex.build_index(key, db, jspec))
    tidx = _mutate(tindex.build_index(db, tspec, device="cpu",
                                      draws=tindex.SegmentDraws(
                                          lambda sid, n: _ref_draws(
                                              key if sid == 0 else
                                              jax.random.fold_in(key, sid),
                                              jcfg, n))))
    jidx.save(str(tmp_path / "j"))
    tidx.save(str(tmp_path / "t"))
    jm, ja = _leaves(str(tmp_path / "j"))
    tm, ta = _leaves(str(tmp_path / "t"))
    assert tm["leaves"] == jm["leaves"]
    assert tm["extra"] == jm["extra"]
    assert tm["treedef"] == jm["treedef"]
    assert tm["step"] == jm["step"] == 0
    for name, a in ja.items():
        np.testing.assert_array_equal(ta[name], a, err_msg=name)
        assert ta[name].dtype == a.dtype, name


def _ref_draws(key, cfg, n):
    rc = cfg.resolved(n)
    draws = jax.jit(jforest._batched_level_draws(
        jax.random.split(key, rc.n_trees), rc, DIM, "compat"))
    return lambda level: tuple(np.array(a) for a in draws(level))


def test_key_data_bits_survive_a_port_round_trip(corpus, tmp_path):
    db, _ = corpus
    key = jax.random.fold_in(jax.random.key(1), 7)   # arbitrary key words
    jspec, _ = _specs("bruteforce")
    jidx = jindex.build_index(key, db, jspec)
    jidx.save(str(tmp_path / "j"))
    tidx = tindex.load_index(str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(tidx.key_data,
                                  np.asarray(jax.random.key_data(key)))
    tidx.save(str(tmp_path / "t"))
    jm, ja = _leaves(str(tmp_path / "j"))
    tm, ta = _leaves(str(tmp_path / "t"))
    assert tm["leaves"] == jm["leaves"] and tm["extra"] == jm["extra"]
    for name, a in ja.items():
        np.testing.assert_array_equal(ta[name], a, err_msg=name)
    assert int(tindex.build_index(db, _specs("rpf", seed=9)[1],
                                  device="cpu").key_data[1]) == 9


def test_v1_checkpoint_read_shim(corpus, tmp_path):
    """A format-1 checkpoint (flat {db, key_data, forest}) written by the
    reference loads into the port, answers the same and mutates."""
    db, q = corpus
    jspec, _ = _specs("rpf")
    jidx = jindex.build_index(jax.random.key(0), db, jspec)
    path = str(tmp_path / "v1")
    JCheckpointer(path, keep=1).save(
        0, {"db": jidx.db, "key_data": jax.random.key_data(jidx.key),
            "forest": jidx.forest},
        extra={"spec": jspec.to_dict(), "backend": "rpf"})
    tidx = tindex.load_index(path, device="cpu")
    assert tidx.stats()["n_segments"] == 1
    _assert_same(tidx, jidx, q, k=5, n_probes=2)
    tidx.delete(0)
    assert 0 not in tidx.search(q, k=5)[1].numpy().ravel().tolist()
    bspec = _specs("bruteforce")[0]
    JCheckpointer(str(tmp_path / "v1b"), keep=1).save(
        0, {"db": db, "key_data": jax.random.key_data(jax.random.key(0))},
        extra={"spec": bspec.to_dict(), "backend": "bruteforce"})
    _assert_same(tindex.load_index(str(tmp_path / "v1b"), device="cpu"),
                 jindex.load_index(str(tmp_path / "v1b")), q, k=5)


def test_save_writes_to_tmp_then_renames(corpus, tmp_path, monkeypatch):
    """A write that dies part-way leaves the last good checkpoint as it
    was; the half-written ``.tmp`` directory is never read."""
    db, q = corpus
    _, tspec = _specs("rpf")
    tidx = tindex.build_index(db, tspec, device="cpu")
    path = str(tmp_path / "idx")
    step_dir = tidx.save(path)
    assert sorted(os.listdir(path)) == ["step_0000000000"]
    want = tidx.search(q, k=5)
    tidx.delete([0, 1, 2])
    real_save, calls = np.save, []

    def dying_save(f, a, *args, **kw):
        calls.append(f)
        if len(calls) == 3:
            raise OSError("disk full")
        return real_save(f, a, *args, **kw)

    monkeypatch.setattr(tckpt.np, "save", dying_save)
    with pytest.raises(OSError, match="disk full"):
        tidx.save(path)
    monkeypatch.setattr(tckpt.np, "save", real_save)
    assert all(os.path.dirname(f) == step_dir + ".tmp" for f in calls)
    assert sorted(os.listdir(path)) == ["step_0000000000",
                                        "step_0000000000.tmp"]
    old = tindex.load_index(path, device="cpu")
    assert old.stats()["n_tombstones"] == 0
    for a, b in zip(old.search(q, k=5), want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    tidx.save(path)
    assert sorted(os.listdir(path)) == ["step_0000000000"]
    assert tindex.load_index(path, device="cpu").stats()[
        "n_tombstones"] == 3


def _meta(n):
    return {"color": np.array(["red", "blue", "green"])[np.arange(n) % 3],
            "price": (np.arange(n) * 7 % 50).astype(np.int64),
            "ts": np.int64(1_700_000_000_000_000_000) + np.arange(n)}


def _mutate_meta(index, seed=3):
    """``_mutate`` with metadata on every added and upserted row."""
    rng = np.random.default_rng(seed)
    added = [index.add(np.abs(rng.normal(size=DIM)).astype(np.float32),
                       metadata={"color": ["red", "teal"][i % 2],
                                 "price": i,
                                 "ts": 2_000_000_000_000_000_000 + i})
             for i in range(25)]
    index.delete(list(range(0, 40, 3)) + added[::4])
    index.upsert(7, np.abs(rng.normal(size=DIM)).astype(np.float32),
                 metadata={"color": "teal", "price": 3,
                           "ts": 2_100_000_000_000_000_000})
    return index


def _filters(pkg):
    return [pkg.Eq("color", "teal"),
            pkg.And(pkg.In("color", ("red", "blue")),
                    pkg.Range("price", 10, 30)),
            pkg.Range("ts", lo=1_700_000_000_000_000_100,
                      hi=2_000_000_000_000_000_010)]


def _assert_same_filtered(tidx, jidx, q, **params):
    for jf, tf in zip(_filters(jfilter), _filters(tfilter)):
        jd, ji = jidx.search(q, jindex.SearchParams(mode="ref", filter=jf,
                                                    **params))
        td, ti = tidx.search(q, tindex.SearchParams(filter=tf, **params))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("backend", ["bruteforce", "rpf"])
def test_metadata_manifest_loads_into_the_port(corpus, backend, tmp_path):
    """A reference manifest with metadata columns loads into the port and
    answers filtered and unfiltered searches as the reference does."""
    db, q = corpus
    jspec, _ = _specs(backend)
    jidx = _mutate_meta(jindex.build_index(jax.random.key(0), db, jspec,
                                           metadata=_meta(N_DB)))
    jidx.tuned_params = jindex.SearchParams(k=4, filter=jfilter.Eq(
        "color", "red"))
    path = str(tmp_path / "meta")
    jidx.save(path)
    tidx = tindex.load_index(path, device="cpu")
    jidx = jindex.load_index(path)
    assert tidx.stats() == jidx.stats()
    assert tidx.meta_store.to_json() == jidx.meta_store.to_json()
    for seg_t, seg_j in zip(tidx.snapshot().segments,
                            jidx.snapshot().segments):
        for c in ("color", "price", "ts"):
            np.testing.assert_array_equal(seg_t.meta.column(c),
                                          seg_j.meta.column(c))
            assert seg_t.meta.column(c).dtype == seg_j.meta.column(c).dtype
    _assert_same(tidx, jidx, q, **PARAMS[backend])
    _assert_same_filtered(tidx, jidx, q, **PARAMS[backend])
    # the tuned filter rides the manifest as a port predicate
    assert tidx.tuned_params.filter == tfilter.Eq("color", "red")
    jd, ji = jidx.search(q, jindex.SearchParams(
        k=4, mode="ref", filter=jfilter.Eq("color", "red")))
    td, ti = tidx.search(q)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    # both keep mutating alike, with metadata
    m = {"color": "teal", "price": 1, "ts": 5}
    assert tidx.add(db[0] * 0.5, metadata=m) == jidx.add(db[0] * 0.5,
                                                        metadata=m)
    _assert_same_filtered(tidx, jidx, q, **PARAMS[backend])


@pytest.mark.parametrize("backend", ["bruteforce", "rpf"])
def test_port_metadata_manifest_loads_into_the_reference(corpus, backend,
                                                         tmp_path):
    db, q = corpus
    _, tspec = _specs(backend)
    tidx = _mutate_meta(tindex.build_index(db, tspec, device="cpu",
                                           metadata=_meta(N_DB)))
    path = str(tmp_path / "meta")
    tidx.save(path)
    jidx = jindex.load_index(path)
    back = tindex.load_index(path, device="cpu")
    assert jidx.stats() == back.stats()
    _assert_same(tidx, jidx, q, **PARAMS[backend])
    _assert_same_filtered(tidx, jidx, q, **PARAMS[backend])
    # within the port, filtered answers survive save / load bit for bit
    for tf in _filters(tfilter):
        want = tidx.search(q, tindex.SearchParams(k=5, filter=tf))
        got = back.search(q, tindex.SearchParams(k=5, filter=tf))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def _step_manifest(path):
    step_dir = os.path.join(path, "step_0000000000")
    return os.path.join(step_dir, "manifest.json")


def test_v4_shim_drops_metadata(corpus, tmp_path):
    """A metadata manifest rewritten as a format-4 writer would have left it
    (no ``meta_schema``) loads in both packages without the columns:
    unfiltered searches as before, a filter refused for want of metadata."""
    db, q = corpus
    jspec, _ = _specs("rpf")
    jidx = jindex.build_index(jax.random.key(0), db, jspec,
                              metadata=_meta(N_DB))
    path = str(tmp_path / "v4")
    jidx.save(path)
    with open(_step_manifest(path)) as f:
        man = json.load(f)
    man["extra"]["format"] = 4
    man["extra"].pop("meta_schema")
    with open(_step_manifest(path), "w") as f:
        json.dump(man, f)
    tidx = tindex.load_index(path, device="cpu")
    legacy = jindex.load_index(path)
    assert tidx.meta_store is None and legacy.meta_store is None
    assert tidx.stats() == legacy.stats()
    assert tidx.stats()["metadata_columns"] == []
    _assert_same(tidx, legacy, q, k=5, n_probes=2)
    with pytest.raises(ValueError, match="no metadata"):
        tidx.search(q, tindex.SearchParams(k=5, filter=tfilter.Eq(
            "color", "red")))
    with pytest.raises(ValueError, match="no metadata"):
        tidx.add(db[0], metadata={"color": "red"})


@pytest.mark.parametrize("backend", ["rpf", "bruteforce"])
def test_expand_zero_tuned_params_load_and_serve(corpus, backend, tmp_path):
    """Fault 6: a reference manifest tuned at expand=0 loads into the port,
    and its bare search answers as the reference's."""
    db, q = corpus
    jspec, _ = _specs(backend)
    jidx = jindex.build_index(jax.random.key(3), db, jspec)
    jidx.tuned_params = jindex.SearchParams(k=3, expand=0)
    path = str(tmp_path / "e0")
    jidx.save(path)
    tidx = tindex.load_index(path, device="cpu")
    assert tidx.tuned_params.expand == 0
    jd, ji = jidx.search(q)
    td, ti = tidx.search(q)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)


def test_checkpointer_flattens_as_the_reference(tmp_path):
    f = tforest.Forest(*(np.arange(i + 1, dtype=np.int32)
                         for i in range(8)))
    tree = {"b": {"z": np.ones(2, np.float32), "a": f},
            "a": [np.zeros(1, bool), np.int32(3)]}
    names = [n for n, _ in tckpt.flatten_with_names(tree)]
    jtree = {"b": {"z": np.ones(2, np.float32),
                   "a": jforest.Forest(*f)},
             "a": [np.zeros(1, bool), np.int32(3)]}
    from repro.checkpoint.checkpointer import _flatten_with_names
    assert names == [n for n, _ in _flatten_with_names(jtree)]
    assert tckpt.treedef_str(tree) == str(
        jax.tree_util.tree_structure(jtree))
    ck = tckpt.Checkpointer(str(tmp_path / "c"))
    ck.save(5, tree, extra={"x": 1})
    back, step = ck.restore(tree)
    assert step == 5 and isinstance(back["b"]["a"], tforest.Forest)
    for (n, a), (_, b) in zip(tckpt.flatten_with_names(back),
                              tckpt.flatten_with_names(tree)):
        np.testing.assert_array_equal(a, b, err_msg=n)
        assert a.dtype == np.asarray(b).dtype, n
