"""The small modules the port copies from the reference: ``pairwise``,
``query_forest`` / ``query_forest_quantized``, ``forest_stats``,
``clustered_gaussians``, ``IncrementalForest`` and
``available_backends``, each held against the reference's on the same
inputs (forests under the reference's draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro.core import distances as jdist
from repro.core import forest as jforest
from repro.core import quantized as jquant
from repro.core.forest_incremental import IncrementalForest as JIncremental
from repro.data import synthetic as jsynth
from repro_torch import index as tindex
from repro_torch.core import distances as tdist
from repro_torch.core import forest as tforest
from repro_torch.core import quantized as tquant
from repro_torch.core.forest_incremental import IncrementalForest
from repro_torch.data import synthetic as tsynth

N, D = 400, 16
RTOL, ATOL = 1e-5, 1e-6
CFG = dict(n_trees=6, capacity=10)


@pytest.fixture(scope="module")
def carried():
    db = jsynth.clustered_gaussians(N, D, n_clusters=8, seed=2)
    rng = np.random.default_rng(3)
    q = (db[rng.integers(0, N, 9)] + 0.3 * rng.normal(size=(9, D))
         ).astype(np.float32)
    jcfg = jforest.ForestConfig(**CFG)
    key = jax.random.key(5)
    jf = jforest.build_forest(key, jnp.asarray(db), jcfg)
    rc = jcfg.resolved(N)
    draws = jax.jit(jforest._batched_level_draws(
        jax.random.split(key, rc.n_trees), rc, D, "compat"))
    tf = tforest.build_forest(
        torch.from_numpy(db), tforest.ForestConfig(**CFG),
        draws=lambda level: tuple(np.array(a) for a in draws(level)),
        device="cpu")
    return db, q, jf, tf


@pytest.mark.parametrize("metric", ["l2", "chi2", "dot", "cosine"])
def test_pairwise_matches_reference(metric):
    rng = np.random.default_rng(1)
    q = np.abs(rng.normal(size=(7, D))).astype(np.float32)
    db = np.abs(rng.normal(size=(30, D))).astype(np.float32)
    got = tdist.pairwise(torch.from_numpy(q), torch.from_numpy(db), metric)
    want = jdist.pairwise(jnp.asarray(q), jnp.asarray(db), metric=metric)
    assert set(tdist.PAIRWISE) == set(jdist.PAIRWISE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_forest_stats_match_reference(carried):
    db, _, jf, tf = carried
    got = tforest.forest_stats(tf, tforest.ForestConfig(**CFG), N)
    want = jforest.forest_stats(jf, jforest.ForestConfig(**CFG), N)
    assert got == want
    assert got["occ_max"] <= CFG["capacity"]


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_query_forest_matches_reference(carried, metric):
    db, q, jf, tf = carried
    cfg = tforest.ForestConfig(**CFG)
    got = tforest.query_forest(tf, torch.from_numpy(q), torch.from_numpy(db),
                               5, cfg, metric=metric, device="cpu")
    want = jforest.query_forest(jf, jnp.asarray(q), jnp.asarray(db), 5,
                                jforest.ForestConfig(**CFG), metric=metric,
                                mode="ref")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


def test_query_forest_quantized_matches_reference(carried):
    db, q, jf, tf = carried
    got = tquant.query_forest_quantized(
        tf, torch.from_numpy(q), tquant.quantize_db(torch.from_numpy(db)), 4,
        tforest.ForestConfig(**CFG), expand=3, device="cpu")
    want = jquant.query_forest_quantized(
        jf, jnp.asarray(q), jquant.quantize_db(jnp.asarray(db)), 4,
        jforest.ForestConfig(**CFG), expand=3, mode="ref")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(n=500, d=24), dict(
    n=77, d=5, n_clusters=3, cluster_std=0.5, seed=9)])
def test_clustered_gaussians_is_the_reference_bitwise(kw):
    got = tsynth.clustered_gaussians(**kw)
    want = jsynth.clustered_gaussians(**kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_incremental_forest_retrieves_as_the_reference():
    x = jsynth.clustered_gaussians(300, 8, n_clusters=6, seed=4)
    ours = IncrementalForest(x, n_trees=3, capacity=9, n_proj=2, seed=1)
    theirs = JIncremental(x, n_trees=3, capacity=9, n_proj=2, seed=1)
    for qi in range(0, 300, 37):
        np.testing.assert_array_equal(np.sort(ours.retrieve(x[qi])),
                                      np.sort(theirs.retrieve(x[qi])))
        for a, b in zip(ours.query(x[qi], 4), theirs.query(x[qi], 4)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.trees, theirs.trees):
        assert a.depth_stats() == b.depth_stats()
        assert sorted(p for leaf in a.leaves() for p in leaf.points) == \
            list(range(300))


def test_available_backends_match_reference():
    assert tindex.available_backends() == jindex.available_backends()
