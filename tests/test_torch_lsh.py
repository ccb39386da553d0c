"""The port's ``lsh-cascade`` backend held against the reference's.

``repro_torch.core.lsh`` is a numpy copy of ``repro.core.lsh``, so its
projections, buckets and padded candidate matrices are bitwise equal to the
reference's; the rerank is the fused rerank stage, so the answers carry the
usual tolerance: ids equal, distances within rtol 1e-5 / atol 1e-6 (XLA and
PyTorch sum the d terms in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro.core import lsh as jlsh
from repro.data.synthetic import clustered_gaussians
from repro_torch import convert
from repro_torch import index as tindex
from repro_torch.core import lsh as tlsh
from repro_torch.kernels.common import REF_CALLS

RTOL, ATOL = 1e-5, 1e-6
N, D = 1500, 24
LSH = dict(lsh_radii=(0.5, 1.0, 2.0), lsh_tables=8, lsh_bits=8, seed=0)


@pytest.fixture(scope="module")
def corpus():
    db = np.abs(clustered_gaussians(N, D, n_clusters=16, seed=11))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    rng = np.random.default_rng(5)
    q = np.abs(db[:17] + 0.02 * rng.normal(size=(17, D))).astype(np.float32)
    return db.astype(np.float32), q


@pytest.fixture(scope="module")
def indexes(corpus):
    db, _ = corpus
    jidx = jindex.build_index(None, db, jindex.IndexSpec(
        backend="lsh-cascade", **LSH))
    tidx = tindex.build_index(db, tindex.IndexSpec(
        backend="lsh-cascade", **LSH), device="cpu")
    return jidx, tidx


def _assert_same(got, want):
    gd, gi = (t.numpy() for t in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("min_candidates", [1, 30, 10**9])
def test_retrieve_batch_matches_reference(corpus, min_candidates):
    db, q = corpus
    kw = dict(n_tables=6, n_bits=8, width_scale=1.0, seed=3)
    mine = tlsh.CascadedLSH(db, [0.5, 1.0, 2.0], **kw)
    ref = jlsh.CascadedLSH(db, [0.5, 1.0, 2.0], **kw)
    for a, b in zip(mine.levels, ref.levels):
        assert np.array_equal(a.a, b.a) and np.array_equal(a.b, b.b)
        assert a.tables == b.tables
    ids, mask = mine.retrieve_batch(q, min_candidates)
    want_ids, want_mask = ref.retrieve_batch(q, min_candidates)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    assert mask.any(axis=1).all()


def test_pad_candidate_lists_matches_reference():
    lists = [[4, 9], [], list(range(70))]
    for got, want in zip(tlsh.pad_candidate_lists(lists, 32),
                         jlsh.pad_candidate_lists(lists, 32)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", [
    dict(k=5), dict(k=5, min_candidates=40), dict(k=7, metric="chi2"),
    dict(k=5, chunk=16)])
def test_lsh_index_matches_reference(corpus, indexes, params):
    _, q = corpus
    jidx, tidx = indexes
    want = jidx.search(jnp.asarray(q), jindex.SearchParams(**params))
    got = tidx.search(q, tindex.SearchParams(**params))
    _assert_same(got, want)
    assert tidx.last_mean_candidates == jidx._primary_engine \
        .last_mean_candidates


def test_lsh_engine_valid_mask_matches_reference(corpus, indexes):
    """Dead rows (tombstones) never surface, on both packages."""
    _, q = corpus
    jidx, tidx = indexes
    valid = np.random.default_rng(2).uniform(size=N) > 0.4
    params = dict(k=6, min_candidates=50)
    want = jidx._primary_engine.search(
        jnp.asarray(q), jindex.SearchParams(**params),
        valid=jnp.asarray(valid))
    got = tidx.engine.search(torch.from_numpy(q),
                             tindex.SearchParams(**params),
                             valid=torch.from_numpy(valid))
    _assert_same(got, want)
    live = got[1].numpy()
    assert valid[live[live >= 0]].all()


def test_reference_lsh_index_carried_across(corpus, indexes):
    db, q = corpus
    jidx, _ = indexes
    spec = tindex.IndexSpec(backend="lsh-cascade", **LSH)
    carried = convert.index_from_numpy(np.asarray(jidx._primary_engine.db),
                                       None, spec, device="cpu")
    assert carried.backend == "lsh-cascade"
    for a, b in zip(carried.cascade.levels,
                    jidx._primary_engine.cascade.levels):
        assert a.tables == b.tables
    want = jidx.search(jnp.asarray(q), jindex.SearchParams(k=4))
    _assert_same(carried.search(q, k=4), want)
    with pytest.raises(ValueError, match="no forest"):
        convert.index_from_numpy(db, {"perm": 0}, spec, device="cpu")


def test_lsh_search_reranks_through_the_fused_stage(corpus, indexes):
    """On CPU tensors the rerank is kernel B's plain version, the stage the
    card runs as the kernel."""
    _, q = corpus
    _, tidx = indexes
    REF_CALLS.clear()
    d, i = tidx.search(q[:3], k=3)
    assert REF_CALLS == {"fused_gather_topk": 1}
    assert d.shape == i.shape == (3, 3)
