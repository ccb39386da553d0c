"""The port's fused query pipeline held against the reference's.

A forest built by ``repro`` is carried across (``convert.forest_from_numpy``)
so both packages query the same trees; the reference runs its plain path
(``fused_query(mode="ref")`` and ``staged_query``).  Top-k ids must be equal
(the data are continuous, so there are no distance ties) and distances agree
within rtol 1e-5 / atol 1e-6: the two frameworks sum the d terms in other
orders.  The port's answer must not depend on the chunk width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
from repro.core import forest as jforest
from repro.core import pipeline as jpipe
from repro.data.synthetic import clustered_gaussians
from repro_torch.convert import forest_from_numpy
from repro_torch.core import forest as tforest
from repro_torch.core import pipeline as tpipe

RTOL, ATOL = 1e-5, 1e-6
N, D, K = 1500, 24, 10
CFG = dict(n_trees=6, capacity=10)


@pytest.fixture(scope="module")
def setup():
    x = clustered_gaussians(N, D, n_clusters=16, seed=0)
    jf = jforest.build_forest(jax.random.key(0), jnp.asarray(x),
                              jforest.ForestConfig(**CFG))
    tf = forest_from_numpy(jax.device_get(jf), device="cpu")
    rng = np.random.default_rng(1)
    q = (x[rng.integers(0, N, 33)] + 0.5 * rng.normal(size=(33, D))
         ).astype(np.float32)
    return x, q, jf, tf


def _data(setup, metric):
    x, q, jf, tf = setup
    if metric == "chi2":            # chi2 wants non-negative features
        x, q = np.abs(x), np.abs(q)
    return x, q, jf, tf


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "dot", "chi2", "cosine"])
@pytest.mark.parametrize("n_probes", [1, 4])
def test_fused_query_matches_reference(setup, metric, n_probes):
    x, q, jf, tf = _data(setup, metric)
    want = jpipe.fused_query(jf, jnp.asarray(q), jnp.asarray(x), K,
                             jforest.ForestConfig(**CFG), metric=metric,
                             mode="ref", n_probes=n_probes)
    for chunk in (0, 7):
        got = tpipe.fused_query(tf, torch.from_numpy(q), torch.from_numpy(x),
                                K, tforest.ForestConfig(**CFG), metric=metric,
                                chunk=chunk, n_probes=n_probes, device="cpu")
        _assert_same(got, want)


@pytest.mark.parametrize("n_probes", [1, 4])
def test_fused_query_without_dedup(setup, n_probes):
    x, q, jf, tf = setup
    want = jpipe.fused_query(jf, jnp.asarray(q), jnp.asarray(x), K,
                             jforest.ForestConfig(**CFG), dedup=False,
                             mode="ref", n_probes=n_probes)
    for chunk in (0, 13):
        got = tpipe.fused_query(tf, torch.from_numpy(q), torch.from_numpy(x),
                                K, tforest.ForestConfig(**CFG), dedup=False,
                                chunk=chunk, n_probes=n_probes, device="cpu")
        _assert_same(got, want)


def test_single_query_and_staged_oracle(setup):
    x, q, jf, tf = setup
    cfg_j, cfg_t = jforest.ForestConfig(**CFG), tforest.ForestConfig(**CFG)
    want = jpipe.fused_query(jf, jnp.asarray(q[:1]), jnp.asarray(x), K,
                             cfg_j, mode="ref")
    got = tpipe.fused_query(tf, torch.from_numpy(q[:1]), torch.from_numpy(x),
                            K, cfg_t, device="cpu")
    _assert_same(got, want)
    want = jpipe.staged_query(jf, jnp.asarray(q), jnp.asarray(x), K, cfg_j)
    got = tpipe.staged_query(tf, torch.from_numpy(q), torch.from_numpy(x), K,
                             cfg_t)
    _assert_same(got, want)


def test_valid_mask_drops_dead_rows(setup):
    x, q, jf, tf = setup
    valid = np.random.default_rng(2).uniform(size=N) < 0.6
    want = jpipe.fused_query(jf, jnp.asarray(q), jnp.asarray(x), K,
                             jforest.ForestConfig(**CFG), mode="ref",
                             n_probes=4, valid=jnp.asarray(valid))
    got = tpipe.fused_query(tf, torch.from_numpy(q), torch.from_numpy(x), K,
                            tforest.ForestConfig(**CFG), n_probes=4,
                            valid=torch.from_numpy(valid), device="cpu")
    _assert_same(got, want)
    ids = got[1].numpy()
    assert valid[ids[ids >= 0]].all()


def test_fused_query_without_device_needs_cuda(setup, monkeypatch):
    x, q, _, tf = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.fused_query(tf, torch.from_numpy(q), torch.from_numpy(x), K,
                          tforest.ForestConfig(**CFG))
