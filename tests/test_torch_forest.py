"""The port's forest builder and descent held against the reference's.

Fed the reference's own per-level draws (``_batched_level_draws``, compat
mode), ``repro_torch.core.forest.build_forest`` must reproduce every
``Forest`` array of ``repro.core.forest.build_forest``: integers exactly and
``thresh`` bitwise.  The descent and candidate slicing are gathers and
compares, so their ids and masks must be exactly equal too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
from repro.core import forest as jforest
from repro.core import search as jsearch
from repro_torch.convert import forest_from_numpy
from repro_torch.core import forest as tforest
from repro_torch.core import search as tsearch


def _corpus(n, d, kind="normal", seed=0):
    rng = np.random.default_rng(seed)
    if kind == "tied":
        # sparse-histogram-like: most entries exactly 0, a few quantized
        x = rng.integers(0, 4, size=(n, d)).astype(np.float32)
        x[rng.uniform(size=x.shape) < 0.7] = 0.0
    elif kind == "signed_zeros":
        x = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        x[rng.uniform(size=x.shape) < 0.5] = -0.0
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
    return x


def reference_draws(key, cfg, n, d):
    """The reference's per-level draws as numpy, for the port's builder."""
    rc = cfg.resolved(n)
    draws = jax.jit(jforest._batched_level_draws(
        jax.random.split(key, rc.n_trees), rc, d, "compat"))
    return lambda level: tuple(np.array(a) for a in draws(level))


def _assert_forest_equal(got, want):
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if w.dtype == np.float32:   # bitwise, signed zeros included
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f"Forest.{name}")


@pytest.mark.parametrize("n,d,kind,cfg_kw", [
    (700, 16, "normal", dict(n_trees=6, capacity=12)),
    (701, 16, "normal", dict(n_trees=5, capacity=5, split_ratio=0.45)),
    (900, 24, "tied", dict(n_trees=6, capacity=10)),
    (500, 12, "signed_zeros", dict(n_trees=4, capacity=8)),
    (600, 8, "normal", dict(n_trees=4, capacity=4, max_nodes=96)),
    (300, 12, "normal", dict(n_trees=4, capacity=8, n_proj=2)),
    (300, 12, "normal", dict(n_trees=4, capacity=8, max_depth=4)),
    (8, 4, "normal", dict(n_trees=3, capacity=12)),
], ids=["plain", "ragged", "tied", "signed-zeros", "node-budget", "K2",
        "depth-capped", "no-split"])
def test_builder_matches_reference_bitwise(n, d, kind, cfg_kw):
    x = _corpus(n, d, kind, seed=n + d)
    key = jax.random.key(n)
    want = jforest.build_forest(key, jnp.asarray(x),
                                jforest.ForestConfig(**cfg_kw))
    got = tforest.build_forest(x, tforest.ForestConfig(**cfg_kw),
                               draws=reference_draws(
                                   key, jforest.ForestConfig(**cfg_kw), n, d),
                               device="cpu")
    _assert_forest_equal(got, want)


def test_generator_build_is_a_valid_partition():
    n, cfg = 800, tforest.ForestConfig(n_trees=5, capacity=10)
    x = _corpus(n, 16, seed=1)
    f = tforest.build_forest(x, cfg, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    perm = f.perm.numpy()
    for t in range(cfg.n_trees):
        assert sorted(perm[t]) == list(range(n))
    leaf = (f.child_base < 0) & (torch.arange(f.max_nodes) < f.n_nodes[:, None])
    assert int(f.leaf_count[leaf].max()) <= cfg.capacity
    assert int(f.leaf_count.sum()) == cfg.n_trees * n


def test_resolved_config_matches_reference():
    for n in (60_000, 1_000_000, 37):
        assert tuple(tforest.ForestConfig().resolved(n)) == \
            tuple(jforest.ForestConfig().resolved(n))
    assert tforest.ForestConfig().resolved(60_000)[4:] == (66, 66_730, 12)


# ---------------------------------------------------------------------------
# query side, on a reference-built forest carried across
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    x = _corpus(1200, 20, seed=4)
    cfg = jforest.ForestConfig(n_trees=5, capacity=10)
    jf = jforest.build_forest(jax.random.key(4), jnp.asarray(x), cfg)
    tf = forest_from_numpy(jax.device_get(jf), device="cpu")
    rng = np.random.default_rng(5)
    q = (x[:23] + 0.3 * rng.normal(size=(23, 20))).astype(np.float32)
    return jf, tf, cfg.resolved(1200), q


@pytest.mark.parametrize("n_probes", [1, 3])
def test_descent_and_candidates_match_reference(carried, n_probes):
    jf, tf, rc, q = carried
    tq = torch.from_numpy(q)
    if n_probes == 1:
        want = jforest.traverse(jf, jnp.asarray(q), rc.max_depth)
        got = tforest.traverse(tf, tq, rc.max_depth)
        wids, wmask = jforest.gather_candidates(jf, want, rc.leaf_pad)
        gids, gmask = tforest.gather_candidates(tf, got, rc.leaf_pad)
    else:
        want = jforest.traverse_multiprobe(jf, jnp.asarray(q), rc.max_depth,
                                           n_probes)
        got = tforest.traverse_multiprobe(tf, tq, rc.max_depth, n_probes)
        wids, wmask = jforest.gather_candidates_multi(jf, want, rc.leaf_pad)
        gids, gmask = tforest.gather_candidates_multi(tf, got, rc.leaf_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gids.numpy(), np.asarray(wids))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    # the mode-dispatched entry (K = 1: the descent kernel's plain version)
    np.testing.assert_array_equal(
        tforest.traverse_forest(tf, tq, rc.max_depth, n_probes).numpy(),
        np.asarray(want))


def test_mask_duplicates_and_merge_match_reference():
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 30, size=(9, 50)).astype(np.int32)
    mask = rng.uniform(size=ids.shape) < 0.8
    np.testing.assert_array_equal(
        tsearch.mask_duplicates(torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy(),
        np.asarray(jsearch.mask_duplicates(jnp.asarray(ids),
                                           jnp.asarray(mask))))
    dists = rng.normal(size=ids.shape).astype(np.float32)
    ids[:, ::7] = -1
    got = tsearch.merge_topk_pairs(torch.from_numpy(dists),
                                   torch.from_numpy(ids), 6)
    want = jsearch.merge_topk_pairs(jnp.asarray(dists), jnp.asarray(ids), 6)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
