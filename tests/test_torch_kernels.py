"""The port's plain kernel versions held against the reference's kernels.

``repro_torch.kernels.ref`` is what the CUDA kernels are compared with on
the card, so here it is held against ``repro.kernels.ref`` (and, in one tiny
case each, the Pallas kernels in interpret mode) on the same numpy inputs.

Tolerances: leaf ids are exactly equal (the descent is gathers and compares
only).  Distances agree within rtol 1e-5 / atol 1e-6 because XLA and
PyTorch sum the d terms in different orders (and cosine takes the norm
through different primitives); ids are equal on tie-free data.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.common import (LAUNCHES, REF_CALLS, topk_rounds,
                                        topk_smallest)
from repro_torch.kernels.forest_traverse_hbm import forest_traverse_hbm
from repro_torch.kernels.fused_query import K_MAX, fused_gather_topk

RTOL, ATOL = 1e-5, 1e-6
METRICS = ("l2", "dot", "chi2", "cosine")


def _fused_inputs(b, m, n, d, holes, seed, nonneg=False):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    if nonneg:
        db, q = np.abs(db), np.abs(q)
    ids = rng.integers(0, n, size=(b, m)).astype(np.int32)
    ids[rng.uniform(size=(b, m)) < holes] = -1
    ids[0, 2:] = -1                  # row 0: fewer valid slots than k
    return q, ids, db


def _assert_topk(got, want):
    gd, gi = (t.numpy() for t in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,m,k", [(11, 70, 6), (1, 33, 1), (9, 40, 40)])
def test_fused_gather_topk_ref_matches_reference(metric, b, m, k):
    """Odd B (not a multiple of the reference's 8-row tile), -1 slots, k
    above the valid count of row 0 (+inf / -1 tail), k == M."""
    q, ids, db = _fused_inputs(b, m, 300, 24, 0.3, seed=b * m + k,
                               nonneg=metric == "chi2")
    got = tref.fused_gather_topk_ref(torch.from_numpy(q),
                                     torch.from_numpy(ids),
                                     torch.from_numpy(db), k, metric)
    want = jref.fused_gather_topk_ref(jnp.asarray(q), jnp.asarray(ids),
                                      jnp.asarray(db), k, metric)
    _assert_topk(got, want)
    assert np.isinf(got[0].numpy()[0, 2:]).all()
    assert (got[1].numpy()[0, 2:] == -1).all()


def _assert_prefix(got, small):
    """A round-served top-k's first columns are bitwise the small k's."""
    w = small[0].shape[1]
    assert torch.equal(got[0][:, :w].contiguous().view(torch.int32),
                       small[0].view(torch.int32))
    assert torch.equal(got[1][:, :w], small[1])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [129, 300])
def test_fused_gather_topk_ref_rounds_match_reference(metric, k):
    """k above the kernel's list (K_MAX = 128): the plain version driven
    through the round loop, each round after the last (score, slot) of the
    one before, equals the reference at k in one pass; 30% holes and
    repeated ids (ties to the earliest slot across rounds), fewer valid
    slots than k (+inf / -1 tail), and its first 10 columns are bitwise its
    own k = 10 output."""
    q, ids, db = _fused_inputs(5, 400, 600, 24, 0.3, seed=k,
                               nonneg=metric == "chi2")
    tq, tids, tdb = map(torch.from_numpy, (q, ids, db))
    got = topk_rounds(k, K_MAX, lambda kk, lower: tref.fused_gather_topk_ref(
        tq, tids, tdb, kk, metric, lower, keys=True))
    want = jref.fused_gather_topk_ref(jnp.asarray(q), jnp.asarray(ids),
                                      jnp.asarray(db), k, metric)
    _assert_topk(got, want)
    assert np.isinf(got[0].numpy()[0, 2:]).all()
    assert (got[1].numpy()[0, 2:] == -1).all()
    _assert_prefix(got, tref.fused_gather_topk_ref(tq, tids, tdb, 10, metric))


def test_topk_rounds_of_small_lists_equal_one_pass():
    """Lists of 7 in many rounds give the one-pass top-k bit for bit."""
    q, ids, db = _fused_inputs(4, 90, 200, 8, 0.2, seed=12)
    tq, tids, tdb = map(torch.from_numpy, (q, ids, db))
    got = topk_rounds(60, 7, lambda kk, lower: tref.fused_gather_topk_ref(
        tq, tids, tdb, kk, "l2", lower, keys=True))
    _assert_prefix(got, tref.fused_gather_topk_ref(tq, tids, tdb, 60))


def test_fused_gather_topk_ref_at_full_width():
    """d = 784, the MNIST width."""
    q, ids, db = _fused_inputs(5, 96, 400, 784, 0.2, seed=7)
    got = tref.fused_gather_topk_ref(torch.from_numpy(q),
                                     torch.from_numpy(ids),
                                     torch.from_numpy(db), 10)
    want = jref.fused_gather_topk_ref(jnp.asarray(q), jnp.asarray(ids),
                                      jnp.asarray(db), 10)
    _assert_topk(got, want)


def test_fused_gather_topk_ties_keep_earliest_slot():
    """Duplicate rows score equal: both packages keep the earliest slot."""
    rng = np.random.default_rng(3)
    db = rng.normal(size=(6, 8)).astype(np.float32)
    db = np.concatenate([db, db])                     # row i == row i + 6
    q = rng.normal(size=(4, 8)).astype(np.float32)
    ids = np.tile(np.array([9, 3, 0, 6, 11, 5, 2, 8], np.int32), (4, 1))
    got = tref.fused_gather_topk_ref(torch.from_numpy(q),
                                     torch.from_numpy(ids),
                                     torch.from_numpy(db), 8)
    want = jref.fused_gather_topk_ref(jnp.asarray(q), jnp.asarray(ids),
                                      jnp.asarray(db), 8)
    _assert_topk(got, want)


def test_fused_gather_topk_pallas_interpret_case():
    from repro.kernels.fused_query import fused_gather_topk as pallas_fused
    q, ids, db = _fused_inputs(3, 40, 60, 8, 0.25, seed=5)
    want = pallas_fused(jnp.asarray(q), jnp.asarray(ids), jnp.asarray(db), 5,
                        metric="l2", interpret=True)
    got = fused_gather_topk(torch.from_numpy(q), torch.from_numpy(ids),
                            torch.from_numpy(db), 5, "l2")
    _assert_topk(got, want)


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    q, ids, db = _fused_inputs(2, 10, 20, 4, 0.0, seed=1)
    feat, thresh, child = _random_trees(2, 15, 4, seed=1)
    LAUNCHES.clear()
    REF_CALLS.clear()
    fused_gather_topk(torch.from_numpy(q), torch.from_numpy(ids),
                      torch.from_numpy(db), 3)
    forest_traverse_hbm(feat, thresh, child, torch.from_numpy(q), 4, 2)
    assert REF_CALLS == {"fused_gather_topk": 1, "forest_traverse": 1}
    assert not LAUNCHES


def test_topk_smallest_pads_past_m():
    vals, pos = topk_smallest(torch.tensor([[3.0, 1.0]]), 4)
    assert vals.tolist() == [[1.0, 3.0, float("inf"), float("inf")]]
    assert pos.tolist() == [[1, 0, -1, -1]]


# ---------------------------------------------------------------------------
# descent
# ---------------------------------------------------------------------------


def _random_trees(n_trees, n_nodes, d, seed):
    """K = 1 trees in heap layout (children 2i+1, 2i+2) with random early
    leaves and random thresholds: (feat, thresh, child_base) tensors."""
    rng = np.random.default_rng(seed)
    feat = rng.integers(0, d, size=(n_trees, n_nodes)).astype(np.int32)
    thresh = rng.normal(size=(n_trees, n_nodes)).astype(np.float32)
    i = np.arange(n_nodes)
    child = np.where(2 * i + 2 < n_nodes, 2 * i + 1, -1)
    child = np.tile(child, (n_trees, 1)).astype(np.int32)
    child[rng.uniform(size=child.shape) < 0.15] = -1
    return (torch.from_numpy(feat), torch.from_numpy(thresh),
            torch.from_numpy(child))


def _jax_traverse(feat, thresh, child, q, max_depth, n_probes):
    out = []
    for t in range(feat.shape[0]):
        args = (jnp.asarray(feat[t].numpy()), jnp.asarray(thresh[t].numpy()),
                jnp.asarray(child[t].numpy()), jnp.asarray(q), max_depth)
        if n_probes == 1:
            out.append(np.asarray(jref.forest_traverse_ref(*args)))
        else:
            out.append(np.asarray(jref.forest_traverse_multiprobe_ref(
                *args, n_probes)))
    return np.stack(out)


def _chain_trees(n_trees, depth, d, seed):
    """K = 1 chains ``depth`` levels deep: the path node at depth t has
    children 2t + 1 and 2t + 2, a leaf and the next path node, and the
    test sends most queries in [0, 1) along the chain (its threshold
    outside [0, 1) on all but about one in 10 of the top 20 levels, so
    queries leave near the root or reach the bottom)."""
    rng = np.random.default_rng(seed)
    n = 2 * depth + 1
    feat = np.zeros((n_trees, n), np.int32)
    thresh = np.zeros((n_trees, n), np.float32)
    child = -np.ones((n_trees, n), np.int32)
    for tr in range(n_trees):
        node = 0
        for t in range(depth):
            right = rng.uniform() < 0.5
            u = rng.uniform()
            feat[tr, node] = rng.integers(d)
            thresh[tr, node] = (u if t < 20 and rng.uniform() < 0.1
                                else (-u if right else 1 + u))
            child[tr, node] = 2 * t + 1
            node = 2 * t + 1 + int(right)
    return (torch.from_numpy(feat), torch.from_numpy(thresh),
            torch.from_numpy(child))


def _descent_case(case, seed):
    """(feat, thresh, child, q, max_depth) of a descent test case: random
    trees; thresholds and queries on one grid of 1/2 (tied margins, and
    q[feat] == thresh); NaN, +inf and -inf query elements; or chains
    150 levels deep."""
    rng = np.random.default_rng(seed)
    if case == "chain150":
        feat, thresh, child = _chain_trees(2, 150, 10, seed)
        return feat, thresh, child, rng.uniform(size=(13, 10)).astype(
            np.float32), 150
    feat, thresh, child = _random_trees(3, 127, 10, seed=seed)
    q = rng.normal(size=(13, 10)).astype(np.float32)
    if case == "ties":
        thresh = torch.round(thresh * 2) / 2
        q = rng.integers(-3, 4, size=q.shape).astype(np.float32) / 2
    elif case == "nan_inf":
        q[0] = np.nan
        q[1, ::3] = np.inf
        q[2, 1::3] = -np.inf
        q[3, ::4] = np.nan
    return feat, thresh, child, q, 6


@pytest.mark.parametrize("case,n_probes", [
    pytest.param("random", 1, id="1"), pytest.param("random", 3, id="3"),
    pytest.param("random", 9, id="9"), ("random", 8),
    ("ties", 1), ("ties", 3), ("ties", 4), ("ties", 9),
    ("nan_inf", 1), ("nan_inf", 3), ("nan_inf", 4), ("nan_inf", 9),
    ("chain150", 1), ("chain150", 4)])
def test_forest_traverse_ref_matches_reference(case, n_probes):
    """The plain version (the yardstick kernels A and F are held to on the
    card) equals the reference on random trees (n_probes 9 > max_depth + 1:
    the tail slots are -1 in both), tied margins, NaN / +-inf query
    elements and trees deeper than 128 levels."""
    feat, thresh, child, q, max_depth = _descent_case(case, n_probes)
    got = tref.forest_traverse_ref(feat, thresh, child, torch.from_numpy(q),
                                   max_depth, n_probes)
    want = _jax_traverse(feat, thresh, child, q, max_depth, n_probes)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("n_probes", [1, 4])
def test_forest_traverse_hbm_takes_any_depth_on_cpu_tensors(n_probes):
    """max_depth 150 (past the 128 levels the kernel once refused): the
    wrapper runs the plain version on CPU tensors and does not raise."""
    feat, thresh, child, q, _ = _descent_case("chain150", 2)
    q = torch.from_numpy(q)
    got = forest_traverse_hbm(feat, thresh, child, q, 150, n_probes)
    want = tref.forest_traverse_ref(feat, thresh, child, q, 150, n_probes)
    assert torch.equal(got, want)
    assert int(got.view(2, 13, -1)[..., 0].max()) > 2 * 128


def test_forest_traverse_pallas_interpret_case():
    from repro.kernels.forest_traverse_hbm import forest_traverse_hbm as pallas
    feat, thresh, child = _random_trees(2, 15, 6, seed=11)
    q = np.random.default_rng(11).normal(size=(5, 6)).astype(np.float32)
    want = pallas(jnp.asarray(feat.numpy()), jnp.asarray(thresh.numpy()),
                  jnp.asarray(child.numpy()), jnp.asarray(q), 4,
                  interpret=True, n_probes=3)
    got = forest_traverse_hbm(feat, thresh, child, torch.from_numpy(q), 4, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# mode policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["kernel", "pallas"])
def test_kernel_mode_on_cpu_tensors_raises(mode):
    q, ids, db = _fused_inputs(2, 10, 20, 4, 0.0, seed=2)
    feat, thresh, child = _random_trees(2, 15, 4, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_rerank(torch.from_numpy(q), torch.from_numpy(ids),
                         torch.from_numpy(db), 3, mode=mode)
    with pytest.raises(ValueError, match="CUDA"):
        ops.traverse(feat, thresh, child, torch.from_numpy(q), 4, mode=mode)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        ops.canonical_mode("fast")
