"""The port's entry points of kernels F, G and H held against the reference.

``ops.traverse_tree`` (kernel F, the shared-memory descent, and kernel A at
L = 1), ``ops.rerank_candidates`` (kernel G, ``distance_topk``) and
``ops.embedding_bag`` (kernel H) run their plain versions on CPU tensors;
here those are held against ``repro.kernels.ops`` on the same numpy inputs,
with one interpret-mode case of each Pallas kernel.

Tolerances: leaf ids are bitwise equal (gathers and compares only).
Distances agree within rtol 1e-5 / atol 1e-6 and bags within rtol 1e-5 /
atol 1e-6, because XLA and PyTorch sum the d (or H) terms in other orders;
ids are exactly equal, ties included (both go to the smaller id).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import forest_traverse as smem
from repro_torch.kernels import ref as tref
from repro_torch.kernels.common import LAUNCHES, REF_CALLS, topk_rounds
from repro_torch.kernels.distance_topk import K_MAX, distance_topk
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.forest_traverse import forest_traverse
from repro_torch.kernels.forest_traverse_hbm import forest_traverse_hbm_tree

RTOL, ATOL = 1e-5, 1e-6


def _tree(n_nodes, d, seed):
    """One K = 1 tree in heap layout (children 2i+1, 2i+2) with random
    early leaves, random thresholds and a few margins tied at 0."""
    rng = np.random.default_rng(seed)
    feat = rng.integers(0, d, size=n_nodes).astype(np.int32)
    thresh = rng.normal(size=n_nodes).astype(np.float32)
    i = np.arange(n_nodes)
    child = np.where(2 * i + 2 < n_nodes, 2 * i + 1, -1).astype(np.int32)
    child[rng.uniform(size=n_nodes) < 0.15] = -1
    child[0] = 1
    q = rng.normal(size=(13, d)).astype(np.float32)
    q[0, feat[0]] = thresh[0]                  # a zero margin at the root
    return feat, thresh, child, q


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("n_probes", [1, 3])
@pytest.mark.parametrize("kernel", ["smem", "hbm", "auto"])
def test_traverse_tree_matches_reference(kernel, n_probes):
    feat, thresh, child, q = _tree(255, 10, seed=n_probes)
    got = ops.traverse_tree(*_t(feat, thresh, child, q), 7, n_probes=n_probes,
                            kernel=kernel)
    want = jops.traverse_tree(*map(jnp.asarray, (feat, thresh, child, q)), 7,
                              mode="ref", n_probes=n_probes, kernel=kernel)
    assert got.dtype == torch.int32
    assert got.shape == ((13,) if n_probes == 1 else (13, n_probes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_traverse_tree_smem_pallas_interpret_case():
    feat, thresh, child, q = _tree(31, 6, seed=5)
    want = jops.traverse_tree(*map(jnp.asarray, (feat, thresh, child, q)), 4,
                              mode="pallas", n_probes=3, kernel="smem")
    got = ops.traverse_tree(*_t(feat, thresh, child, q), 4, n_probes=3,
                            kernel="smem")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_single_tree_wrappers_agree_on_cpu():
    """Kernel F's and kernel A's single-tree wrappers give the plain
    version's leaves, (B,) at one probe, -1 past the finite margins."""
    feat, thresh, child, q = _tree(63, 8, seed=9)
    args = _t(feat, thresh, child, q)
    for p in (1, 4, 9):
        a = forest_traverse(*args, 5, p)
        b = forest_traverse_hbm_tree(*args, 5, p)
        assert torch.equal(a, b)
    assert a.shape == (13, 9) and bool((a[:, 6:] == -1).all())


def test_traverse_tree_policy():
    feat, thresh, child, q = _t(*_tree(15, 4, seed=1))
    with pytest.raises(ValueError, match="auto|smem|hbm"):
        ops.traverse_tree(feat, thresh, child, q, 3, kernel="sram")
    with pytest.raises(ValueError, match="CUDA"):
        ops.traverse_tree(feat, thresh, child, q, 3, mode="kernel")


def test_smem_node_cap_is_the_cards_opt_in_shared_memory(monkeypatch):
    """232,448 bytes a block on an H100: 19,370 nodes of 12 bytes."""
    class Props:
        shared_memory_per_block_optin = 232_448

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    smem.smem_node_cap.cache_clear()
    try:
        assert smem.smem_node_cap(torch.device("cuda", 0)) == 19_370
    finally:
        smem.smem_node_cap.cache_clear()


# ---------------------------------------------------------------------------
# rerank_candidates (kernel G)
# ---------------------------------------------------------------------------


def _cand_inputs(b, m, d, seed, nonneg):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    cand = rng.normal(size=(b, m, d)).astype(np.float32)
    if nonneg:
        q, cand = np.abs(q), np.abs(cand)
    ids = rng.integers(0, 1000, size=(b, m)).astype(np.int32)
    mask = rng.uniform(size=(b, m)) > 0.3
    mask[1] = False                        # an all-masked row
    mask[2, 3:] = False                    # fewer valid slots than k
    return q, cand, ids, mask


@pytest.mark.parametrize("metric", ["l2", "chi2"])
@pytest.mark.parametrize("b,m,d,k", [(7, 50, 12, 5), (4, 9, 5, 16),
                                     (3, 70, 33, 70)])
def test_rerank_candidates_matches_reference(metric, b, m, d, k):
    """Odd shapes, masked slots, an all-masked row, k > M (the port pads to
    k with +inf / -1; the reference's plain version returns min(k, M)
    columns)."""
    q, cand, ids, mask = _cand_inputs(b, m, d, b * m + k, metric == "chi2")
    gd, gi = ops.rerank_candidates(*_t(q, cand, ids, mask), k, metric)
    wd, wi = (np.asarray(a) for a in jref.distance_topk_ref(
        *map(jnp.asarray, (q, cand, ids, mask)), k, metric))
    assert gd.shape == gi.shape == (b, k)
    w = wd.shape[1]
    np.testing.assert_allclose(gd.numpy()[:, :w], wd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(gi.numpy()[:, :w], wi)
    assert np.isinf(gd.numpy()[:, w:]).all() and (gi.numpy()[:, w:] == -1).all()
    assert np.isinf(gd.numpy()[1]).all() and (gi.numpy()[1] == -1).all()


@pytest.mark.parametrize("k", [3, 8])
def test_rerank_candidates_ties_go_to_the_smaller_id(k):
    """Six slots at one distance, ids [7, 3, 9, 1, 5, 2]: the reference's
    plain version (the documented contract) returns the smallest ids; its
    Pallas kernel would return the earliest slots."""
    q = np.zeros((1, 4), np.float32)
    cand = np.ones((1, 6, 4), np.float32)
    ids = np.array([[7, 3, 9, 1, 5, 2]], np.int32)
    mask = np.ones((1, 6), bool)
    gd, gi = ops.rerank_candidates(*_t(q, cand, ids, mask), k)
    wd, wi = jref.distance_topk_ref(*map(jnp.asarray, (q, cand, ids, mask)),
                                    k)
    np.testing.assert_array_equal(gi.numpy()[:, :6], np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy()[:, :6], np.asarray(wd))
    assert gi.tolist()[0] == [1, 2, 3, 5, 7, 9, -1, -1][:k]


@pytest.mark.parametrize("metric", ["l2", "chi2"])
@pytest.mark.parametrize("k", [129, 300])
def test_distance_topk_ref_rounds_match_reference(metric, k):
    """k above kernel G's list (K_MAX = 128): the plain version through the
    round loop, each round after the last (score, id, slot) of the one
    before, equals the reference in one pass; repeated ids with equal rows
    (a tie on (score, id) that the slot breaks, across a round's edge too),
    an all-masked row, fewer valid slots than k; its first 10 columns are
    bitwise its own k = 10 output."""
    q, cand, ids, mask = _cand_inputs(4, 400, 10, k, metric == "chi2")
    # row 0: slot 0 scores 0, then each id twice with the same row, so the
    # two copies of the 64th pair straddle the first round's edge
    ids[0, 2::2] = ids[0, 1:-1:2]
    cand[0, 2::2] = cand[0, 1:-1:2]
    cand[0, 0] = q[0]
    mask[0] = True
    mask[0, -1] = False                    # the one unpaired slot
    tq, tc, ti, tm = _t(q, cand, ids, mask)
    got = topk_rounds(k, K_MAX, lambda kk, lower: tref.distance_topk_ref(
        tq, tc, ti, tm, kk, metric, lower, keys=True))
    wd, wi = (np.asarray(a) for a in jref.distance_topk_ref(
        *map(jnp.asarray, (q, cand, ids, mask)), k, metric))
    np.testing.assert_allclose(got[0].numpy(), wd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1].numpy(), wi)
    assert (got[1].numpy()[1] == -1).all()
    small = tref.distance_topk_ref(tq, tc, ti, tm, 10, metric)
    assert torch.equal(got[0][:, :10].contiguous().view(torch.int32),
                       small[0].view(torch.int32))
    assert torch.equal(got[1][:, :10], small[1])


def test_rerank_candidates_pallas_interpret_case():
    """Tie-free data, where the Pallas kernel and the plain version agree."""
    q, cand, ids, mask = _cand_inputs(3, 20, 8, 11, nonneg=False)
    ids = np.arange(60, dtype=np.int32).reshape(3, 20)
    want = jops.rerank_candidates(*map(jnp.asarray, (q, cand, ids, mask)), 4,
                                  mode="pallas")
    got = ops.rerank_candidates(*_t(q, cand, ids, mask), 4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# embedding_bag (kernel H)
# ---------------------------------------------------------------------------


def _bag_inputs(b, h, v, d, seed):
    """Ragged bags: lengths 1..h, the tail id 0 with weight 0."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, h)).astype(np.int32)
    w = rng.uniform(size=(b, h)).astype(np.float32)
    tail = np.arange(h)[None, :] >= rng.integers(1, h + 1, size=(b, 1))
    ids[tail], w[tail] = 0, 0.0
    return ids, w, table


@pytest.mark.parametrize("b,h,v,d", [
    (9, 50, 300, 64), (5, 7, 40, 6), (1, 33, 10, 3),
    # the edge shapes chip_smoke.py holds kernel H to: one bag, 7 bags, H =
    # 1, D = 6 (the scalar branch), and more bags than a block's warps
    (1, 50, 500, 64), (7, 50, 500, 64), (7, 1, 500, 64), (300, 50, 100, 6),
    (64, 50, 1000, 64)])
def test_embedding_bag_matches_reference(b, h, v, d):
    ids, w, table = _bag_inputs(b, h, v, d, seed=b + h)
    got = ops.embedding_bag(*_t(ids, w, table))
    want = jops.embedding_bag(*map(jnp.asarray, (ids, w, table)), mode="ref")
    assert got.shape == (b, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_embedding_bag_propagates_nan_and_inf_like_the_reference():
    """Padding is id 0 with weight 0: a NaN in row 0 reaches every padded
    bag (0 * NaN), an inf elsewhere reaches the bags that hold its row."""
    ids, w, table = _bag_inputs(6, 5, 20, 4, seed=3)
    table[0, 1] = np.nan
    table[7, 2] = np.inf
    got = ops.embedding_bag(*_t(ids, w, table)).numpy()
    want = np.asarray(jops.embedding_bag(*map(jnp.asarray, (ids, w, table)),
                                         mode="ref"))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)


def test_embedding_bag_pallas_interpret_case():
    ids, w, table = _bag_inputs(3, 4, 12, 8, seed=4)
    want = jops.embedding_bag(*map(jnp.asarray, (ids, w, table)),
                              mode="pallas")
    got = ops.embedding_bag(*_t(ids, w, table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    feat, thresh, child, q = _t(*_tree(15, 4, seed=2))
    qq, cand, ids, mask = _t(*_cand_inputs(3, 6, 4, 2, nonneg=False))
    bag = _t(*_bag_inputs(2, 3, 5, 4, seed=2))
    LAUNCHES.clear()
    REF_CALLS.clear()
    forest_traverse(feat, thresh, child, q, 3)
    distance_topk(qq, cand, ids, mask, 2)
    embedding_bag(*bag)
    assert REF_CALLS == {"forest_traverse_smem": 1, "distance_topk": 1,
                         "embedding_bag": 1}
    assert not LAUNCHES


@pytest.mark.parametrize("mode", ["kernel", "pallas"])
def test_kernel_mode_on_cpu_tensors_raises(mode):
    qq, cand, ids, mask = _t(*_cand_inputs(3, 6, 4, 2, nonneg=False))
    with pytest.raises(ValueError, match="CUDA"):
        ops.rerank_candidates(qq, cand, ids, mask, 2, mode=mode)
    with pytest.raises(ValueError, match="CUDA"):
        ops.embedding_bag(*_t(*_bag_inputs(2, 3, 5, 4, seed=2)), mode=mode)


def test_rerank_candidates_rejects_other_metrics():
    qq, cand, ids, mask = _t(*_cand_inputs(3, 6, 4, 2, nonneg=False))
    with pytest.raises(ValueError, match="l2 or chi2"):
        ops.rerank_candidates(qq, cand, ids, mask, 2, metric="dot")
