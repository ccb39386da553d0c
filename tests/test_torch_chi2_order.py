"""Kernels B's and G's chi2 order of sums, held against the reference.

``ref.fused_gather_topk_lane_order`` and ``ref.distance_topk_lane_order``
sum each pair's chi2 terms as kernels B (``csrc/fused_query.cu``) and G
(``csrc/distance_topk.cu``) do (``ref.lane_order_sum``: 32 lane classes,
then the xor butterfly), so on the card their outputs are the kernels' bit
for bit (``chip_smoke.py``).  Here they are held against the reference's
plain versions (ids exact on tie-free data, distances within rtol 1e-5 /
atol 1e-6: the reference sums the d terms in another order), the order
itself against a lane-by-lane emulation, and the identity the kernels'
chi2 relies on: a row element of +0 or -0 may take the query element's own
term x * x / (x + 1e-12) without changing a bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
from repro.kernels import ref as jref
from repro_torch.data.synthetic import iss_like
from repro_torch.kernels import ref as tref
from repro_torch.kernels.common import EPS, topk_rounds
from repro_torch.kernels.fused_query import K_MAX

RTOL, ATOL = 1e-5, 1e-6


def _iss(n, b, d, seed):
    """ISS-595-like histograms (84% zeros) at width d."""
    db, _, q, _ = iss_like(n, n_test=b, d=d, n_models=6, seed=seed)
    return q, db


def _slots(b, m, n, seed, holes=0.2):
    """Distinct ids per query (tie-free scores), a share of them -1."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(n)[:m] for _ in range(b)]).astype(np.int32)
    ids[rng.uniform(size=ids.shape) < holes] = -1
    return ids


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_close(got, want):
    gd, gi = (t.numpy() for t in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("d", [595, 96])
def test_lane_order_matches_reference(d):
    """B's version against the reference's gather (ties to the earliest
    slot) and G's against its masked rerank (ties to the smaller id), on
    sparse histograms at d = 595 (one element a lane) and d % 4 == 0
    (float4 groups), with -1 slots and fewer valid slots than k in row 0."""
    q, db = _iss(400, 6, d, seed=d)
    ids = _slots(6, 90, 400, seed=d)
    ids[0, 3:] = -1
    tq, tids, tdb = map(torch.from_numpy, (q, ids, db))
    got = tref.fused_gather_topk_lane_order(tq, tids, tdb, 12)
    want = jref.fused_gather_topk_ref(jnp.asarray(q), jnp.asarray(ids),
                                      jnp.asarray(db), 12, "chi2")
    _assert_close(got, want)
    assert (got[1].numpy()[0, 3:] == -1).all()

    cand, mask = db[np.maximum(ids, 0)], ids >= 0
    got = tref.distance_topk_lane_order(tq, torch.from_numpy(cand), tids,
                                        torch.from_numpy(mask), 12)
    want = jref.distance_topk_ref(*map(jnp.asarray, (q, cand, ids, mask)),
                                  12, "chi2")
    _assert_close(got, want)


def _emulated(terms, w):
    """The kernels' sum written lane by lane: lane l adds its groups' terms
    left to right from +0, then five xor-shuffle steps (every lane adds
    its partner's partial), and lane 0 holds the score."""
    d = terms.shape[0]
    part = [np.float32(0.0)] * 32
    for g in range(-(-d // w)):
        for e in range(g * w, min(d, g * w + w)):
            part[g % 32] = np.float32(part[g % 32] + terms[e])
    for o in (16, 8, 4, 2, 1):
        part = [np.float32(part[l] + part[l ^ o]) for l in range(32)]
    return part[0]


@pytest.mark.parametrize("d,w", [(595, 1), (96, 4), (20, 4), (7, 1)])
def test_lane_order_sum_is_the_kernels_butterfly(d, w):
    """``lane_order_sum`` against a lane-by-lane emulation of the kernels'
    loop, on terms of many magnitudes (so the order shows in the bits)."""
    rng = np.random.default_rng(d)
    terms = (rng.normal(size=(5, d)) * 10.0 ** rng.integers(-6, 6, (5, d))
             ).astype(np.float32)
    got = tref.lane_order_sum(torch.from_numpy(terms), w).numpy()
    want = np.array([_emulated(t, w) for t in terms], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("d", [595, 96])
def test_own_term_for_zero_row_elements_changes_no_bit(d):
    """The kernels add a row element of +0 or -0 as the query element's own
    term x * x / (x + 1e-12), computed once per query: every term and every
    lane-order sum keeps its bits, on ISS-595-like rows with -0.0 row
    elements, x = 0 against y = -0, negative and subnormal elements."""
    q, db = _iss(64, 8, d, seed=d + 1)
    x = np.repeat(q, 8, axis=0)                              # (64, d)
    y = db.copy()
    rng = np.random.default_rng(d)
    zero = y == 0
    y[zero & (rng.uniform(size=y.shape) < 0.5)] = -0.0
    x[zero & (rng.uniform(size=y.shape) < 0.3)] = 0.0        # x = 0, y = +-0
    x[::5, ::7] = -x[::5, ::7]                               # negative x
    x[1::4, 3::11] = 1e-40                                   # subnormal x
    y[2::4, 5::13] = -1e-41                                  # subnormal y
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert bool((torch.signbit(ty) & (ty == 0)).any())
    full = tref.chi2_terms(tx, ty)
    own = tx * tx / (tx + EPS)
    sub = torch.where(ty == 0, own, full)
    assert torch.equal(_bits(sub), _bits(full))
    w = 4 if d % 4 == 0 else 1
    assert torch.equal(_bits(tref.lane_order_sum(sub, w)),
                       _bits(tref.lane_order_sum(full, w)))


@pytest.mark.parametrize("kernel", ["B", "G"])
def test_lane_order_rounds_at_k129(kernel):
    """k = 129, one past the kernels' list: B's and G's lane-order versions
    through ``common.topk_rounds`` (a round after the last (score, slot) or
    (score, id, slot) of the one before) equal their one-pass k = 129 bit
    for bit and the reference within tolerance, and their first 10 columns
    are their own k = 10 output bit for bit."""
    q, db = _iss(600, 3, 595, seed=5)
    ids = _slots(3, 400, 600, seed=5)
    tq, tids, tdb = map(torch.from_numpy, (q, ids, db))
    if kernel == "B":
        def fn(kk, lower=None, keys=False):
            return tref.fused_gather_topk_lane_order(tq, tids, tdb, kk,
                                                     lower, keys)
        want = jref.fused_gather_topk_ref(jnp.asarray(q), jnp.asarray(ids),
                                          jnp.asarray(db), 129, "chi2")
    else:
        cand, mask = db[np.maximum(ids, 0)], ids >= 0
        tc, tm = torch.from_numpy(cand), torch.from_numpy(mask)

        def fn(kk, lower=None, keys=False):
            return tref.distance_topk_lane_order(tq, tc, tids, tm, kk, lower,
                                                 keys)
        want = jref.distance_topk_ref(
            *map(jnp.asarray, (q, cand, ids, mask)), 129, "chi2")
    got = topk_rounds(129, K_MAX, lambda kk, lower: fn(kk, lower, True))
    one = fn(129)
    assert torch.equal(_bits(got[0]), _bits(one[0]))
    assert torch.equal(got[1], one[1])
    _assert_close(got, want)
    small = fn(10)
    assert torch.equal(_bits(got[0][:, :10]), _bits(small[0]))
    assert torch.equal(got[1][:, :10], small[1])
