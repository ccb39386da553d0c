"""The port's exact scans held against the reference's: the plain versions
of kernels D (``matmul_topk``) and E (``chi2_topk``), ``ops.topk``, the
``bruteforce`` backend, ``exact_knn(db_chunk=...)`` and the ISS-595 data
and configuration copies, on the same numpy inputs.

Tolerances: distances within rtol 1e-5 / atol 1e-6 (the frameworks sum the
d terms in other orders), except the l2 expansion |q|^2 - 2 q.c + |c|^2,
which cancels near 0 and is held to 1e-5 (|q|^2 + |c|^2) + 1e-6; ids are
equal on tie-free data, and on ties both keep the smaller id; the data
copies are bitwise equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro.core.knn import exact_knn as j_exact_knn
from repro.data.synthetic import iss_like as j_iss_like
from repro.kernels import ref as jref
from repro_torch import index as tindex
from repro_torch.configs import rpf_iss595 as t_cfg
from repro_torch.core.knn import exact_knn
from repro_torch.data.synthetic import iss_like
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.chi2_topk import chi2_topk
from repro_torch.index.segments import brute_force_topk
from repro_torch.kernels.common import LAUNCHES, REF_CALLS, topk_rounds
from repro_torch.kernels.matmul_topk import K_MAX, matmul_topk

RTOL, ATOL = 1e-5, 1e-6


def _inputs(b, n, d, seed, nonneg=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    db = rng.normal(size=(n, d)).astype(np.float32)
    if nonneg:
        q, db = np.abs(q), np.abs(db)
    return q, db


def _assert_topk(got, want, q=None, db=None):
    """``q``/``db`` given: the l2 expansion's tolerance, scaled by
    |q|^2 + |c|^2 of each returned row."""
    gd, gi = (t.numpy() for t in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    if q is None:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
        return
    scale = (q * q).sum(1)[:, None] + (db * db).sum(1)[wi]
    assert (np.abs(gd - wd) <= 1e-5 * scale + 1e-6).all()


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("b,n,d,k", [
    (9, 300, 16, 7), (1, 50, 784, 10),
    # kernel D's tile edges: 128 queries, 128 rows and 32 columns a step,
    # each passed by one
    (129, 257, 785, 10), (129, 127, 595, 10), (7, 129, 33, 10)])
def test_matmul_topk_ref_matches_reference(metric, b, n, d, k):
    q, db = _inputs(b, n, d, seed=b + n)
    got = tref.matmul_topk_ref(torch.from_numpy(q), torch.from_numpy(db), k,
                               metric)
    want = jref.matmul_topk_ref(jnp.asarray(q), jnp.asarray(db), k,
                                metric=metric)
    _assert_topk(got, want, *((q, db) if metric == "l2" else ()))


@pytest.mark.parametrize("b,n,d,k", [(9, 300, 16, 7), (2, 40, 595, 10)])
def test_chi2_topk_ref_matches_reference(b, n, d, k):
    q, db = _inputs(b, n, d, seed=b * n, nonneg=True)
    got = tref.chi2_topk_ref(torch.from_numpy(q), torch.from_numpy(db), k)
    want = jref.chi2_topk_ref(jnp.asarray(q), jnp.asarray(db), k)
    _assert_topk(got, want)


@pytest.mark.parametrize("b,n,d,k", [(9, 300, 16, 7), (2, 40, 595, 10),
                                     (3, 5, 33, 4)])
def test_chi2_topk_dordered_matches_reference(b, n, d, k):
    """Kernel E's order of sums (each term added in d order) against the
    reference's plain scan; sparse rows, as the kernel's zero path sees."""
    q, db = _inputs(b, n, d, seed=b + n + d, nonneg=True)
    db[np.random.default_rng(d).uniform(size=db.shape) < 0.8] = 0.0
    got = tref.chi2_topk_dordered(torch.from_numpy(q), torch.from_numpy(db),
                                  k)
    want = jref.chi2_topk_ref(jnp.asarray(q), jnp.asarray(db), k)
    _assert_topk(got, want)


def _rounds(fn, k):
    """``fn(k, lower)`` (a plain scan) through the round loop at the
    kernels' list size K_MAX, each round after the last (score, id) of the
    one before."""
    def launch(kk, lower):
        d, i = fn(kk, lower)
        return d, i, (d, i)
    return topk_rounds(k, K_MAX, launch)


def _assert_prefix(got, small):
    """A round-served top-k's first columns are bitwise the small k's."""
    w = small[0].shape[1]
    assert torch.equal(got[0][:, :w].contiguous().view(torch.int32),
                       small[0].view(torch.int32))
    assert torch.equal(got[1][:, :w], small[1])


@pytest.mark.parametrize("k", [129, 300])
@pytest.mark.parametrize("scan", ["l2", "dot", "chi2", "chi2_dordered"])
def test_scan_refs_rounds_match_reference(scan, k):
    """k above the kernels' list (K_MAX = 128): kernels D's and E's plain
    versions (and E's d-ordered one) through the round loop equal the
    reference's one-pass scan at k, past N too (+inf / -1), and their
    first 10 columns are bitwise their own k = 10 output."""
    q, db = _inputs(4, 280, 12, seed=k, nonneg=True)
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    if scan in ("l2", "dot"):
        def fn(kk, lower=None):
            return tref.matmul_topk_ref(tq, tdb, kk, scan, lower)
        want = jref.matmul_topk_ref(jnp.asarray(q), jnp.asarray(db), k,
                                    metric=scan)
    else:
        plain = (tref.chi2_topk_ref if scan == "chi2"
                 else tref.chi2_topk_dordered)

        def fn(kk, lower=None):
            return plain(tq, tdb, kk, lower)
        want = jref.chi2_topk_ref(jnp.asarray(q), jnp.asarray(db), k)
    got = _rounds(fn, k)
    w = min(k, 280)                       # the reference keeps min(k, N)
    _assert_topk((got[0][:, :w], got[1][:, :w]), want,
                 *((q, db) if scan == "l2" else ()))
    assert np.isinf(got[0].numpy()[:, w:]).all()
    assert (got[1].numpy()[:, w:] == -1).all()
    _assert_prefix(got, fn(10))


@pytest.mark.parametrize("k", [129, 300])
@pytest.mark.parametrize("metric", ["l2", "dot", "chi2", "cosine"])
def test_fused_scan_ref_rounds_match_reference(metric, k):
    """The bruteforce scan's plain version (kernel B's over arange(N), dead
    rows -1) through the round loop at k equals the reference's gather over
    the same ids in one pass, with +inf / -1 past the 80% live rows, and
    its first 10 columns are bitwise its own k = 10 output."""
    q, db = _inputs(5, 330, 16, seed=k + 1, nonneg=metric == "chi2")
    valid = np.random.default_rng(k).uniform(size=330) < 0.8
    tq, tdb, tv = map(torch.from_numpy, (q, db, valid))

    def fn(kk, lower=None):
        return tref.fused_scan_ref(tq, tdb, kk, metric, tv, lower)

    ids = np.where(valid, np.arange(330, dtype=np.int32), -1)
    want = jref.fused_gather_topk_ref(jnp.asarray(q),
                                      jnp.asarray(np.tile(ids, (5, 1))),
                                      jnp.asarray(db), k, metric)
    got = _rounds(fn, k)
    _assert_topk(got, want)
    assert int((got[1] >= 0).sum(1).max()) == min(k, int(valid.sum()))
    _assert_prefix(got, fn(10))


def _special_floats(n, seed):
    """float32 values from a seed over many binades, with +-0, negatives,
    subnormals, +-inf, NaN and the values where q + 1e-12 is 0 or tiny."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, size=n)
    expo = rng.integers(-149, 128, size=n).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], size=n)
    with np.errstate(over="ignore"):
        x = (sign * mant * 2.0 ** expo).astype(np.float32)
    eps = np.float32(1e-12)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        1e-40, -1e-40, 1.17549435e-38, eps, -eps,
                        np.nextafter(-eps, 0), np.nextafter(-eps, -1),
                        np.finfo(np.float32).max, -np.finfo(np.float32).max],
                       dtype=np.float32)
    return torch.from_numpy(np.concatenate([x, special]))


@pytest.mark.parametrize("c", [0.0, -0.0])
def test_chi2_term_against_a_zero_row_element_is_the_querys_own(c):
    """Kernel E's zero path: for c = +0 or -0 the term t = q - c;
    t * t / ((q + c) + 1e-12) is q * q / (q + 1e-12) bit for bit, for
    every float q."""
    q = _special_floats(200_000, seed=14)
    cc = torch.full_like(q, c)
    t = q - cc
    full = t * t / (q + cc + 1e-12)
    own = q * q / (q + 1e-12)
    assert torch.equal(full.view(torch.int32), own.view(torch.int32))
    assert int(torch.isnan(own).sum()) > 0 and int(torch.isinf(own).sum()) > 0


def test_streamed_scans_keep_the_smaller_id_on_ties(monkeypatch):
    """A db of repeated rows scanned in blocks of a few rows: the merged
    top-k equals the reference's single lexsort, ties to the smaller id."""
    q, base = _inputs(5, 7, 12, seed=3, nonneg=True)
    db = np.concatenate([base, base, base])           # row i == i + 7 == i + 14
    monkeypatch.setattr(tref, "GATHER_BUDGET_BYTES", 4 * 5 * 12 * 4)
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    jq, jdb = jnp.asarray(q), jnp.asarray(db)
    _assert_topk(tref.chi2_topk_ref(tq, tdb, 9), jref.chi2_topk_ref(jq, jdb, 9))
    _assert_topk(tref.matmul_topk_ref(tq, tdb, 9, "dot"),
                 jref.matmul_topk_ref(jq, jdb, 9, metric="dot"))
    _, i = tref.matmul_topk_ref(tq, tdb, 9, "l2")
    assert (np.diff(i.numpy()[:, :3]) == 7).all()       # copies, in id order


def test_scan_refs_pad_past_n():
    """k > N: the slots past N are +inf / -1 (the plain version's contract,
    which the port's kernels follow)."""
    q, db = _inputs(3, 4, 8, seed=2, nonneg=True)
    for got in (tref.chi2_topk_ref(torch.from_numpy(q), torch.from_numpy(db), 6),
                tref.matmul_topk_ref(torch.from_numpy(q), torch.from_numpy(db),
                                     6, "l2")):
        assert np.isinf(got[0].numpy()[:, 4:]).all()
        assert (got[1].numpy()[:, 4:] == -1).all()
        assert np.isfinite(got[0].numpy()[:, :4]).all()


@pytest.mark.parametrize("metric", ["l2", "chi2"])
def test_scan_kernels_pallas_interpret_case(metric):
    q, db = _inputs(3, 40, 8, seed=9, nonneg=True)
    if metric == "chi2":
        from repro.kernels.chi2_topk import chi2_topk as pallas
        want = pallas(jnp.asarray(q), jnp.asarray(db), 5, bn=16,
                      interpret=True)
        got = chi2_topk(torch.from_numpy(q), torch.from_numpy(db), 5)
        _assert_topk(got, want)
    else:
        from repro.kernels.matmul_topk import matmul_topk as pallas
        want = pallas(jnp.asarray(q), jnp.asarray(db), 5, bn=16,
                      interpret=True)
        got = matmul_topk(torch.from_numpy(q), torch.from_numpy(db), 5)
        _assert_topk(got, want, q, db)


def test_ops_topk_dispatch_and_mode():
    q, db = _inputs(2, 30, 6, seed=4, nonneg=True)
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    LAUNCHES.clear()
    REF_CALLS.clear()
    for metric in ("l2", "dot", "chi2"):
        ops.topk(tq, tdb, 3, metric)
    assert REF_CALLS == {"matmul_topk": 2, "chi2_topk": 1} and not LAUNCHES
    with pytest.raises(ValueError, match="l2 or dot"):
        ops.topk(tq, tdb, 3, "cosine")
    for mode in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.topk(tq, tdb, 3, "chi2", mode=mode)


# ---------------------------------------------------------------------------
# exact_knn with db_chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "chi2"])
def test_exact_knn_db_chunk_matches_reference(metric):
    q, db = _inputs(6, 120, 10, seed=11, nonneg=metric == "chi2")
    want = j_exact_knn(jnp.asarray(q), jnp.asarray(db), 7, metric=metric,
                       db_chunk=30)
    for chunk in (0, 30, 40):
        got = exact_knn(torch.from_numpy(q), torch.from_numpy(db), 7, metric,
                        db_chunk=chunk)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of db_chunk"):
        exact_knn(torch.from_numpy(q), torch.from_numpy(db), 7, metric,
                  db_chunk=50)


# ---------------------------------------------------------------------------
# the bruteforce backend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def brute_indexes():
    q, db = _inputs(13, 700, 20, seed=21)
    jidx = jindex.build_index(jax.random.key(0), db,
                              jindex.IndexSpec(backend="bruteforce"))
    tidx = tindex.build_index(db, tindex.IndexSpec(backend="bruteforce"),
                              device="cpu")
    return q, db, jidx, tidx


@pytest.mark.parametrize("kw", [dict(k=6), dict(k=6, metric="ip"),
                                dict(k=4, metric="dot", chunk=97),
                                dict(k=5, n_probes=3, n_trees=2, expand=2),
                                dict(k=129), dict(k=129, chunk=50)])
def test_bruteforce_matches_reference(brute_indexes, kw):
    q, db, jidx, tidx = brute_indexes
    want = jidx.search(q, jindex.SearchParams(**dict(kw, mode="ref")))
    got = tidx.search(q, tindex.SearchParams(**kw))
    _assert_topk(got, want)
    _assert_topk(got, exact_knn(torch.from_numpy(q), torch.from_numpy(db),
                                kw["k"], kw.get("metric", "l2")))


@pytest.mark.parametrize("n,k,chunk", [(700, 129, 0), (50, 129, 0),
                                        (700, 129, 60), (700, 6, 97)])
def test_brute_force_topk_with_valid_matches_reference(brute_indexes, n, k,
                                                       chunk):
    """``brute_force_topk`` with a row mask (every 7th row dead) against the
    reference's at k = 129, with N < k (+inf / -1 past the live rows) and
    with a chunk, which changes nothing in the answer."""
    from repro.index.segments import brute_force_topk as j_brute
    q, db, _, _ = brute_indexes
    db = np.ascontiguousarray(db[:n])
    valid = np.arange(n) % 7 != 0
    want = j_brute(jnp.asarray(q), jnp.asarray(db),
                   jindex.SearchParams(k=k, chunk=chunk, mode="ref"),
                   valid=jnp.asarray(valid))
    got = brute_force_topk(torch.from_numpy(q), torch.from_numpy(db),
                           tindex.SearchParams(k=k, chunk=chunk),
                           valid=torch.from_numpy(valid))
    _assert_topk(got, want)
    assert not bool((got[1] % 7 == 0).any())
    _assert_prefix(got, brute_force_topk(
        torch.from_numpy(q), torch.from_numpy(db), tindex.SearchParams(k=6),
        valid=torch.from_numpy(valid)))


def test_bruteforce_pads_past_n_and_takes_valid():
    q, db = _inputs(4, 6, 5, seed=8)
    idx = tindex.build_index(db, tindex.IndexSpec(backend="bruteforce"),
                             device="cpu")
    d, i = idx.search(q, k=9)
    assert np.isinf(d.numpy()[:, 6:]).all() and (i.numpy()[:, 6:] == -1).all()
    valid = torch.tensor([True, False, True, True, False, True])
    d, i = idx.engine.search(torch.from_numpy(q), tindex.SearchParams(k=6),
                             valid=valid)
    assert set(i.numpy()[:, :4].ravel()) <= {0, 2, 3, 5}
    assert (i.numpy()[:, 4:] == -1).all()


# ---------------------------------------------------------------------------
# the ISS-595 copies
# ---------------------------------------------------------------------------


def test_iss_like_and_config_match_reference():
    from repro.configs import rpf_iss595 as j_cfg
    for got, want in zip(iss_like(150, n_test=6, d=40, n_models=5, seed=3),
                         j_iss_like(150, n_test=6, d=40, n_models=5, seed=3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tuple(t_cfg.CONFIG) == tuple(j_cfg.CONFIG)
    assert (t_cfg.N_DB, t_cfg.DIM, t_cfg.METRIC, t_cfg.L_SWEEP,
            t_cfg.N_TEST, t_cfg.N_MODELS) == \
        (j_cfg.N_DB, j_cfg.DIM, j_cfg.METRIC, j_cfg.L_SWEEP, j_cfg.N_TEST,
         j_cfg.N_MODELS)
    assert t_cfg.QUERY_BATCH == dict(
        (c.name, c.batch) for c in j_cfg.CELLS)["query_batch"]
