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
from repro_torch.kernels.common import LAUNCHES, REF_CALLS
from repro_torch.kernels.matmul_topk import matmul_topk

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
@pytest.mark.parametrize("b,n,d,k", [(9, 300, 16, 7), (1, 50, 784, 10)])
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
                                dict(k=5, n_probes=3, n_trees=2, expand=2)])
def test_bruteforce_matches_reference(brute_indexes, kw):
    q, db, jidx, tidx = brute_indexes
    want = jidx.search(q, jindex.SearchParams(**dict(kw, mode="ref")))
    got = tidx.search(q, tindex.SearchParams(**kw))
    _assert_topk(got, want)
    _assert_topk(got, exact_knn(torch.from_numpy(q), torch.from_numpy(db),
                                kw["k"], kw.get("metric", "l2")))


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
