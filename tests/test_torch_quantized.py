"""The port's int8 path held against the reference's: ``quantize_db``, the
int8 kernel's plain version, ``rerank_fused_quantized`` and the ``rpf+int8``
index, on the same numpy inputs.

Tolerances: ``q8`` and ``scale`` are bitwise equal (one division, one
round-half-to-even, one clip).  Distances agree within rtol 1e-5 / atol
1e-6, because XLA and PyTorch sum the d terms in other orders (and cosine
takes its norms through other primitives); ids are equal on tie-free data.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro.core import forest as jforest
from repro.core import pipeline as jpipe
from repro.core import quantized as jquant
from repro.data.synthetic import clustered_gaussians
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch import index as tindex
from repro_torch.core import forest as tforest
from repro_torch.core import pipeline as tpipe
from repro_torch.core import quantized as tquant
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.common import LAUNCHES, REF_CALLS, topk_rounds
from repro_torch.kernels.fused_query_int8 import (K_MAX,
                                                  fused_gather_topk_int8)

RTOL, ATOL = 1e-5, 1e-6
METRICS = ("l2", "dot", "chi2", "cosine")
N, D, K = 1500, 24, 5
CFG = dict(n_trees=6, capacity=10)


def _assert_topk(got, want):
    gd, gi = (t.numpy() for t in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)


def _both_qdb(x):
    return (jquant.quantize_db(jnp.asarray(x)),
            tquant.quantize_db(torch.from_numpy(x)))


@pytest.mark.parametrize("shape,spread", [((400, 37), 1.0), ((64, 784), 50.0),
                                          ((30, 5), 1e-3)])
def test_quantize_db_is_bitwise(shape, spread):
    """Rows of widely different scales, one all-zero row (scale 1e-12)."""
    rng = np.random.default_rng(shape[0])
    x = (rng.normal(size=shape) * rng.uniform(0, spread, size=(shape[0], 1))
         ).astype(np.float32)
    x[3] = 0.0
    jq, tq = _both_qdb(x)
    assert tq.q.dtype == torch.int8
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy().view(np.uint32),
                                  np.asarray(jq.scale).view(np.uint32))
    assert tq.fp is not None and tq.fp.shape == shape


def _int8_inputs(b, m, n, d, holes, seed, nonneg=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    if nonneg:
        x, q = np.abs(x), np.abs(q)
    ids = rng.integers(0, n, size=(b, m)).astype(np.int32)
    ids[rng.uniform(size=(b, m)) < holes] = -1
    ids[0, 2:] = -1                  # row 0: fewer valid slots than k
    return q, ids, x


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,m,k", [(11, 70, 6), (3, 40, 40)])
def test_int8_ref_matches_reference(metric, b, m, k):
    q, ids, x = _int8_inputs(b, m, 300, 24, 0.3, seed=b + m + k,
                             nonneg=metric == "chi2")
    jq, tq = _both_qdb(x)
    got = tref.fused_gather_topk_int8_ref(torch.from_numpy(q),
                                          torch.from_numpy(ids), tq.q,
                                          tq.scale, k, metric)
    want = jref.fused_gather_topk_int8_ref(jnp.asarray(q), jnp.asarray(ids),
                                           jq.q, jq.scale, k, metric)
    _assert_topk(got, want)
    assert np.isinf(got[0].numpy()[0, 2:]).all()
    assert (got[1].numpy()[0, 2:] == -1).all()


@pytest.mark.parametrize("metric", ["l2", "chi2"])
@pytest.mark.parametrize("k", [129, 300])
def test_int8_ref_rounds_match_reference(metric, k):
    """k' = 4 k above the kernel's list (K_MAX = 512): the plain version
    through the round loop equals the reference at k' in one pass, and its
    first 10 columns are bitwise its own k' = 10 output."""
    kp = 4 * k
    q, ids, x = _int8_inputs(3, kp + 100, 2000, 16, 0.1, seed=k,
                             nonneg=metric == "chi2")
    jq, tq = _both_qdb(x)
    tqq, tids = torch.from_numpy(q), torch.from_numpy(ids)
    got = topk_rounds(kp, K_MAX, lambda kk, lower:
                      tref.fused_gather_topk_int8_ref(
                          tqq, tids, tq.q, tq.scale, kk, metric, lower,
                          keys=True))
    want = jref.fused_gather_topk_int8_ref(jnp.asarray(q), jnp.asarray(ids),
                                           jq.q, jq.scale, kp, metric)
    _assert_topk(got, want)
    small = tref.fused_gather_topk_int8_ref(tqq, tids, tq.q, tq.scale, 10,
                                            metric)
    assert torch.equal(got[0][:, :10].contiguous().view(torch.int32),
                       small[0].view(torch.int32))
    assert torch.equal(got[1][:, :10], small[1])


@pytest.mark.parametrize("scale", [
    1.0, 0.0078125, 3.7e-3, 0.1, 1.5, 123.456, -2.5e-2,
    # subnormal, the smallest normal, and huge (v * s overflows to inf)
    1e-45, 2.3e-41, 1.1754944e-38, 3.0e36, 3.4e38])
def test_int8_biased_float_conversion_is_exact(scale):
    """Kernel C's conversion of the int8 bytes of a 32-bit word (xor
    0x80808080, the byte in the mantissa of 2^23, less 2^23 + 128), done on
    uint32 views, gives np.float32(v) and then the same v * s bits, for all
    256 values."""
    v = np.arange(-128, 128, dtype=np.int8)
    words = v.view(np.uint32) ^ np.uint32(0x80808080)
    got = np.empty(256, dtype=np.float32)
    for j in range(4):                               # byte j of each word
        byte = (words >> np.uint32(8 * j)) & np.uint32(0xFF)
        biased = (np.uint32(0x4B000000) | byte).view(np.float32)
        got[j::4] = biased - np.float32(8388736.0)
    want = v.astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    s = np.float32(scale)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal((got * s).view(np.uint32),
                                      (want * s).view(np.uint32))


def test_int8_kernel_pallas_interpret_case():
    from repro.kernels.fused_query_int8 import fused_gather_topk_int8 as pallas
    q, ids, x = _int8_inputs(3, 40, 60, 8, 0.25, seed=5)
    jq, tq = _both_qdb(x)
    want = pallas(jnp.asarray(q), jnp.asarray(ids), jq.q, jq.scale, 5,
                  metric="l2", interpret=True)
    LAUNCHES.clear()
    REF_CALLS.clear()
    got = fused_gather_topk_int8(torch.from_numpy(q), torch.from_numpy(ids),
                                 tq.q, tq.scale, 5, "l2")
    _assert_topk(got, want)
    assert REF_CALLS == {"fused_gather_topk_int8": 1} and not LAUNCHES


@pytest.mark.parametrize("mode", ["kernel", "pallas"])
def test_int8_kernel_mode_on_cpu_tensors_raises(mode):
    q, ids, x = _int8_inputs(2, 10, 20, 4, 0.0, seed=2)
    tq = tquant.quantize_db(torch.from_numpy(x))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_rerank_int8(torch.from_numpy(q), torch.from_numpy(ids),
                              tq.q, tq.scale, 3, mode=mode)


# ---------------------------------------------------------------------------
# the two-stage rerank, on a reference forest's candidates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    x = clustered_gaussians(N, D, n_clusters=16, seed=0)
    jf = jforest.build_forest(jax.random.key(0), jnp.asarray(x),
                              jforest.ForestConfig(**CFG))
    tf = convert.forest_from_numpy(jax.device_get(jf), device="cpu")
    rng = np.random.default_rng(1)
    q = (x[rng.integers(0, N, 19)] + 0.5 * rng.normal(size=(19, D))
         ).astype(np.float32)
    rc = jforest.ForestConfig(**CFG).resolved(N)
    leaves = jforest.traverse(jf, jnp.asarray(q), rc.max_depth)
    ids, mask = jforest.gather_candidates(jf, leaves, rc.leaf_pad)
    valid = rng.uniform(size=N) > 0.2
    return x, q, jf, tf, np.array(ids), np.array(mask), valid


@pytest.mark.parametrize("expand", [2, 4])
@pytest.mark.parametrize("metric", ["l2", "chi2"])
@pytest.mark.parametrize("use_valid", [False, True])
def test_rerank_fused_quantized_matches_reference(setup, expand, metric,
                                                  use_valid):
    x, q, _, _, ids, mask, valid = setup
    if metric == "chi2":
        x, q = np.abs(x), np.abs(q)
    jq, tq = _both_qdb(x)
    jv = jnp.asarray(valid) if use_valid else None
    tv = torch.from_numpy(valid) if use_valid else None
    want = jpipe.rerank_fused_quantized(
        jnp.asarray(q), jnp.asarray(ids), jnp.asarray(mask), jq, K,
        expand=expand, metric=metric, mode="ref", valid=jv)
    targs = (torch.from_numpy(q), torch.from_numpy(ids),
             torch.from_numpy(mask), tq, K)
    for chunk in (0, 7, 45):          # 7 < k' is widened to k'
        got = tpipe.rerank_fused_quantized(*targs, expand=expand,
                                           metric=metric, chunk=chunk,
                                           valid=tv)
        _assert_topk(got, want)
    if use_valid:
        assert valid[got[1].numpy()[got[1].numpy() >= 0]].all()


def test_staged_quantized_oracle_matches_reference(setup):
    x, q, jf, tf, ids, mask, _ = setup
    jq, tq = _both_qdb(x)
    want = jquant.staged_rerank_quantized(jnp.asarray(q), jnp.asarray(ids),
                                          jnp.asarray(mask), jq, K, 3)
    got = tquant.staged_rerank_quantized(torch.from_numpy(q),
                                         torch.from_numpy(ids),
                                         torch.from_numpy(mask), tq, K, 3)
    _assert_topk(got, want)
    cfg = tforest.ForestConfig(**CFG)
    _assert_topk(tquant.staged_query_quantized(tf, torch.from_numpy(q), tq,
                                               K, cfg),
                 jquant.staged_query_quantized(jf, jnp.asarray(q), jq, K,
                                               jforest.ForestConfig(**CFG)))


# ---------------------------------------------------------------------------
# the rpf+int8 index, its forest carried across
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_indexes():
    db = clustered_gaussians(N, D, n_clusters=16, seed=3)
    rng = np.random.default_rng(4)
    q = (db[rng.integers(0, N, 21)] + 0.5 * rng.normal(size=(21, D))
         ).astype(np.float32)
    jspec = jindex.IndexSpec(backend="rpf+int8",
                             forest=jforest.ForestConfig(**CFG))
    jidx = jindex.build_index(jax.random.key(7), db, jspec)
    tspec = tindex.IndexSpec(backend="rpf+int8",
                             forest=tforest.ForestConfig(**CFG))
    tidx = convert.index_from_numpy(db, jax.device_get(jidx.forest), tspec,
                                    device="cpu", q8=jidx.qdb.q,
                                    scale=jidx.qdb.scale)
    return db, q, jidx, tidx, tspec


@pytest.mark.parametrize("kw", [
    dict(k=5), dict(k=5, expand=2, n_probes=3), dict(k=4, expand=1),
    dict(k=3, n_trees=3, metric="ip", chunk=11),
    dict(k=4, metric="cosine", dedup=False),
])
def test_int8_index_matches_reference(int8_indexes, kw):
    db, q, jidx, tidx, _ = int8_indexes
    want = jidx.search(q, jindex.SearchParams(**dict(kw, mode="ref")))
    got = tidx.search(q, tindex.SearchParams(**kw))
    _assert_topk(got, want)


def test_int8_index_carries_and_rebuilds_the_same_bits(int8_indexes):
    """The port's own build quantizes the rows to the reference's bits; a
    carried q8 that differs is refused."""
    db, q, jidx, tidx, tspec = int8_indexes
    own = tindex.build_index(db, tspec, device="cpu")
    assert torch.equal(own.qdb.q, tidx.qdb.q)
    assert torch.equal(own.qdb.scale, tidx.qdb.scale)
    bad = np.array(jidx.qdb.q)
    bad[0, 0] += 1
    with pytest.raises(ValueError, match="q8"):
        convert.index_from_numpy(db, jax.device_get(jidx.forest), tspec,
                                 device="cpu", q8=bad, scale=jidx.qdb.scale)
    with pytest.raises(ValueError, match="q8 and scale"):
        convert.index_from_numpy(db, jax.device_get(jidx.forest), tspec,
                                 device="cpu")
    # expand=0 constructs, as in the reference; the int8 search refuses
    # its k' = 0 shortlist with a ValueError, as the reference's does
    p = tindex.SearchParams(k=3, expand=0)
    with pytest.raises(ValueError, match="expand"):
        tidx.search(q, p)
    with pytest.raises(ValueError):
        jidx.search(q, jindex.SearchParams(k=3, expand=0, mode="ref"))
