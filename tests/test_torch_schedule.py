"""The port's query knobs against the reference: per-query probe schedules
(``core/schedule.py``), early-exit tree waves (``core/adaptive.py``), the
engines' counters, ``tune`` and the retune after churn.

The port's forests are the reference's bit for bit (its draws injected), so
every search must give the reference's ids, with distances within rtol
1e-5 / atol 1e-6.  A schedule stops a query when its k-th distance improves
by less than ``tol``: the two packages compute that improvement from
distances that differ in the last bits, so widths, probes and trees are
held equal for every query (or wave) whose reference improvement lies more
than 1e-4 (relative) from ``tol``; the rest are counted and printed.  The
port is held to the reference's output, never to the plateau property of
``tests/test_probe_schedule.py::test_converged_query_oracle``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro.core import adaptive as jadaptive
from repro.core import forest as jforest
from repro.core import pipeline as jpipeline
from repro.core import quantized as jquantized
from repro.core import schedule as jschedule
from repro.data.synthetic import clustered_gaussians
from repro.filter import Eq as JEq
from repro_torch import index as tindex
from repro_torch.core import adaptive as tadaptive
from repro_torch.core import forest as tforest
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import quantized as tquantized
from repro_torch.core import schedule as tschedule
from repro_torch.filter import Eq as TEq

# the modules (``repro*.index.tune`` is also the name of the function)
jtune = importlib.import_module("repro.index.tune")
ttune = importlib.import_module("repro_torch.index.tune")

N, D, K, B = 1000, 24, 10, 32
CAP = 6
RTOL, ATOL = 1e-5, 1e-6
NEAR = 1e-4          # relative distance from tol that counts as "at" it
JCFG = jforest.ForestConfig(n_trees=8, capacity=12)
TCFG = tforest.ForestConfig(n_trees=8, capacity=12)


def _reference_draws(key, n):
    rc = JCFG.resolved(n)
    draws = jax.jit(jforest._batched_level_draws(
        jax.random.split(key, rc.n_trees), rc, D, "compat"))
    return lambda level: tuple(np.array(a) for a in draws(level))


def _segment_draws(key):
    """The reference's stream of every build: key for sid 0 (the first
    build and compaction), fold_in(key, sid) for a seal."""
    return tindex.SegmentDraws(lambda sid, n: _reference_draws(
        key if sid == 0 else jax.random.fold_in(key, sid), n))


@pytest.fixture(scope="module")
def corpus():
    db = clustered_gaussians(N, D, n_clusters=16, seed=0)
    rng = np.random.default_rng(1)
    q = (db[rng.integers(0, N, B)]
         + 0.05 * rng.normal(size=(B, D))).astype(np.float32)
    key = jax.random.key(0)
    jf = jforest.build_forest(key, jnp.asarray(db), JCFG)
    tf = tforest.build_forest(torch.from_numpy(db), TCFG,
                              draws=_reference_draws(key, N), device="cpu")
    return db, q, jf, tf


def _sources(db, quantized):
    if quantized:
        return (jquantized.quantize_db(jnp.asarray(db)),
                tquantized.quantize_db(torch.from_numpy(db)))
    return jnp.asarray(db), torch.from_numpy(db)


def _assert_rows(got, want, rows=None):
    """Port (dists, ids) tensors against the reference's arrays, on
    ``rows`` (all by default): ids equal, distances within rtol / atol."""
    gd, gi = (t.numpy() for t in got)
    wd, wi = (np.asarray(a) for a in want)
    rows = np.arange(gd.shape[0]) if rows is None else rows
    np.testing.assert_array_equal(gi[rows], wi[rows])
    np.testing.assert_allclose(gd[rows], wd[rows], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def test_probe_widths_and_improvement_match_reference():
    for cap in range(1, 41):
        assert tschedule.probe_widths(cap) == jschedule.probe_widths(cap)
    for mod in (tschedule, jschedule):
        with pytest.raises(ValueError, match="cap"):
            mod.probe_widths(0)
    inf = np.inf
    prev = np.array([inf, inf, 0.0, 0.0, 2.0, 2.0, 2.0, -4.0, -4.0, 1e-30,
                     3.0, -0.0], np.float32)
    kth = np.array([1.0, inf, 0.0, -1.0, 1.0, 2.0, 3.0, -5.0, -3.0, 0.0,
                    inf, -1.0], np.float32)
    got = tschedule._improvement(prev, kth)
    want = jschedule._improvement(prev, kth)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    # signed metrics: the denominator is |prev|; inf prev never converges;
    # no improvement (or a regression) reads 0, so tol = 0 stops nothing
    assert got[0] == inf and got[4] == 0.5 and got[6] == 0.0
    assert got[7] == pytest.approx(0.25) and got[8] == 0.0


def _reference_kths(jf, q, src, quantized, widths):
    """The reference's k-th distance of every query at every width (full
    batch, as its rounds compute them)."""
    out = []
    for w in widths:
        d, _ = jpipeline.fused_query(jf, jnp.asarray(q), src, K, JCFG,
                                     mode="ref", n_probes=w)
        out.append(np.asarray(d[:, -1]))
    return out


def _near_queries(kths, final, widths, tol):
    """Queries some round of which (up to their final width, in the
    reference) improved by within NEAR (relative) of ``tol``."""
    near = np.zeros(final.shape[0], bool)
    if tol <= 0.0:
        return near
    for r in range(1, len(widths)):
        reached = final >= widths[r]
        imp = jschedule._improvement(kths[r - 1], kths[r])
        near |= reached & (np.abs(imp - tol) <= NEAR * tol)
    return near


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["rpf", "rpf+int8"])
@pytest.mark.parametrize("tol", [0.01, 0.0])
def test_scheduled_query_matches_reference(corpus, quantized, tol):
    db, q, jf, tf = corpus
    jsrc, tsrc = _sources(db, quantized)
    jd, ji, jfinal, jproc = jschedule.scheduled_query(
        jf, jnp.asarray(q), jsrc, K, JCFG, cap=CAP, tol=tol, mode="ref")
    td, ti, tfinal, tproc = tschedule.scheduled_query(
        tf, torch.from_numpy(q), tsrc, K, TCFG, cap=CAP, tol=tol,
        device="cpu")
    widths = jschedule.probe_widths(CAP)
    near = _near_queries(_reference_kths(jf, q, jsrc, quantized, widths),
                         np.asarray(jfinal), widths, tol)
    print(f"queries within {NEAR} (relative) of tol={tol}: "
          f"{int(near.sum())} of {B}")
    far = np.flatnonzero(~near)
    np.testing.assert_array_equal(tfinal[far], np.asarray(jfinal)[far])
    np.testing.assert_array_equal(tproc[far], np.asarray(jproc)[far])
    _assert_rows((td, ti), (jd, ji), far)
    assert tfinal.dtype == tproc.dtype == np.int32
    if tol == 0.0:
        assert (tfinal == CAP).all()
        assert (tproc == sum(widths)).all()
    else:
        assert tfinal.min() < CAP       # some query stopped early


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["rpf", "rpf+int8"])
def test_scheduled_at_tol_zero_is_the_fixed_cap_bitwise(corpus, quantized):
    db, q, _, tf = corpus
    _, tsrc = _sources(db, quantized)
    valid = torch.from_numpy(np.arange(N) % 7 != 3)
    for kw in (dict(), dict(valid=valid)):
        d, i, _, _ = tschedule.scheduled_query(
            tf, torch.from_numpy(q), tsrc, K, TCFG, cap=CAP, tol=0.0,
            device="cpu", **kw)
        fd, fi = tpipeline.fused_query(tf, torch.from_numpy(q), tsrc, K,
                                       TCFG, n_probes=CAP, device="cpu",
                                       **kw)
        assert torch.equal(i, fi)
        assert torch.equal(d.view(torch.int32), fd.view(torch.int32))


# ---------------------------------------------------------------------------
# early-exit waves
# ---------------------------------------------------------------------------


def _reference_wave_improvements(jf, q, db, wave):
    """The reference's relative improvement of the mean k-th distance after
    each wave (its adaptive loop, every wave run)."""
    best_d = jnp.full((q.shape[0], K), jnp.inf)
    best_i = jnp.full((q.shape[0], K), -1, jnp.int32)
    prev, out = None, []
    for w0 in range(0, JCFG.n_trees, wave):
        sub = jax.tree.map(lambda a: a[w0:w0 + wave], jf)
        d, i = jpipeline.fused_query(sub, jnp.asarray(q), jnp.asarray(db),
                                     K, JCFG, mode="ref")
        best_d, best_i = jadaptive._merge_dedup(best_d, best_i, d, i, K)
        last = best_d[:, -1]
        kth = float(jnp.mean(jnp.where(jnp.isfinite(last), last, 0.0)))
        out.append(None if prev is None or prev <= 0
                   else (prev - kth) / prev)
        prev = kth
    return out


@pytest.mark.parametrize("wave,tol,n_probes", [
    (3, 0.0, 1), (3, 0.01, 1), (2, 0.05, 2), (3, 0.2, 1)])
def test_adaptive_query_matches_reference(corpus, wave, tol, n_probes):
    db, q, jf, tf = corpus
    jd, ji, jused = jadaptive.adaptive_query(
        jf, jnp.asarray(q), jnp.asarray(db), K, JCFG, wave=wave, tol=tol,
        mode="ref", n_probes=n_probes)
    td, ti, tused = tadaptive.adaptive_query(
        tf, torch.from_numpy(q), torch.from_numpy(db), K, TCFG, wave=wave,
        tol=tol, n_probes=n_probes, device="cpu")
    if n_probes == 1:
        imps = [x for x in _reference_wave_improvements(jf, q, db, wave)
                if x is not None]
        near = [x for x in imps if tol > 0 and abs(x - tol) <= NEAR * tol]
        print(f"waves within {NEAR} (relative) of tol={tol}: {len(near)}")
        if near:
            return
    assert tused == jused
    _assert_rows((td, ti), (jd, ji))
    if tol == 0.0:
        assert tused == JCFG.n_trees


def test_merge_dedup_matches_reference():
    rng = np.random.default_rng(3)
    d1 = np.sort(rng.integers(0, 5, (6, 4)).astype(np.float32), 1)
    d2 = np.sort(rng.integers(0, 5, (6, 4)).astype(np.float32), 1)
    i1 = rng.integers(-1, 6, (6, 4)).astype(np.int32)
    i2 = rng.integers(-1, 6, (6, 4)).astype(np.int32)
    d1[i1 < 0] = np.inf
    d2[i2 < 0] = np.inf
    want = jadaptive._merge_dedup(*map(jnp.asarray, (d1, i1, d2, i2)), 4)
    got = tadaptive._merge_dedup(*map(torch.from_numpy, (d1, i1, d2, i2)),
                                 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_forest_window_is_a_smaller_forest(corpus):
    _, q, _, tf = corpus
    win = tf.window(3, 6)
    assert win.n_trees == 3
    for a, b in zip(win, tf):
        assert torch.equal(a, b[3:6]) and a.is_contiguous()
    assert tf.window(6, 100).n_trees == 2
    got = tforest.traverse_forest(win, torch.from_numpy(q),
                                  TCFG.resolved(N).max_depth, 2)
    want = tforest.traverse_forest(tf, torch.from_numpy(q),
                                   TCFG.resolved(N).max_depth, 2)[3:6]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# through the index: dispatch, counters, tune, retune
# ---------------------------------------------------------------------------


def _indexes(db, backend, **kw):
    key = jax.random.key(0)
    jspec = jindex.IndexSpec(backend=backend, forest=JCFG)
    tspec = tindex.IndexSpec(backend=backend, forest=TCFG)
    jidx = jindex.build_index(key, db, jspec, **kw)
    tidx = tindex.build_index(db, tspec, device="cpu",
                              draws=_segment_draws(key), **kw)
    return jidx, tidx


@pytest.mark.parametrize("backend", ["rpf", "rpf+int8"])
def test_engine_counters_after_each_kind_of_search(corpus, backend):
    db, q, _, _ = corpus
    jidx, tidx = _indexes(db, backend)
    assert tidx.last_trees_used == jidx.last_trees_used == JCFG.n_trees
    assert tidx.last_mean_probes == jidx.last_mean_probes == 0.0
    for kw in (dict(n_probes=2, n_trees=5),
               dict(probe_schedule=CAP, tol=0.0),
               dict(adaptive_wave=3, tol=0.0, n_probes=2, n_trees=7)):
        want = jidx.search(q, jindex.SearchParams(k=K, mode="ref", **kw))
        got = tidx.search(q, tindex.SearchParams(k=K, **kw))
        _assert_rows(got, want)
        assert tidx.last_trees_used == jidx.last_trees_used, kw
        assert tidx.last_mean_probes == jidx.last_mean_probes, kw
    with pytest.raises(tindex.CapabilityError, match="probe_schedule"):
        tidx.search(q, tindex.SearchParams(probe_schedule=4,
                                           adaptive_wave=2))


TUNE = dict(target_recall=0.9, probe_grid=(1, 4), tree_fracs=(0.5, 1.0),
            expand_grid=(2, 4))
# each forest backend's grid walks one of the two measured-cost axes
AXES = {"rpf": dict(adaptive_waves=(0, 2)),
        "rpf+int8": dict(schedule_grid=(0, 4)), "bruteforce": {}}


def _rows(report):
    return [(r["params"].to_dict(), r["recall"], r["cost"],
             r["meets_target"]) for r in report]


@pytest.mark.parametrize("backend", ["rpf", "rpf+int8", "bruteforce"])
def test_tune_chooses_the_reference_params(corpus, backend):
    db, q, _, _ = corpus
    jidx, tidx = _indexes(db, backend)
    kw = dict(TUNE, **AXES[backend])
    jp, jrep = jindex.tune_report(jidx, q, **kw)
    tp, trep = tindex.tune_report(tidx, q, **kw)
    assert tp.to_dict() == jp.to_dict()
    assert _rows(trep) == _rows(jrep)
    assert tidx.tuned_params == tp
    assert tidx._tuned_n_live == jidx._tuned_n_live == N
    # the same index and queries choose the same params again
    assert tindex.tune(tidx, q, **kw) == tp
    # and a bare search now applies them
    _assert_rows(tidx.search(q), jidx.search(q))


def test_cost_models_match_reference(corpus):
    db, _, _, _ = corpus
    jidx, tidx = _indexes(db, "rpf+int8")
    for kw in (dict(), dict(n_probes=4, n_trees=3), dict(probe_schedule=6),
               dict(adaptive_wave=2, n_probes=2), dict(expand=0)):
        jp = jindex.SearchParams(**kw)
        tp = tindex.SearchParams(**kw)
        assert ttune._static_cost(tidx, tp, K) == \
            jtune._static_cost(jidx, jp, K)
        assert ttune._measured_cost(tidx, tp, K) == \
            jtune._measured_cost(jidx, jp, K)
    grid_args = (K, "l2", "auto", (1, 3), (0.5, 1.0), (0, 4), (2, 4),
                 (0, 4))
    for j, t in zip(jtune._candidate_grid(jidx, *grid_args),
                    ttune._candidate_grid(tidx, *grid_args)):
        assert t.to_dict() == j.to_dict()


def test_compaction_after_churn_retunes(corpus):
    db, q, _, _ = corpus
    jidx, tidx = _indexes(db, "rpf")
    kw = dict(TUNE, tree_fracs=(1.0,))
    assert tindex.tune(tidx, q, **kw).to_dict() == \
        jindex.tune(jidx, q, **kw).to_dict()
    # 20% churn: compaction keeps the tuned point
    for idx in (jidx, tidx):
        idx.delete(list(range(0, 200)))
        idx.compact()
    assert tidx.stats()["n_retunes"] == jidx.stats()["n_retunes"] == 0
    # more than 25% since the tune: the compaction retunes
    for idx in (jidx, tidx):
        idx.delete(list(range(200, 300)))
        idx.compact()
    assert tidx.stats()["n_retunes"] == jidx.stats()["n_retunes"] == 1
    assert tidx.tuned_params.to_dict() == jidx.tuned_params.to_dict()
    assert tidx._tuned_n_live == jidx._tuned_n_live == N - 300
    _assert_rows(tidx.search(q), jidx.search(q))


def test_schedule_under_filter_on_a_tombstoned_index(corpus):
    """The reference's composition case (tests/test_probe_schedule.py): a
    schedule at tol 0 under a filter on a tombstoned index is bitwise the
    fixed cap, and answers as the reference does."""
    db, q, _, _ = corpus
    meta = {"shop": np.array([f"s{i % 4}" for i in range(N)])}
    jidx, tidx = _indexes(db, "rpf", metadata=meta)
    for idx in (jidx, tidx):
        idx.delete(list(range(0, 200)))
    fixed = dict(k=K, n_probes=CAP)
    sched = dict(k=K, probe_schedule=CAP, tol=0.0)
    dw, iw = tidx.search(q, tindex.SearchParams(filter=TEq("shop", "s1"),
                                                **fixed))
    dg, ig = tidx.search(q, tindex.SearchParams(filter=TEq("shop", "s1"),
                                                **sched))
    assert torch.equal(ig, iw)
    assert torch.equal(dg.view(torch.int32), dw.view(torch.int32))
    surfaced = ig[ig >= 0]
    assert bool((surfaced >= 200).all()) and bool((surfaced % 4 == 1).all())
    want = jidx.search(q, jindex.SearchParams(
        filter=JEq("shop", "s1"), mode="ref", **sched))
    _assert_rows((dg, ig), want)
