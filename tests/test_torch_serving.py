"""The port's serving front end held against the reference's
(``repro.serve``, ``repro.core.service``, ``repro.launch.serve``).

Host math (ladders, the planner, arrival schedules, the shed policy) must
be equal across packages; served answers, from one manifest the reference
saved, equal in ids with distances within rtol 1e-5 / atol 1e-6.  Thread
tests gate the batcher with events and assert no wall-clock time; the shed
policy runs over stubbed queue depths and service times.
"""
import dataclasses
import importlib
import threading

import jax
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
import repro.serve as jserve
from repro.core import forest as jforest
from repro.core.service import AnnService as JAnnService
from repro.serve import ann_serve as jann
from repro.serve import planner as jplanner
from repro.serve import runtime as jruntime
from repro_torch import index as tindex
from repro_torch import serve as tserve
from repro_torch.core import forest as tforest
from repro_torch.core.service import AnnService as TAnnService
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import ann_serve as tann
from repro_torch.serve import planner as tplanner
from repro_torch.serve import runtime as truntime

RTOL, ATOL = 1e-5, 1e-6
SEED = 0
PACKAGES = {"reference": (jserve, jindex), "port": (tserve, tindex)}


def _reference_draws(key, cfg, n, d):
    rc = cfg.resolved(n)
    draws = jax.jit(jforest._batched_level_draws(
        jax.random.split(key, rc.n_trees), rc, d, "compat"))
    return lambda level: tuple(np.array(a) for a in draws(level))


def _segment_draws(key, jcfg, dim):
    """The reference's stream of every build: key for the first build and
    compaction, fold_in(key, sid) for a seal."""
    return tindex.SegmentDraws(lambda sid, n: _reference_draws(
        key if sid == 0 else jax.random.fold_in(key, sid), jcfg, n, dim))


def _dicts(params):
    return [p.to_dict() for p in params]


def _assert_answers(got, want):
    """Lists of (dists (k,), ids (k,)) host pairs, one per request."""
    assert len(got) == len(want)
    for (td, ti), (jd, ji) in zip(got, want):
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(td, np.asarray(jd), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the ladder and the manifest's shard params
# ---------------------------------------------------------------------------

LADDER_GRID = [
    dict(n_probes=8), dict(n_probes=1), dict(n_probes=5, n_trees=6),
    dict(n_probes=4, adaptive_wave=2), dict(probe_schedule=8),
    dict(probe_schedule=4, n_probes=2, n_trees=12),
    dict(probe_schedule=3, adaptive_wave=4), dict(n_probes=2, expand=2),
    dict(n_probes=4, chunk=64, expand=8), dict(n_trees=2),
    dict(n_probes=16, k=5, metric="ip"),
]


@pytest.mark.parametrize("total_trees", [16, 7])
@pytest.mark.parametrize("kw", LADDER_GRID)
def test_ladder_and_cost_equal_the_reference(kw, total_trees):
    jp, tp = jindex.SearchParams(**kw), tindex.SearchParams(**kw)
    for max_rungs in (6, 2):
        jl = jruntime.build_ladder(jp, total_trees, max_rungs)
        tl = truntime.build_ladder(tp, total_trees, max_rungs)
        assert _dicts(tl) == _dicts(jl)
        assert [truntime._ladder_cost(p, total_trees) for p in tl] == \
            [jruntime._ladder_cost(p, total_trees) for p in jl]
    assert tl[0] == tp


@pytest.mark.parametrize("shards", [
    [dict(n_probes=2, expand=2, n_trees=4), dict(n_probes=8, expand=4)],
    [dict(n_probes=3, chunk=32, adaptive_wave=2)],
    [dict(k=5, probe_schedule=4), dict(k=5, chunk=16, n_probes=2),
     dict(k=5, expand=9, min_candidates=3)],
])
def test_uniform_shard_params_equal_the_reference(shards):
    jp = [jindex.SearchParams(**s) for s in shards]
    tp = [tindex.SearchParams(**s) for s in shards]
    assert truntime.uniform_shard_params(tp).to_dict() == \
        jruntime.uniform_shard_params(jp).to_dict()
    with pytest.raises(ValueError):
        truntime.uniform_shard_params([])


# ---------------------------------------------------------------------------
# the capacity planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid,lat", [
    ([1, 8, 32, 64], [2e-3 + 5e-5 * b for b in (1, 8, 32, 64)]),
    ([8], [4e-4]),
    ([1, 8, 32], [1.3e-3, 1.2e-3, 1.9e-3]),
    ([1, 4], [5e-3, 1e-3]),          # a falling fit clamps c1 to 1e-9
])
def test_fit_affine_equals_the_reference(grid, lat):
    assert tplanner.fit_affine(grid, lat) == jplanner.fit_affine(grid, lat)
    with pytest.raises(ValueError):
        tplanner.fit_affine([], [])


MODELS = [dict(c0_s=1e-3, c1_s=1e-4, max_wait_s=2e-3),
          dict(c0_s=4e-4, c1_s=2.5e-5, max_wait_s=2e-3, batch_grid=(1, 8),
               measured_s=(4.3e-4, 6e-4), rows_per_query=320.0),
          dict(c0_s=0.0, c1_s=3e-3, max_wait_s=5e-3)]


@pytest.mark.parametrize("mkw", MODELS)
def test_planner_math_equals_the_reference(mkw):
    jm, tm = jplanner.TrafficModel(**mkw), tplanner.TrafficModel(**mkw)
    for batch in (1, 8, 32, 64, 128):
        for shards in (1, 2, 4):
            assert tm.service_s(batch, shards) == jm.service_s(batch, shards)
            for qps in (10.0, 500.0, 4000.0, 1e6):
                assert tm.p99_s(qps, batch, shards) == \
                    jm.p99_s(qps, batch, shards)
            for slo in (1.0, 10.0, 25.0, 50.0):
                for util in (0.7, 1.0):
                    assert tplanner.rated_qps(tm, slo, batch, shards,
                                              util) == \
                        jplanner.rated_qps(jm, slo, batch, shards, util)
    for qps in (50.0, 2000.0, 40000.0):
        for slo in (5.0, 25.0, 100.0):
            for kw in ({}, {"max_shards": 1, "batch_grid": (8,)},
                       {"utilization": 0.5, "recall_target": 0.9}):
                try:
                    want = jplanner.plan(jm, qps, slo, **kw)
                except ValueError:
                    with pytest.raises(ValueError):
                        tplanner.plan(tm, qps, slo, **kw)
                    continue
                assert tplanner.plan(tm, qps, slo, **kw).to_dict() == \
                    want.to_dict()
    with pytest.raises(ValueError):
        tplanner.plan(tm, 0.0, 25.0)


def test_model_and_plan_dicts_cross_packages():
    for mkw in MODELS:
        jm, tm = jplanner.TrafficModel(**mkw), tplanner.TrafficModel(**mkw)
        assert tplanner.TrafficModel.from_dict(jm.to_dict()) == tm
        assert jplanner.TrafficModel.from_dict(tm.to_dict()) == jm
        d = dict(tm.to_dict(), unknown_key=1, batch_grid=list(tm.batch_grid))
        assert tplanner.TrafficModel.from_dict(d) == tm
    jp = jplanner.plan(jplanner.TrafficModel(**MODELS[1]), 3000.0, 25.0,
                       recall_target=0.95)
    tp = tplanner.CapacityPlan.from_dict(jp.to_dict())
    assert tp.to_dict() == jp.to_dict()
    assert jplanner.CapacityPlan.from_dict(tp.to_dict()) == jp


@pytest.mark.parametrize("qps,n,seed", [(500.0, 1000, 7), (3e4, 64, 0),
                                        (12.5, 1, 3), (900.0, 2, 11)])
def test_arrival_schedule_equals_the_reference_bitwise(qps, n, seed):
    got = tserve.arrival_schedule(qps, n, seed)
    want = jserve.arrival_schedule(qps, n, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tserve.arrival_schedule(0.0, n)


# ---------------------------------------------------------------------------
# the batcher's shutdown contract (both packages), gated by events
# ---------------------------------------------------------------------------

def _gated_echo():
    """A serve function that blocks its first batch until ``gate`` is set
    and signals ``started`` when that batch arrives."""
    started, gate = threading.Event(), threading.Event()

    def fn(batch):
        started.set()
        assert gate.wait(10.0)
        return list(batch)

    return fn, started, gate


def _stop_while_blocked(batcher, started, gate, drain):
    """stop() from another thread while the first batch is blocked, then
    release it: the stop lands with requests queued."""
    assert started.wait(10.0)
    th = threading.Thread(target=batcher.stop, kwargs={"drain": drain})
    th.start()
    assert batcher._stop.wait(10.0)
    gate.set()
    th.join(10.0)
    assert not th.is_alive()


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_stop_drain_serves_every_queued_request(pkg):
    serve = PACKAGES[pkg][0]
    fn, started, gate = _gated_echo()
    b = serve.DynamicBatcher(fn, max_batch=4, max_wait_s=0.001).start()
    reqs = [b.submit(j) for j in range(32)]
    _stop_while_blocked(b, started, gate, drain=True)
    assert all(r.event.is_set() for r in reqs)
    assert [r.result for r in reqs] == list(range(32))
    assert all(r.error is None for r in reqs)
    assert b.stats["stopped"] == "drained"
    assert b.stats["failed_on_stop"] == 0
    assert b.stats["requests"] == 32
    assert b.stats["drained_on_stop"] >= 32 - 4


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_stop_no_drain_fails_pending_fast(pkg):
    serve = PACKAGES[pkg][0]
    fn, started, gate = _gated_echo()
    b = serve.DynamicBatcher(fn, max_batch=4, max_wait_s=0.001).start()
    reqs = [b.submit(j) for j in range(32)]
    _stop_while_blocked(b, started, gate, drain=False)
    assert all(r.event.is_set() for r in reqs)          # nobody hangs
    failed = [r for r in reqs if r.error is not None]
    assert all(isinstance(r.error, serve.BatcherStopped) for r in failed)
    served = [r for r in reqs if r.error is None]
    assert 1 <= len(served) <= 4 and len(failed) == 32 - len(served)
    assert all(r.result == j for j, r in enumerate(served))
    assert b.stats["stopped"] == "failed"
    assert b.stats["failed_on_stop"] == len(failed)
    assert b.stats["requests"] == len(served)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_submit_after_stop_fails_fast(pkg):
    serve = PACKAGES[pkg][0]
    b = serve.DynamicBatcher(lambda batch: list(batch), max_batch=4).start()
    assert b(5) == 5
    b.stop()
    req = b.submit(1)
    assert req.event.is_set() and isinstance(req.error, serve.BatcherStopped)
    with pytest.raises(serve.BatcherStopped):
        b(2)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_concurrent_submitters_never_hang_across_stop(pkg):
    serve = PACKAGES[pkg][0]
    fn, started, gate = _gated_echo()
    b = serve.DynamicBatcher(fn, max_batch=8, max_wait_s=0.001).start()
    outcomes, lock = [], threading.Lock()
    submitted = threading.Semaphore(0)

    def client(i):
        submitted.release()
        try:
            out = ("ok", b(i, timeout=10.0))
        except serve.BatcherStopped:
            out = ("stopped", i)
        with lock:
            outcomes.append(out)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for _ in threads:
        assert submitted.acquire(timeout=10.0)
    _stop_while_blocked(b, started, gate, drain=False)
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive()           # the contract: no submitter hangs
    assert len(outcomes) == 24
    assert all(kind in ("ok", "stopped") for kind, _ in outcomes)
    assert sorted(i for _, i in outcomes) == list(range(24))


def test_a_serve_error_reaches_every_request_of_its_batch():
    """A kernel error in the worker is the request's error, re-raised to
    its caller: nothing serves it from a plain version."""
    def fn(batch):
        raise RuntimeError("kernel launch failed")

    b = tserve.DynamicBatcher(fn, max_batch=4, max_wait_s=0.001).start()
    reqs = [b.submit(j) for j in range(3)]
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        b(9, timeout=10.0)
    b.stop()
    assert all(r.event.wait(10.0) and isinstance(r.error, RuntimeError)
               for r in reqs)


# ---------------------------------------------------------------------------
# the shed policy over stubbed depths and service times
# ---------------------------------------------------------------------------

class _StubIndex:
    """What a runtime reads of an index at stand-up (nothing is served)."""

    def __init__(self, index_mod, forest_mod, tuned):
        self.spec = index_mod.IndexSpec(
            backend="rpf", forest=forest_mod.ForestConfig(n_trees=16))
        self.tuned_params = index_mod.SearchParams(**tuned)
        self.shard_params = None
        self.serving_plan = None


def _stub_runtime(pkg, **kw):
    serve, index_mod = PACKAGES[pkg]
    forest_mod = jforest if pkg == "reference" else tforest
    rt = serve.ServingRuntime(_StubIndex(index_mod, forest_mod,
                                         dict(k=5, n_probes=8)),
                              warmup=False, **kw)
    rt.stop()                             # the worker is not needed
    return rt


@pytest.mark.parametrize("slo,max_batch,wait,service", [
    (25.0, 64, 0.002, [0.0021, 0.0013, 0.0009, 0.0006, 0.0004, 0.0003]),
    (50.0, 8, 0.002, [0.016, 0.008, 0.004, 0.002, 0.0015, 0.001]),
    (5.0, 32, 0.002, [0.004, 0.003, 0.002, 0.001, 0.001, 0.001]),
    (None, 16, 0.002, [0.001] * 6),
    (25.0, 64, 0.002, [0.0] * 6),         # never warmed: the fallback
])
def test_shed_policy_equals_the_reference(slo, max_batch, wait, service):
    depths = [0, 3, 700, 900, 5000, 5000, 5000, 5000, 5000, 5000, 400, 200,
              10, 0, 0, 0, 0, 0, 0, 2000, 1, 0]
    runs = {}
    for pkg in PACKAGES:
        rt = _stub_runtime(pkg, slo_p99_ms=slo, max_batch=max_batch,
                           max_wait_s=wait)
        assert len(rt.ladder) == 6
        rt._service_s = list(service)
        rt._shed_depth = rt._derive_shed_depth()
        it = iter(depths)
        rt._batcher.depth = lambda it=it: next(it)
        rungs = [rt._schedule_rung() for _ in depths]
        st = rt.stats()
        runs[pkg] = (rt.shed_depth, rungs, st["shed_steps"],
                     st["recover_steps"])
    assert runs["port"] == runs["reference"]
    assert max(runs["port"][1]) > 0 and runs["port"][1][-1] < 5


# ---------------------------------------------------------------------------
# served answers: one manifest the reference saved, served by both
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(shared_builds):
    db = np.asarray(shared_builds.clustered_db(2000, 16, n_clusters=16,
                                               seed=SEED))
    q = db[np.random.default_rng(1).integers(0, len(db), 32)] + 0.003
    return db, np.asarray(q, np.float32)


PLAN = {"plan": {"qps": 400.0, "slo_p99_ms": 30.0, "n_shards": 1,
                 "n_replicas": 1, "batch": 16,
                 "rated_qps_per_replica": 700.0, "predicted_p99_ms": 11.0,
                 "utilization": 0.7, "recall_target": 0.9},
        "traffic_model": {"c0_s": 1e-3, "c1_s": 2e-5, "max_wait_s": 2e-3,
                          "batch_grid": [1, 8], "measured_s": [1e-3, 1.2e-3],
                          "rows_per_query": 32.0}}


@pytest.fixture(scope="module")
def manifest(corpus, tmp_path_factory):
    db, _ = corpus
    jidx = jindex.build_index(
        jax.random.key(SEED), db,
        jindex.IndexSpec(backend="rpf", forest=jforest.ForestConfig(
            n_trees=8, capacity=32)))
    jidx.tuned_params = jindex.SearchParams(k=10, n_probes=4)
    jidx.serving_plan = PLAN
    path = str(tmp_path_factory.mktemp("serve") / "idx")
    jidx.save(path)
    return path


@pytest.fixture(scope="module")
def runtimes(manifest):
    jrt = jserve.ServingRuntime.load(manifest, warmup=False)
    trt = tserve.ServingRuntime.load(manifest, device="cpu")
    yield jrt, trt
    jrt.stop()
    trt.stop()


def test_load_takes_the_plan_and_the_same_ladder(runtimes):
    jrt, trt = runtimes
    assert trt.max_batch == jrt.max_batch == 16
    assert trt.slo_p99_ms == jrt.slo_p99_ms == 30.0
    assert trt.params == tindex.SearchParams(k=10, n_probes=4)
    assert _dicts(trt.ladder) == _dicts(jrt.ladder)
    assert [p.n_probes for p in trt.ladder] == [4, 2, 1, 1, 1]
    assert [p.n_trees for p in trt.ladder] == [0, 0, 0, 4, 2]
    assert tserve.ServingRuntime.manifest_plan(trt.index).to_dict() == \
        jserve.ServingRuntime.manifest_plan(jrt.index).to_dict()
    assert tserve.ServingRuntime.manifest_traffic_model(
        trt.index).to_dict() == \
        jserve.ServingRuntime.manifest_traffic_model(jrt.index).to_dict()
    warm = trt.stats()["service_s_by_rung"]
    assert len(warm) == 5 and all(t > 0 for t in warm)
    assert trt.shed_depth >= trt.max_batch


def _serve(serve, index, rung_params, queries, max_batch):
    rt = serve.ServingRuntime(index, ladder=(rung_params,), warmup=False,
                              max_batch=max_batch)
    try:
        reqs = [rt.submit(q) for q in queries]
        for r in reqs:
            assert r.event.wait(60.0) and r.error is None
        st = rt.stats()
    finally:
        rt.stop()
    assert st["requests_total"] == len(queries)
    assert sum(st["batches_by_rung"]) == st["batcher"]["batches"]
    return [r.result for r in reqs]


@pytest.mark.parametrize("rung", range(5))
def test_every_rung_serves_the_reference_answers(runtimes, corpus, rung):
    jrt, trt = runtimes
    _, q = corpus
    got = _serve(tserve, trt.index, trt.ladder[rung], q, trt.max_batch)
    want = _serve(jserve, jrt.index, jrt.ladder[rung], q, jrt.max_batch)
    assert all(isinstance(d, np.ndarray) and isinstance(i, np.ndarray)
               for d, i in got)
    _assert_answers(got, want)


def test_served_answers_are_the_direct_search_bitwise(runtimes, corpus):
    """Padding repeats the last query and every rpf query is answered on
    its own, so each served answer is its row of one direct search."""
    _, trt = runtimes
    _, q = corpus
    d, i = trt.index.search(q, trt.ladder[0])
    got = [trt(x, timeout=60.0) for x in q[:5]]
    for j, (gd, gi) in enumerate(got):
        np.testing.assert_array_equal(gi, i[j].numpy())
        np.testing.assert_array_equal(gd, d[j].numpy())


# ---------------------------------------------------------------------------
# the legacy bridge, the retrieval merge and the AnnService shim
# ---------------------------------------------------------------------------

def test_make_ann_server_and_retrieval_match_the_reference(runtimes, corpus):
    jrt, trt = runtimes
    _, q = corpus
    _, jb = jann.make_ann_server(None, None, k=6, max_batch=8,
                                 index=jrt.index)
    tidx, tb = tann.make_ann_server(None, None, k=6, max_batch=8,
                                    index=trt.index)
    try:
        assert tidx is trt.index
        want = [jb(x, timeout=60.0) for x in q[:10]]
        got = [tb(x, timeout=60.0) for x in q[:10]]
    finally:
        jb.stop()
        tb.stop()
    _assert_answers(got, want)
    interests = q[:12].reshape(4, 3, 16)
    td, ti = tann.retrieval_via_index(trt.index, interests, k=5)
    jd, ji = jann.retrieval_via_index(jrt.index, interests, k=5)
    assert td.shape == ti.shape == (4, 5)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=RTOL, atol=ATOL)


def test_ann_service_matches_the_reference_through_its_lifecycle(corpus):
    db, q = corpus
    db = db[:300]
    jcfg = jforest.ForestConfig(n_trees=4, capacity=24)
    tcfg = tforest.ForestConfig(n_trees=4, capacity=24)
    js = JAnnService(db, jcfg, seed=3)
    ts = TAnnService(db, tcfg, seed=3, device="cpu",
                     draws=_segment_draws(jax.random.key(3), jcfg, 16))

    def same():
        assert ts.stats() == js.stats()
        td, ti = ts.query(q, k=7)
        jd, ji = js.query(q, k=7)
        assert isinstance(td, np.ndarray)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(td, np.asarray(jd), rtol=RTOL, atol=ATOL)

    rows = q[:12] + 0.01
    assert [ts.insert(r) for r in rows] == [js.insert(r) for r in rows]
    assert ts.delete([1, 5, 301, 305]) == js.delete([1, 5, 301, 305])
    assert ts.upsert(9, rows[3]) == js.upsert(9, rows[3])
    same()
    ts.compact()
    js.compact()
    same()
    np.testing.assert_array_equal(ts.db.numpy(), np.asarray(js.db))
    td, ti = tann.retrieval_via_index(ts, q[:6].reshape(2, 3, 16), k=4)
    jd, ji = jann.retrieval_via_index(js, q[:6].reshape(2, 3, 16), k=4)
    np.testing.assert_array_equal(ti, ji)


def test_a_bad_operating_point_fails_at_stand_up(runtimes):
    _, trt = runtimes
    with pytest.raises(tindex.CapabilityError, match="serving"):
        tserve.ServingRuntime(trt.index, params=tindex.SearchParams(
            metric="hamming"), warmup=False)
    bad = dataclasses.replace(tindex.SearchParams(), probe_schedule=2,
                              adaptive_wave=4)
    with pytest.raises(tindex.CapabilityError):
        tserve.ServingRuntime(trt.index, params=bad, warmup=False)


# ---------------------------------------------------------------------------
# the launcher, in-process on the CPU
# ---------------------------------------------------------------------------

# a CPU's SLO: the calibrated floor c0 on a loaded CPU can pass 25 ms,
# where the planner would refuse every plan
SMALL = ["--device", "cpu", "--n-db", "600", "--n-queries", "24",
         "--trees", "4", "--max-batch", "8", "--k", "5",
         "--slo-p99-ms", "5000"]


def test_launcher_build_load_and_config_branches(tmp_path, capsys):
    idx = str(tmp_path / "idx")
    built = tlaunch.main(SMALL + ["--requests", "40", "--save", idx,
                                  "--qps", "400"])
    loaded = tlaunch.main(SMALL + ["--requests", "24", "--load", idx,
                                   "--qps", "400"])
    fleet = tmp_path / "fleet.yml"
    fleet.write_text(f"index: {idx}\nserving:\n  slo_p99_ms: 5000.0\n"
                     "  max_batch: 8\nautoscale:\n  enabled: true\n"
                     "  qps: 100.0\n  max_replicas: 2\n")
    config = tlaunch.main(SMALL + ["--requests", "24", "--config",
                                   str(fleet), "--qps", "400"])
    swept = tlaunch.main(SMALL + ["--requests", "16", "--load", idx,
                                  "--sweep", "300,900"])
    for rep, n in ((built, 40), (loaded, 24), (config, 24)):
        assert rep["n_ok"] == n and rep["n_failed"] == rep["n_timeout"] == 0
        assert 0.0 <= rep["recall_vs_oracle"] <= 1.0
    assert [r["offered_qps"] for r in swept] == [300.0, 900.0]
    assert all(r["n_ok"] == 16 for r in swept)
    out = capsys.readouterr().out
    assert "[serve] manifest ->" in out and "traffic model from manifest" \
        in out and "[serve] fleet from" in out and "[sweep]" in out
    loaded_index = tindex.load_index(idx, device="cpu")
    assert loaded_index.tuned_params is not None
    assert loaded_index.serving_plan["plan"]["slo_p99_ms"] == 5000.0


def test_importing_the_launcher_runs_nothing(capsys):
    before = threading.active_count()
    importlib.reload(tlaunch)
    assert threading.active_count() == before
    assert capsys.readouterr().out == ""


def test_port_results_live_on_the_host(runtimes, corpus):
    _, trt = runtimes
    _, q = corpus
    d, i = trt(q[0], timeout=60.0)
    assert d.dtype == np.float32 and i.dtype == np.int32
    assert not isinstance(d, torch.Tensor)
