"""The port's autoscaler, fleet and fleet.yml config held against the
reference's (``repro.serve.autoscaler`` / ``repro.serve.config``).

The control loop runs on both packages under one fake clock, one fake
fleet and the same demand ticks, and must record the same decisions
(``history``: action, replicas, reason and the numbers behind them).  The
live tests serve a port index on the CPU and assert counts and answers,
never a wall-clock time.
"""
import sys

import numpy as np
import pytest

from repro.serve import autoscaler as jauto
from repro.serve import config as jconfig
from repro.serve.planner import TrafficModel as JTrafficModel
from repro.serve.planner import rated_qps as j_rated_qps
from repro_torch import index as tindex
from repro_torch.core import forest as tforest
from repro_torch.serve import autoscaler as tauto
from repro_torch.serve import config as tconfig
from repro_torch.serve.planner import TrafficModel, rated_qps
from repro_torch.serve.runtime import ServingRuntime

# affine model: t(b) = 1ms + 1ms*b, 2ms batching wait
MODEL_KW = dict(c0_s=0.001, c1_s=0.001, max_wait_s=0.002,
                batch_grid=(1, 8, 32), measured_s=(), rows_per_query=1.0)
SLO_MS = 50.0
BATCH = 32
RATED1 = rated_qps(TrafficModel(**MODEL_KW), SLO_MS, BATCH)
PACKAGES = {"reference": (jauto, JTrafficModel), "port": (tauto,
                                                          TrafficModel)}


class _FakeFleet:
    """Counter-driven fleet stand-in: the scenario feeds the counters."""

    def __init__(self, clock):
        self.n = 1
        self.total = 0
        self.depth = 0
        self.degraded = 0
        self.resize_log: list[tuple[float, int]] = []
        self.clock = clock

    @property
    def n_replicas(self) -> int:
        return self.n

    def scale_to(self, n, batch=None):
        self.resize_log.append((self.clock(), n))
        self.n = n
        return n

    def stats(self) -> dict:
        return {"requests_total": self.total, "depth": self.depth,
                "requests_degraded": self.degraded}


def _loop(pkg, **cfg_kw):
    auto, model_cls = PACKAGES[pkg]
    kw = dict(slo_p99_ms=SLO_MS, max_replicas=8, cooldown_s=1.0,
              scale_down_cooldown_s=4.0, demand_smoothing=1.0)
    kw.update(cfg_kw)
    t = [0.0]
    ff = _FakeFleet(lambda: t[0])
    a = auto.Autoscaler(ff, model_cls(**MODEL_KW), auto.AutoscalerConfig(**kw),
                        batch=BATCH, clock=lambda: t[0])
    return a, ff, t


def _tick(a, ff, t, dt, demand_qps, shed=0.0):
    """Advance the fake clock one control period under ``demand_qps``:
    completions up to capacity, the excess piling into the queue; ``shed``
    of the window's completions counted as degraded."""
    t[0] += dt
    cap = ff.n * RATED1
    served = min(demand_qps, cap)
    ff.total += int(served * dt)
    ff.degraded += int(shed * served * dt)
    if demand_qps > cap:
        ff.depth += int((demand_qps - cap) * dt)
    else:
        ff.depth = max(0, ff.depth - int((cap - demand_qps) * dt))
    return a.step()


# (ticks of (dt, demand as a multiple of one replica's rated qps, shed
# fraction), config overrides): the reference's scenarios and more
SCENARIOS = {
    "burst then calm": ([(0.25, 2.0, 0.0)] * 12 + [(0.25, 0.2, 0.0)] * 32,
                        {}),
    "dead band then panic": ([(0.25, 1.10, 0.0), (0.25, 1.10, 0.2)], {}),
    "cooldown defers": ([(0.25, 2.0, 0.0)] + [(0.25, 4.0, 0.0)] * 4, {}),
    "calm restarts": ([(0.25, 2.0, 0.0)] * 8 + [(0.25, 0.2, 0.0)] * 8
                      + [(0.25, 2.2, 0.0)] + [(0.25, 0.2, 0.0)] * 18, {}),
    "infeasible pins the ceiling": (
        [(0.25, 50.0, 0.0)] * 4,
        dict(max_replicas=2, cooldown_s=0.0)),
    "smoothing and hysteresis": (
        [(0.1, m, s) for m, s in ((0.5, 0.0), (3.0, 0.0), (3.0, 0.01),
                                  (6.0, 0.3), (6.0, 0.0), (1.0, 0.0),
                                  (0.1, 0.0), (0.1, 0.0))] * 6,
        dict(demand_smoothing=0.5, hysteresis=0.3, cooldown_s=0.3,
             scale_down_cooldown_s=1.0, shed_panic=0.1, min_replicas=2,
             max_replicas=5)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_equal_the_reference(name):
    ticks, cfg = SCENARIOS[name]
    runs = {}
    for pkg in PACKAGES:
        a, ff, t = _loop(pkg, **cfg)
        a.step()                                   # baseline tick
        for dt, mult, shed in ticks:
            _tick(a, ff, t, dt, mult * RATED1, shed)
        runs[pkg] = (a.history, ff.resize_log, a.stats())
    assert runs["port"] == runs["reference"]
    assert len(runs["port"][0]) == len(ticks) + 1


def test_burst_scales_up_then_cools_down():
    a, ff, t = _loop("port")
    a.step()
    for _ in range(12):
        _tick(a, ff, t, 0.25, 2.0 * RATED1)
    assert ff.n == 2
    up = next(d for d in a.history if d["action"] == "up")
    assert up["planned_batch"] == BATCH            # planned at the REAL batch
    for _ in range(32):
        _tick(a, ff, t, 0.25, 0.2 * RATED1)
    downs = [d for d in a.history if d["action"] == "down"]
    assert len(downs) == 1 and ff.n == 1
    ts = [d["t"] for d in a.history if d["action"] != "hold"]
    assert all(b - x >= a.config.cooldown_s for x, b in zip(ts, ts[1:]))
    assert a.stats()["scale_ups"] == 1 and a.stats()["scale_downs"] == 1


def test_dead_band_holds_and_panic_overrides():
    a, ff, t = _loop("port")
    a.step()
    assert _tick(a, ff, t, 0.25, 1.10 * RATED1)["action"] == "hold"
    ff.degraded += int(0.2 * RATED1 * 0.25)
    d = _tick(a, ff, t, 0.25, 1.10 * RATED1)
    assert d["action"] == "up" and d["reason"] == "panic"


def test_rated_qps_matches_the_reference_model():
    assert RATED1 == j_rated_qps(JTrafficModel(**MODEL_KW), SLO_MS, BATCH)
    assert rated_qps(TrafficModel(**MODEL_KW), SLO_MS, 8) > 2.0 * RATED1


def test_autoscaler_config_dicts_cross_packages():
    kw = dict(slo_p99_ms=25.0, hysteresis=0.2, min_replicas=2,
              cooldown_s=0.5)
    tc, jc = tauto.AutoscalerConfig(**kw), jauto.AutoscalerConfig(**kw)
    assert tc.to_dict() == jc.to_dict()
    assert tauto.AutoscalerConfig.from_dict(jc.to_dict()) == tc
    assert jauto.AutoscalerConfig.from_dict(tc.to_dict()) == jc
    # fleet.yml keys that are not control knobs are dropped
    loose = {"slo_p99_ms": 25.0, "enabled": True, "qps": 500.0,
             "hysteresis": 0.2}
    assert tauto.AutoscalerConfig.from_dict(loose).to_dict() == \
        jauto.AutoscalerConfig.from_dict(loose).to_dict()


# ---------------------------------------------------------------------------
# fleet.yml: PyYAML and the fallback parser
# ---------------------------------------------------------------------------

FLEET_YML = """\
# fleet.yml
index: {manifest}
serving:
  slo_p99_ms: 25.0
  max_batch: 16          # the batch the replicas serve at
  max_wait_s: 0.002
  degrade: {degrade}
  use_tuned: yes
mesh: {mesh}
autoscale:
  enabled: {enabled}
  qps: 120.0
  min_replicas: 1
  max_replicas: 3
  cooldown_s: 0.5
  hysteresis: 1e-1
  note: 'quoted # not a comment'
"""
TEXTS = [FLEET_YML.format(manifest="runs/w.idx", degrade="true", mesh="",
                          enabled="false"),
         FLEET_YML.format(manifest='"/tmp/a b.idx"', degrade="off",
                          mesh="", enabled="on"),
         "index: x.idx\nmesh:\n  shape: [4, 2]\n  axes: ['data', 'model']\n",
         "serving:\n  slo_p99_ms: 50\n  qps: ~\nautoscale:\n"]


@pytest.mark.parametrize("text", TEXTS)
def test_fallback_parser_equals_the_reference(text):
    assert tconfig._parse_simple_yaml(text) == \
        jconfig._parse_simple_yaml(text)


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("parser", ["pyyaml", "fallback"])
def test_load_config_equals_the_reference(tmp_path, monkeypatch, text,
                                          parser):
    path = tmp_path / "fleet.yml"
    path.write_text(text)
    if parser == "pyyaml":
        pytest.importorskip("yaml")
    else:
        monkeypatch.setitem(sys.modules, "yaml", None)   # import fails
    got = tconfig.load_config(str(path))
    assert got and got == jconfig.load_config(str(path))


def test_fallback_parser_reads_the_schema():
    cfg = tconfig._parse_simple_yaml(TEXTS[0])
    assert cfg["index"] == "runs/w.idx"
    assert cfg["serving"]["max_batch"] == 16
    assert cfg["serving"]["degrade"] is True
    assert cfg["autoscale"]["enabled"] is False
    assert cfg["mesh"] is None
    cfg = tconfig._parse_simple_yaml(TEXTS[2])
    assert cfg["mesh"] == {"shape": [4, 2], "axes": ["data", "model"]}


# ---------------------------------------------------------------------------
# a live fleet on the CPU
# ---------------------------------------------------------------------------

class _StubIndex:
    """Index stand-in: answers (zeros, arange(k)) as torch tensors."""

    def __init__(self):
        self.spec = tindex.IndexSpec(
            backend="rpf", forest=tforest.ForestConfig(n_trees=8))
        self.tuned_params = tindex.SearchParams(k=5, n_probes=8)
        self.shard_params = None
        self.serving_plan = None
        self.searched = []

    def search(self, q, params):
        import torch
        self.searched.append(q.shape[0])
        n = q.shape[0]
        return (torch.zeros(n, params.k),
                torch.arange(params.k, dtype=torch.int32).repeat(n, 1))

    def live_points(self):
        return np.arange(64), np.zeros((64, 4), np.float32)


def test_replica_fleet_dispatch_scale_and_monotone_stats():
    idx = _StubIndex()
    fleet = tauto.ReplicaFleet(lambda batch=None: ServingRuntime(
        idx, max_batch=int(batch or 8), max_wait_s=0.001), n_replicas=2)
    try:
        q = np.zeros(4, np.float32)
        d, i = fleet(q)
        assert i.tolist() == [0, 1, 2, 3, 4] and d.shape == (5,)
        for _ in range(20):
            fleet(q)
        before = fleet.stats()
        assert before["n_replicas"] == 2
        assert before["requests_total"] == 21
        fleet.scale_to(1)                         # the retiree's counters fold
        fleet(q)
        after = fleet.stats()
        assert after["n_replicas"] == 1
        assert after["requests_total"] == 22
        assert len(fleet.resizes) == 1
        fleet.scale_to(3, batch=4)
        assert fleet.n_replicas == 3
        assert sorted(r.max_batch for r in fleet.replicas) == [4, 4, 8]
        assert all(b in (4, 8) for b in idx.searched)   # padded batches
    finally:
        fleet.stop()
    assert fleet.n_replicas == 0


@pytest.fixture(scope="module")
def port_index():
    from repro_torch.data.synthetic import clustered_gaussians
    db = clustered_gaussians(600, 8, n_clusters=8, seed=0)
    return db, tindex.build_index(
        db, tindex.IndexSpec(backend="rpf", forest=tforest.ForestConfig(
            n_trees=4, capacity=32)), device="cpu")


def test_build_fleet_serves_and_autoscales(port_index):
    db, idx = port_index
    model = TrafficModel(c0_s=0.001, c1_s=0.0001, max_wait_s=0.002,
                         batch_grid=(16,), measured_s=(), rows_per_query=1.0)
    cfg = {"serving": {"slo_p99_ms": 25.0, "max_batch": 16},
           "autoscale": {"enabled": True, "qps": 50.0, "max_replicas": 3,
                         "cooldown_s": 0.5, "interval_s": 0.05}}
    handle = tconfig.build_fleet(cfg, index=idx, model=model)
    try:
        assert handle.autoscaler is not None
        assert handle.plan is not None and handle.plan.n_replicas >= 1
        assert handle.fleet.n_replicas == handle.plan.n_replicas
        want_d, want_i = idx.search(db[:3], tindex.SearchParams())
        for j in range(3):
            d, i = handle(db[j], timeout=60.0)
            np.testing.assert_array_equal(i, want_i[j].numpy())
            np.testing.assert_array_equal(d, want_d[j].numpy())
        assert handle.autoscaler.step()["action"] in ("hold", "up", "down")
    finally:
        handle.stop()


def test_build_fleet_from_saved_manifest_calibrates(port_index, tmp_path):
    db, idx = port_index
    root = str(tmp_path / "idx")
    idx.save(root)
    path = tmp_path / "fleet.yml"
    # a CPU's SLO, so that the calibrated model always has a plan
    path.write_text(f"index: {root}\nserving:\n  slo_p99_ms: 5000.0\n"
                    "  max_batch: 8\nautoscale:\n  qps: 40.0\n"
                    "  max_replicas: 2\n")
    handle = tconfig.build_fleet(str(path), device="cpu")
    try:
        assert handle.autoscaler is None          # autoscale not enabled
        assert handle.model is not None and handle.model.c1_s > 0
        assert handle.plan is not None
        assert 1 <= handle.fleet.n_replicas <= 2
        assert handle.index.device.type == "cpu"
        d, i = handle(np.asarray(db[0], np.float32), timeout=60.0)
        assert int(i[0]) == 0 and float(d[0]) == 0.0
    finally:
        handle.stop()
    with pytest.raises(ValueError, match="index"):
        tconfig.build_fleet({"serving": {"slo_p99_ms": 25.0}})

