"""The traced window's reduction on a synthetic trace: busy time as the
union of device intervals, kernels by name, the per-layer readers, and the
breakdown's idle gaps labelled by what the host was doing."""
import pytest

from bench import manifest, trace

B = "void fused_gather_topk_kernel<0, true>(float const*)"
A = "void forest_traverse_kernel<3, 1024>(int const*)"
SORT = "void at::native::radixSortKVInPlace<2>()"
COPY = "Memcpy DtoH (Device -> Pinned)"


def observation(**kw):
    # two batches in a 100 us window: A 10-20, a sort 15-25 (overlapping),
    # B 30-70, a copy 70-75, then A 80-85 and B 85-95; idle 0-10, 25-30,
    # 75-80 and 95-100
    ops = [(A, 10, 20), (SORT, 15, 25), (B, 30, 70), (COPY, 70, 75),
           (A, 80, 85), (B, 85, 95)]
    args = dict(kind="search", units=2, window=(0.0, 100.0), device_ops=ops)
    args.update(kw)
    return trace.Observation(**args)


def test_union_and_kernels():
    obs = observation()
    assert trace.merged(obs.device_ops) == [(10, 25), (30, 75), (80, 95)]
    assert obs.busy_us() == 15 + 45 + 15
    assert len(obs.kernels) == 5
    assert obs.kernel_us("fused_gather_topk") == 50


def read(name, obs):
    return manifest.metric_reader(name)(obs)


def test_search_readers():
    obs = observation(host={"enqueue_ms": 0.5},
                      work={"rerank_least_s": 10e-6, "step_least_s": 20e-6})
    assert read("idle_share.search", obs) == pytest.approx(25.0)
    assert read("launches_per_batch", obs) == 2.5
    assert read("descent_ms", obs) == pytest.approx(0.0075)
    assert read("glue_ms", obs) == pytest.approx(0.005)
    assert read("rerank_roofline", obs) == pytest.approx(20.0)
    assert read("search_roofline", obs) == pytest.approx(20.0)
    assert read("enqueue_ms", obs) == 0.5
    for name in ("idle_share.build", "build_device_ms", "build_launches"):
        assert read(name, obs) is None


def test_nothing_to_read_gives_nothing():
    empty = observation(device_ops=[], window=(0.0, 0.0))
    for m in ("rerank_roofline", "search_roofline", "descent_ms",
              "idle_share.search", "launches_per_batch", "glue_ms"):
        assert read(m, empty) is None, m
    build = observation(kind="build", units=1)
    assert read("build_launches", build) == 5
    assert read("build_device_ms", build) == pytest.approx(0.075)
    assert read("rerank_roofline", build) is None


def test_breakdown_labels_gaps_by_host_activity():
    host = [("bench.search", 0, 12), ("aten::sort", 2, 8),
            ("bench.wait", 25, 31), ("cudaEventSynchronize", 26, 30),
            ("bench.search", 76, 81)]
    obs = observation(gaps=((0.0, 100.0), observation().device_ops, host))
    out = trace.breakdown(obs)
    gaps = dict(out["idle_gaps"])
    assert gaps["bench.search > aten::sort"] == pytest.approx(10e-6)
    assert gaps["bench.wait > cudaEventSynchronize"] == pytest.approx(5e-6)
    assert gaps["bench.search"] == pytest.approx(5e-6)
    assert gaps["host"] == pytest.approx(5e-6)
    ops = dict(out["device_ops"])
    assert ops[B] == pytest.approx(50e-6) and len(out["device_ops"]) == 4
