"""The readers of the program's spans (``repro_torch/tracing.py``):
``api_host_ms``, ``pipeline_host_ms`` and ``kernel_host_ms`` split the
traced ``index.search`` time by layer, ``build_levels`` counts the
builder's levels and ``build_sync_idle_ms`` the device idle its syncs
cause; each gives nothing where the program has no spans.  On the card:
the program's spans leave no device event behind."""
import pytest

from bench import manifest, trace

SEARCH = ("api_host_ms", "pipeline_host_ms", "kernel_host_ms")
BUILD = ("build_levels", "build_sync_idle_ms")
PROGRAM = ("index.search", "pipeline.query", "pipeline.descend",
           "pipeline.slice", "pipeline.dedup", "pipeline.rerank",
           "kernel.forest_traverse", "kernel.fused_gather_topk",
           "build.forest", "build.level", "build.draws", "build.sync")
K = "void kernel()"


def read(name, obs):
    return manifest.metric_reader(name)(obs)


def search_host(t0: float) -> list:
    """One batch's host ops from ``t0``: index.search 50 us, of which the
    pipeline 40, of which the kernels' wrappers 5 + 10."""
    spans = [("bench.search", 0, 51), ("index.search", 0, 50),
             ("aten::empty", 1, 2), ("pipeline.query", 5, 45),
             ("pipeline.descend", 6, 15), ("kernel.forest_traverse", 7, 12),
             ("cudaLaunchKernel", 8, 11), ("pipeline.slice", 15, 20),
             ("pipeline.dedup", 20, 28), ("aten::sort", 21, 27),
             ("pipeline.rerank", 28, 44),
             ("kernel.fused_gather_topk", 30, 40)]
    return [(n, t0 + s, t0 + e) for n, s, e in spans]


def search_obs(host) -> trace.Observation:
    return trace.Observation("search", 2, (0.0, 120.0), [(K, 10, 100)],
                             gaps=((0.0, 120.0), [(K, 10, 100)], host))


def build_obs(host, kind="build") -> trace.Observation:
    # device busy 0-20, 30-62, 80-100, 120-150, 160-170 of a 200 us span:
    # gaps start at 20, 62, 100, 150 and 170
    ops = [(K, 0, 20), (K, 30, 60), ("Memcpy DtoH (Device -> Pageable)",
                                     60, 62),
           (K, 80, 100), (K, 120, 150), (K, 160, 170)]
    return trace.Observation(kind, 2, (0.0, 200.0), ops,
                             gaps=((0.0, 200.0), ops, host))


BUILD_HOST = [
    ("bench.build", 0, 96), ("build.forest", 0, 95),
    ("build.sync", 15, 25),           # gap 20-30 begins inside: 10
    ("build.level", 25, 90), ("build.draws", 26, 29),
    ("build.sync", 55, 75),           # gap 62-80 begins inside: 18
    ("aten::bincount", 56, 74),
    ("bench.build", 100, 196), ("build.forest", 100, 195),
    ("build.level", 101, 140), ("build.level", 141, 190),
    ("build.sync", 140, 145),         # no gap begins inside
    ("build.sync", 170, 171)]         # gap 170-200 begins inside: 30


def test_search_readers_split_index_search_by_layer():
    obs = search_obs(search_host(0) + search_host(60))
    api, pipe, kern = (read(name, obs) for name in SEARCH)
    assert api == pytest.approx(0.010)
    assert pipe == pytest.approx(0.025)
    assert kern == pytest.approx(0.015)
    assert api + pipe + kern == pytest.approx(0.050)   # index.search
    for name in BUILD:
        assert read(name, obs) is None, name


def test_build_readers_count_levels_and_sync_idle():
    obs = build_obs(BUILD_HOST)
    assert read("build_levels", obs) == 1.5
    assert read("build_sync_idle_ms", obs) == pytest.approx(0.029)
    for name in SEARCH:
        assert read(name, obs) is None, name


def test_the_profilers_own_ops_count_in_no_layer():
    """The profiler's buffer requests and flushes stall the host inside
    whatever span is open; each split reading leaves them out, clipped at
    the spans' edges, and a sync's gap that begins inside one is not the
    sync's."""
    stalls = [("Activity Buffer Request", 2, 4),    # the API's own time
              ("Activity Buffer Request", 11, 14),  # A's wrapper 1, pipe 2
              ("Buffer Flush", 16, 18)]             # the slice's
    obs = search_obs(search_host(0) + search_host(60) + stalls)
    api, pipe, kern = (read(name, obs) for name in SEARCH)
    assert api == pytest.approx(0.009)
    assert pipe == pytest.approx(0.023)
    assert kern == pytest.approx(0.0145)
    assert api + pipe + kern == pytest.approx(0.050 - 0.0035)
    # the gap 170-200 begins inside build.sync and inside a stall
    obs = build_obs(BUILD_HOST + [("Activity Buffer Request", 168, 172)])
    assert read("build_sync_idle_ms", obs) == pytest.approx(0.014)
    assert read("build_levels", obs) == 1.5


@pytest.mark.parametrize("name", SEARCH + BUILD)
def test_no_program_span_gives_nothing(name):
    """The parent's tree: the harness's spans and ATen ops, none of the
    program's; and observations without a host-traced span."""
    bare = [op for op in search_host(0) + BUILD_HOST
            if not op[0].startswith(PROGRAM)]
    for obs in (search_obs(bare), build_obs(bare),
                trace.Observation("search", 2, (0.0, 1.0), []),
                trace.Observation("build", 1, (0.0, 1.0), [])):
        assert read(name, obs) is None


@pytest.mark.parametrize("cell", ["mnist784.bulk_p4", "iss595.rebuild"])
def test_a_tiny_traced_run_reports_the_span_metrics(man, tiny, cell):
    import time

    from bench import harness
    cfg, tr = tiny(cell)
    result = harness.run_cell(man, cell, 2**31 + 7, 0.2, True, "cpu",
                              time.perf_counter(), config=cfg, traffic=tr)
    assert result["correct"]
    want = SEARCH if "bulk" in cell else BUILD
    for name in want:
        assert result["metrics"][name]["value"] >= 0, name
    if "bulk" in cell:
        assert result["metrics"]["kernel_host_ms"]["value"] > 0
    else:
        assert result["metrics"]["build_levels"]["value"] >= 1


@pytest.mark.chip
def test_program_spans_leave_no_device_event(cuda_device):
    """A search and a build profiled with the host's ops, as the traced
    runs profile them: every program span among the host's ops, none among
    the device's, in either kind of traced span."""
    import torch

    from repro_torch.core.forest import ForestConfig
    from repro_torch.index import IndexSpec, SearchParams, build_index

    g = torch.Generator(device=cuda_device).manual_seed(3)
    rows = torch.rand(20000, 64, generator=g, device=cuda_device)
    q = torch.rand(256, 64, generator=g, device=cuda_device)
    spec = IndexSpec(backend="rpf", forest=ForestConfig(n_trees=8), seed=5)
    params = SearchParams(k=10, n_probes=4)

    def work():
        index = build_index(rows, spec, device=cuda_device)
        out = index.search(q, params)
        torch.cuda.synchronize()
        return out

    want = work()                         # builds and loads the kernels
    for host in (True, False):
        got, _, device, hosts = trace.profile(work, host=host)
        assert all(torch.equal(a, b) for a, b in zip(want, got))
        assert device and not [op for op in device
                               if op[0].startswith(PROGRAM)]
        if host:
            assert {op[0] for op in hosts} >= set(PROGRAM)
