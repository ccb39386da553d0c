"""The port's profiler spans (``repro_torch/tracing.py``): a shared no-op
without a profiler, function-scope ranges under one, nested along the
search path as the benchmark's readers expect, one ``build.level`` a level
of the builder's loop, and answers and forests bitwise the same with and
without a profiler.  Tiny sizes on the CPU, the kernels' plain versions."""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.forest import ForestConfig, build_forest, generator_draws
from repro_torch.index import IndexSpec, SearchParams, build_index

N, D, B = 600, 8, 16
CFG = ForestConfig(n_trees=4, capacity=8)
PREFIXES = ("index.", "pipeline.", "kernel.", "build.")
# each search span and the program span it sits in
SEARCH_PARENTS = {
    "index.search": None,
    "pipeline.query": "index.search",
    "pipeline.descend": "pipeline.query",
    "kernel.forest_traverse": "pipeline.descend",
    "pipeline.slice": "pipeline.query",
    "pipeline.dedup": "pipeline.query",
    "pipeline.rerank": "pipeline.query",
    "kernel.fused_gather_topk": "pipeline.rerank",
}


def data(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(N, D, generator=g), torch.rand(B, D, generator=g)


def build(rows):
    return build_index(rows, IndexSpec(backend="rpf", forest=CFG, seed=3),
                       device="cpu")


def program_spans(prof) -> list:
    """(name, start, end, scope) of the program's spans, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end, e.scope)
                   for e in prof.events() if e.name.startswith(PREFIXES)),
                  key=lambda s: (s[1], -s[2]))


def parent(span, spans):
    """The innermost other program span whose interval holds ``span``'s."""
    over = [s for s in spans if s is not span and s[1] <= span[1]
            and span[2] <= s[2]]
    return min(over, key=lambda s: s[2] - s[1], default=None)


def test_no_profiler_records_nothing(monkeypatch):
    made = []

    def record(name):
        made.append(name)
        return tracing.OFF

    monkeypatch.setattr(tracing, "_Range", record)
    assert tracing.span("index.search") is tracing.OFF
    rows, q = data()
    build(rows).search(q, SearchParams(k=5, n_probes=2))
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("index.search"):
            pass
    assert made == ["index.search"]


@pytest.mark.parametrize("n_probes", [1, 3])
def test_search_spans_nest_as_the_pipeline(n_probes):
    rows, q = data()
    index = build(rows)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index.search(q, SearchParams(k=5, n_probes=n_probes))
    spans = program_spans(prof)
    assert collections.Counter(s[0] for s in spans) == {
        name: 1 for name in SEARCH_PARENTS}
    for s in spans:
        up = parent(s, spans)
        assert (up and up[0]) == SEARCH_PARENTS[s[0]], s[0]
        assert s[3] == 0, s          # function scope: no device mirror


@pytest.mark.parametrize("tree_chunk", [0, 3])
def test_one_level_span_a_level_and_two_syncs(tree_chunk):
    rows, _ = data(1)
    cfg = CFG.resolved(N)
    base = generator_draws(torch.Generator().manual_seed(5), cfg, D,
                           torch.device("cpu"))
    levels = []

    def draws(level):
        levels.append(level)
        return base(level)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build_forest(rows, CFG, draws=draws, device="cpu",
                     tree_chunk=tree_chunk)
    assert max(levels) + 1 < cfg.max_depth     # every chunk ran to its end
    chunks = 2 if tree_chunk else 1
    spans = program_spans(prof)
    names = collections.Counter(s[0] for s in spans)
    assert names == {"build.forest": 1, "build.level": len(levels),
                     "build.draws": len(levels),
                     "build.sync": 2 * len(levels) + chunks}
    # one sync a level inside it (the bincount), one before each level
    # and one after a chunk's last (whether a leaf is overfull)
    where = collections.Counter((s[0], parent(s, spans)[0]) for s in spans
                                if s[0] in ("build.sync", "build.draws"))
    assert where == {("build.sync", "build.level"): len(levels),
                     ("build.sync", "build.forest"): len(levels) + chunks,
                     ("build.draws", "build.level"): len(levels)}


def test_answers_and_forests_bitwise_under_the_profiler():
    rows, q = data(2)
    plain = build(rows)
    want = plain.search(q, SearchParams(k=5, n_probes=2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = build(rows)
        got = traced.search(q, SearchParams(k=5, n_probes=2))
    assert any(e.name == "build.forest" for e in prof.events())
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    (sa,), (sb,) = plain._segments, traced._segments
    for a, b in zip(sa.engine.forest, sb.engine.forest):
        assert torch.equal(a, b)
