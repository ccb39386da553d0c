"""The port's capability matrix and value types against the reference's.

``repro_torch.index.params`` must give the reference's verdicts over a grid
of params in every context, except that each set knob the port does not
serve yet (``adaptive_wave``, ``probe_schedule``, ``filter``: ROADMAP.md
queue 1 item 5) adds exactly one "not ported" violation.  ``to_dict`` /
``from_dict`` round-trip across the packages, the matrix and its table
are the reference's, a negative ``probe_schedule`` fails at construction,
and ``IndexSpec.tree_chunk`` builds the same forest bit for bit.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

import repro.index as jindex
from repro.core import forest as jforest
from repro.filter import Eq
from repro.index import params as jparams
from repro_torch import index as tindex
from repro_torch.core import forest as tforest
from repro_torch.index import params as tparams

METRICS = ("l2", "ip", "cosine", "chi2", "euclidean", "hamming")
ITEM5 = ("adaptive_wave", "probe_schedule", "filter")


def _grid(metric):
    for mc, nt, aw, ps, flt in itertools.product(
            (1, 5), (0, 3), (0, 2), (0, 4), (None, Eq("color", "red"))):
        yield dict(metric=metric, min_candidates=mc, n_trees=nt,
                   adaptive_wave=aw, probe_schedule=ps, filter=flt)


def _entries(vs):
    return [(v.knob, v.context, v.message, v.hint) for v in vs]


@pytest.mark.parametrize("metric", METRICS)
def test_verdicts_equal_the_reference_in_every_context(metric):
    for kw in _grid(metric):
        want = jparams.SearchParams(**kw)
        got = tparams.SearchParams(**kw)
        assert got.metric == want.metric
        for ctx in jparams.CONTEXTS:
            theirs = want.capabilities(ctx)
            ours = got.capabilities(ctx)
            not_ported = [v for v in ours if "not ported yet" in v.message]
            assert sorted(v.knob for v in not_ported) == sorted(
                k for k in ITEM5 if kw[k] not in (0, None)), (kw, ctx)
            for v in not_ported:
                assert v.context == ctx and "ROADMAP.md queue 1 item 5" in \
                    str(v)
            rest = [v for v in ours if v not in not_ported]
            assert _entries(rest) == _entries(theirs), (kw, ctx)
            # require raises exactly when some violation stands
            if ours:
                with pytest.raises(tparams.CapabilityError) as err:
                    got.require(ctx)
                assert err.value.context == ctx
                assert err.value.violations == tuple(ours)
            else:
                assert got.require(ctx) is got
        assert got.violations() == [str(v) for v in got.capabilities()]
        assert got.sharded_violations() == [
            str(v) for v in got.capabilities("sharded")]


def test_repaired_differences():
    # 1: the item-5 knobs are structured violations, not NotImplementedError
    for kw in (dict(adaptive_wave=20), dict(probe_schedule=4),
               dict(filter=Eq("color", "red"))):
        p = tparams.SearchParams(**kw)
        for ctx in tparams.CONTEXTS:
            with pytest.raises(tparams.CapabilityError,
                               match="ROADMAP.md queue 1 item 5"):
                p.require(ctx)
    # 2: an unknown metric raises CapabilityError (a ValueError), as in the
    # reference, with the reference's message
    with pytest.raises(tparams.CapabilityError) as ours:
        tparams.SearchParams(metric="hamming").require()
    with pytest.raises(jparams.CapabilityError) as theirs:
        jparams.SearchParams(metric="hamming").require()
    assert isinstance(ours.value, ValueError)
    assert str(ours.value) == str(theirs.value)
    # 3: a negative probe_schedule fails at construction in both
    for mod in (tparams, jparams):
        with pytest.raises(ValueError, match="probe_schedule"):
            mod.SearchParams(probe_schedule=-1)
    with pytest.raises(ValueError, match="context"):
        tparams.SearchParams().capabilities("gpu")


def test_capability_error_keeps_its_structure():
    v = tparams.Violation("n_trees", "sharded", "n_trees=3 (x)", "use 0")
    assert str(v) == "n_trees=3 (x) — use 0"
    err = tparams.CapabilityError([v], "sharded", prefix="cannot")
    assert err.violations == (v,) and err.context == "sharded"
    assert str(err) == "cannot [sharded]: n_trees=3 (x) — use 0"
    want = jparams.CapabilityError(
        [jparams.Violation("n_trees", "sharded", "n_trees=3 (x)", "use 0")],
        "sharded", prefix="cannot")
    assert str(err) == str(want)
    p = tparams.SearchParams(n_trees=3, min_candidates=2, adaptive_wave=1)
    assert p.sharded().capabilities("sharded") == []
    assert p.sharded().to_dict() == jparams.SearchParams(
        n_trees=3, min_candidates=2, adaptive_wave=1).sharded().to_dict()


@pytest.mark.parametrize("kw", [
    dict(), dict(k=7, metric="ip", mode="pallas", dedup=False, expand=3,
                 chunk=64, n_probes=4, n_trees=5),
    dict(metric="cosine", mode="ref", tol=0.5, min_candidates=9,
         adaptive_wave=3),
    dict(probe_schedule=8, filter=Eq("color", "red")),
])
def test_search_params_dicts_round_trip_across_packages(kw):
    ours = tparams.SearchParams(**kw)
    theirs = jparams.SearchParams.from_dict(ours.to_dict())
    assert theirs == jparams.SearchParams(**kw)
    assert theirs.to_dict() == ours.to_dict()
    assert tparams.SearchParams.from_dict(theirs.to_dict()) == \
        tparams.SearchParams.from_dict(ours.to_dict())
    back = tparams.SearchParams.from_dict(theirs.to_dict())
    for f in ("k", "metric", "mode", "dedup", "expand", "n_probes",
              "n_trees", "probe_schedule", "adaptive_wave", "tol"):
        assert getattr(back, f) == getattr(ours, f)
    # unknown keys (a newer writer) are ignored
    assert tparams.SearchParams.from_dict(dict(ours.to_dict(), x=1)) == back


def test_index_spec_dicts_round_trip_across_packages():
    kw = dict(backend="rpf+int8", lsh_radii=(0.5, 1.0), lsh_tables=3,
              lsh_bits=5, lsh_width_scale=2.0, tree_chunk=4, seed=11,
              delta_cap=32, rebuild_frac=0.25)
    ours = tindex.IndexSpec(forest=tforest.ForestConfig(n_trees=9,
                                                         capacity=7), **kw)
    theirs = jindex.IndexSpec(forest=jforest.ForestConfig(n_trees=9,
                                                          capacity=7), **kw)
    assert ours.to_dict() == theirs.to_dict()
    assert jindex.IndexSpec.from_dict(ours.to_dict()) == theirs
    assert tindex.IndexSpec.from_dict(theirs.to_dict()) == ours
    d = tindex.IndexSpec()
    assert (d.tree_chunk, d.delta_cap, d.rebuild_frac) == (0, 0, 0.1)
    assert d.to_dict() == jindex.IndexSpec().to_dict()


def test_capability_matrix_and_table_are_the_reference():
    assert tparams.CAPABILITY_MATRIX == jparams.CAPABILITY_MATRIX
    assert tparams.capability_table_md() == jparams.capability_table_md()
    assert tparams.CONTEXTS == jparams.CONTEXTS


def _reference_draws(key, cfg, n, d):
    rc = cfg.resolved(n)
    draws = jax.jit(jforest._batched_level_draws(
        jax.random.split(key, rc.n_trees), rc, d, "compat"))
    return lambda level: tuple(np.array(a) for a in draws(level))


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_tree_chunk_builds_the_same_forest(chunk):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(300, 10)).astype(np.float32))
    cfg = tforest.ForestConfig(n_trees=7, capacity=9)
    whole = tforest.build_forest(x, cfg, generator=torch.Generator(
        ).manual_seed(3), device="cpu")
    parts = tforest.build_forest(x, cfg, generator=torch.Generator(
        ).manual_seed(3), device="cpu", tree_chunk=chunk)
    for name, a, b in zip(tforest.Forest._fields, whole, parts):
        assert torch.equal(a, b), name
    # under the reference's draws: the reference's forest, chunked or not
    jcfg = jforest.ForestConfig(n_trees=7, capacity=9)
    key = jax.random.key(2)
    want = jforest.build_forest(key, jax.numpy.asarray(x.numpy()), jcfg,
                                tree_chunk=chunk)
    got = tforest.build_forest(x, cfg, draws=_reference_draws(
        key, jcfg, 300, 10), device="cpu", tree_chunk=chunk)
    for name in tforest.Forest._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # through the index: spec.tree_chunk reaches the builder
    spec = tindex.IndexSpec(forest=cfg, tree_chunk=chunk, seed=3)
    idx = tindex.build_index(x.numpy(), spec, device="cpu")
    for a, b in zip(whole, idx.forest):
        assert torch.equal(a, b)
