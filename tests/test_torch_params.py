"""The port's capability matrix and value types against the reference's.

``repro_torch.index.params`` must give the reference's verdicts over a grid
of params in every context, each package's own predicate as the filter (a
filter that is no predicate is refused by both, each naming its own
package).  ``to_dict`` / ``from_dict`` round-trip across the packages, the
matrix and its table are the reference's, a negative ``probe_schedule``
fails at construction and ``expand=0`` constructs, and
``IndexSpec.tree_chunk`` builds the same forest bit for bit.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro.core import forest as jforest
from repro.filter import Eq
from repro.index import params as jparams
from repro_torch import filter as tfilter
from repro_torch import index as tindex
from repro_torch.core import forest as tforest
from repro_torch.index import params as tparams

METRICS = ("l2", "ip", "cosine", "chi2", "euclidean", "hamming")


def _filters(tag):
    """(the reference's filter, the port's) for a grid tag."""
    if tag == "eq":
        return Eq("color", "red"), tfilter.Eq("color", "red")
    if tag == "str":
        return "color=red", "color=red"
    return None, None


def _grid(metric):
    for mc, nt, aw, ps, ex, flt in itertools.product(
            (1, 5), (0, 3), (0, 2), (0, 4), (4, 0), (None, "eq", "str")):
        jf, tf = _filters(flt)
        kw = dict(metric=metric, min_candidates=mc, n_trees=nt,
                  adaptive_wave=aw, probe_schedule=ps, expand=ex)
        yield dict(kw, filter=jf), dict(kw, filter=tf)


def _entries(vs):
    return [(v.knob, v.context, v.message, v.hint) for v in vs]


def _reference_entries(vs):
    """The reference's entries with its package's name where the port
    names its own (the filter's "must be a repro.filter Predicate")."""
    return [(k, c, m.replace("repro.filter", "repro_torch.filter"), h)
            for k, c, m, h in _entries(vs)]


@pytest.mark.parametrize("metric", METRICS)
def test_verdicts_equal_the_reference_in_every_context(metric):
    for jkw, tkw in _grid(metric):
        want = jparams.SearchParams(**jkw)
        got = tparams.SearchParams(**tkw)
        assert got.metric == want.metric
        for ctx in jparams.CONTEXTS:
            theirs = want.capabilities(ctx)
            ours = got.capabilities(ctx)
            assert _entries(ours) == _reference_entries(theirs), (tkw, ctx)
            assert not any("not ported" in v.message for v in ours)
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
    # 1: the item-5 knobs are served where the reference serves them, and a
    # filter that is no predicate is a structured violation in every context
    for kw in (dict(adaptive_wave=20), dict(probe_schedule=4),
               dict(filter=tfilter.Eq("color", "red"))):
        p = tparams.SearchParams(**kw)
        for ctx in tparams.CONTEXTS:
            if ctx == "sharded" and "adaptive_wave" in kw:
                continue
            assert p.require(ctx) is p
    for ctx in tparams.CONTEXTS:
        with pytest.raises(tparams.CapabilityError,
                           match="repro_torch.filter Predicate") as err:
            tparams.SearchParams(filter=Eq("color", "red")).require(ctx)
        assert err.value.violations[0].knob == "filter"
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
    # 4 (fault 6): expand=0 constructs in both; only the rpf+int8 search
    # refuses it (tests/test_torch_quantized.py)
    assert tparams.SearchParams(k=3, expand=0).to_dict() == \
        jparams.SearchParams(k=3, expand=0).to_dict()
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
    dict(probe_schedule=8, filter="eq"),
    dict(k=3, expand=0),
])
def test_search_params_dicts_round_trip_across_packages(kw):
    jf, tf = _filters(kw.get("filter"))
    ours = tparams.SearchParams(**dict(kw, filter=tf))
    theirs = jparams.SearchParams.from_dict(ours.to_dict())
    assert theirs == jparams.SearchParams(**dict(kw, filter=jf))
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
