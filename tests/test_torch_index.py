"""The port's index API held against the reference's, and the port's
independence from JAX.

``repro_torch.index.build_index`` (the reference's draws injected,
``device="cpu"``) + ``search`` must answer like ``repro.index.build_index``
+ ``search``: equal ids, distances within rtol 1e-5 / atol 1e-6 (the
frameworks sum the d terms in other orders).
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.index as jindex
from repro.core import forest as jforest
from repro.core.knn import exact_knn as j_exact_knn
from repro.core.search import recall_at_k as j_recall
from repro.data.synthetic import clustered_gaussians
from repro.data.synthetic import mnist_like as j_mnist_like
from repro_torch import convert
from repro_torch import index as tindex
from repro_torch.configs import rpf_mnist784 as t_cfg
from repro_torch.core import forest as tforest
from repro_torch.core.knn import exact_knn
from repro_torch.core.search import recall_at_k
from repro_torch.data.synthetic import mnist_like

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
RTOL, ATOL = 1e-5, 1e-6
N, D = 1200, 32
FOREST = dict(n_trees=8, capacity=12)


def reference_draws(key, cfg, n, d):
    rc = cfg.resolved(n)
    draws = jax.jit(jforest._batched_level_draws(
        jax.random.split(key, rc.n_trees), rc, d, "compat"))
    return lambda level: tuple(np.array(a) for a in draws(level))


@pytest.fixture(scope="module")
def indexes():
    db = clustered_gaussians(N, D, n_clusters=16, seed=3)
    rng = np.random.default_rng(4)
    q = (db[rng.integers(0, N, 21)] + 0.5 * rng.normal(size=(21, D))
         ).astype(np.float32)
    key = jax.random.key(7)
    jspec = jindex.IndexSpec(backend="rpf",
                             forest=jforest.ForestConfig(**FOREST))
    jidx = jindex.build_index(key, db, jspec)
    tspec = tindex.IndexSpec(backend="rpf",
                             forest=tforest.ForestConfig(**FOREST))
    tidx = tindex.build_index(db, tspec, device="cpu", draws=reference_draws(
        key, jforest.ForestConfig(**FOREST), N, D))
    return db, q, jidx, tidx, tspec


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [
    dict(k=5), dict(k=5, n_probes=3), dict(k=3, n_trees=3, metric="ip"),
    dict(k=4, metric="cosine", dedup=False, chunk=9),
    dict(k=5, mode="pallas", expand=2, min_candidates=4),
])
def test_search_matches_reference(indexes, kw):
    db, q, jidx, tidx, _ = indexes
    jkw = dict(kw, mode="ref")        # the reference's plain path on CPU
    want = jidx.search(q, jindex.SearchParams(**jkw))
    tkw = dict(kw, mode="auto") if kw.get("mode") == "pallas" else kw
    _assert_same(tidx.search(q, tindex.SearchParams(**tkw)), want)


def test_builder_and_carried_forest_agree(indexes):
    """The port's build equals the reference's forest, and that forest
    carried across answers the same."""
    db, q, jidx, tidx, tspec = indexes
    for name in jforest.Forest._fields:
        np.testing.assert_array_equal(
            getattr(tidx.forest, name).numpy(),
            np.asarray(getattr(jidx.forest, name)), err_msg=name)
    carried = convert.index_from_numpy(db, jax.device_get(jidx.forest),
                                       tspec, device="cpu")
    want = jidx.search(q, jindex.SearchParams(k=6, mode="ref"))
    _assert_same(carried.search(q, k=6), want)


def test_search_params_policy():
    assert tindex.SearchParams(mode="pallas").mode == "kernel"
    assert tindex.SearchParams(metric="ip").metric == "dot"
    for knob in (dict(adaptive_wave=20), dict(probe_schedule=4)):
        p = tindex.SearchParams(**knob)
        assert p.require() is p
    with pytest.raises(tindex.CapabilityError,
                       match="repro_torch.filter Predicate"):
        tindex.SearchParams(filter=object()).require()
    with pytest.raises(tindex.CapabilityError, match="metric='hamming'"):
        tindex.SearchParams(metric="hamming").require()
    with pytest.raises(KeyError, match="unknown index backend"):
        tindex.get_backend("hnsw")


def test_exact_knn_and_recall_match_reference(indexes):
    db, q, _, _, _ = indexes
    for metric in ("l2", "cosine", "dot"):
        got = exact_knn(torch.from_numpy(q), torch.from_numpy(db), 5, metric)
        want = j_exact_knn(jnp.asarray(q), jnp.asarray(db), 5, metric=metric)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
    pred = np.random.default_rng(0).integers(0, 40, size=(21, 5))
    true = np.random.default_rng(1).integers(0, 40, size=(21, 5))
    assert recall_at_k(torch.from_numpy(pred), torch.from_numpy(true)) == \
        pytest.approx(float(j_recall(jnp.asarray(pred), jnp.asarray(true))))


def test_data_and_config_copies_match_reference():
    from repro.configs import rpf_mnist784 as j_cfg
    for got, want in zip(mnist_like(300, n_test=7, seed=5),
                         j_mnist_like(300, n_test=7, seed=5)):
        np.testing.assert_array_equal(got, want)
    assert tuple(t_cfg.CONFIG) == tuple(j_cfg.CONFIG)
    assert (t_cfg.N_DB, t_cfg.DIM, t_cfg.METRIC, t_cfg.L_SWEEP) == \
        (j_cfg.N_DB, j_cfg.DIM, j_cfg.METRIC, j_cfg.L_SWEEP)
    assert t_cfg.QUERY_BATCH == dict(
        (c.name, c.batch) for c in j_cfg.CELLS)["query_batch"]


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = np.zeros((20, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tindex.build_index(db, tindex.IndexSpec())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tforest.build_forest(db, tforest.ForestConfig())


# ---------------------------------------------------------------------------
# the port never imports JAX or the reference
# ---------------------------------------------------------------------------


def _port_modules():
    files = sorted(PORT.rglob("*.py"))
    names = []
    for f in files:
        rel = f.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return files, names


def test_port_imports_no_jax_at_run_time():
    _, names = _port_modules()
    code = ("import sys\n"
            + "".join(f"import {n}\n" for n in names)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
              "m.startswith('repro.'))\n"
              "assert not bad, bad\n"
              "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_import_no_jax_or_reference():
    files, _ = _port_modules()
    offenders = []
    for f in files + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            offenders += [(f.name, m) for m in mods
                          if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not offenders, offenders
    assert len(files) >= 20
