"""The port's recommenders held against the reference's: ``configs/``,
``models/layers.py``, ``models/recsys.py``, ``data/recsys_data.py``,
``launch/mesh.py`` and ``launch/steps.py``'s recsys programs (and the
MACE cells' meta and argument shapes).

Small configurations as ``tests/test_smoke_archs.py`` makes them (tables of
at most 500 rows, 2,000 items, ``row_pad_to`` 8, a batch of 16).  The
parameters are the reference's params trees (its own ``init_mind`` and
``init_two_tower``; seeded numpy arrays on the reference's tree shape for
the CTR models, whose reference init takes seconds to compile), carried
into the port through ``convert.recsys_from_numpy``.  Ids run past every
table and below 0, so both packages' gathers follow the reference's rule
(a negative id wraps once, then every id clamps into the table).

Tolerances: CTR logits rtol 1e-5 / atol 1e-6; MIND (three routing
iterations) rtol 1e-4 / atol 1e-6; the bag rtol 1e-5 / atol 1e-6; top-k ids
equal at every rank whose score is separated from its neighbours by more
than the tolerance, scores within it; streams, configs, shapes and meta
exactly; the index's forest bitwise under the reference's draws.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.configs as jconfigs
from repro.core import forest as jforest
from repro.core import sharded_index as jsharded
from repro.data import recsys_data as jdata
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import layers as jl
from repro.models import mace as jmace
from repro.models import recsys as jrs
import repro_torch.configs as tconfigs
from repro_torch.convert import recsys_from_numpy
from repro_torch.core import forest as tforest
from repro_torch.core.sharded_index import CellDraws, Mesh
from repro_torch.data import recsys_data as tdata
from repro_torch.kernels.common import REF_CALLS
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tl
from repro_torch.models import recsys as trs

CTR_TOL = dict(rtol=1e-5, atol=1e-6)
MIND_TOL = dict(rtol=1e-4, atol=1e-6)
B = 16
RECSYS = ["mind", "dlrm-mlperf", "autoint", "wide-deep"]
# the reference's rpf=1 forest (``_mind_rpf_retrieval_program``)
JFOREST = jforest.ForestConfig(n_trees=80, capacity=16, split_ratio=0.3)


def _smoke(cfg):
    return dataclasses.replace(
        cfg, table_sizes=tuple(min(s, 500) for s in cfg.table_sizes),
        item_vocab=min(cfg.item_vocab, 2000) if cfg.item_vocab else 0,
        row_pad_to=8)


def _canon(tree, leaf):
    """Nested dicts / lists / tuples with ``leaf`` applied: both packages'
    trees compare by ``==`` (a NamedTuple equals a tuple of its fields)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _canon(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_canon(v, leaf) for v in tree]
    return leaf(tree)


def _t_shapes(tree):
    return _canon(tree, lambda s: (tuple(s.shape),
                                   str(s.dtype).removeprefix("torch.")))


def _is_tuple_leaf(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], str)


def _canon_shapes_j(tree):
    # jax.tree.map returns (shape, dtype) tuples as leaves; _canon must not
    # open them
    if isinstance(tree, dict):
        return {k: _canon_shapes_j(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_tuple_leaf(tree):
        return [_canon_shapes_j(v) for v in tree]
    return tree


def _ref_shapes(tree):
    return _canon_shapes_j(jax.tree.map(
        lambda s: (tuple(s.shape), np.dtype(s.dtype).name), tree))


def _numpy_params(cfg, seed):
    """Seeded numpy arrays on the reference's params tree of ``cfg``."""
    init = jsteps._recsys_init(cfg)
    rng = np.random.default_rng(seed)

    def fill(s):
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.1
        return (rng.normal(size=s.shape) * scale).astype(np.float32)

    return jax.tree.map(fill, jax.eval_shape(init))


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, port cfg, numpy params, port module) of ``arch``."""
    jc = _smoke(jconfigs.get_arch(arch).config)
    tc = _smoke(tconfigs.get_arch(arch).config)
    if jc.model == "mind":
        params = jax.device_get(jax.jit(functools.partial(
            jrs.init_mind, cfg=jc))(jax.random.key(0)))
    else:
        params = _numpy_params(jc, seed=len(arch))
    return jc, tc, params, recsys_from_numpy(params, tc, device="cpu")


def _batch(cfg, b, seed):
    """Seeded ids, some below 0 and some past every table."""
    rng = np.random.default_rng(seed)
    if cfg.model == "mind":
        return {"hist": rng.integers(-5, cfg.item_vocab + 100,
                                     (b, cfg.hist_len)).astype(np.int32),
                "target": rng.integers(-5, cfg.item_vocab + 100,
                                       b).astype(np.int32)}
    out = {"sparse": rng.integers(-20, 600, (b, cfg.n_sparse)
                                  ).astype(np.int32)}
    if cfg.n_dense:
        out["dense"] = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _spec(pkg_configs, arch, cfg):
    return dataclasses.replace(pkg_configs.get_arch(arch), config=cfg)


def _cell(arch, name):
    return {c.name: c for c in jconfigs.get_arch(arch).cells}[name]


def _topk_equal(got, want, tol):
    """Scores within ``tol``, ids equal at every rank separated from its
    neighbours by more than the tolerance (lax.top_k: descending)."""
    (gs, gi), (ws, wi) = [(np.asarray(s, np.float64).ravel(),
                           np.asarray(i).ravel()) for s, i in (got, want)]
    np.testing.assert_allclose(gs, ws, **tol)
    eps = tol["rtol"] * np.abs(ws) + tol["atol"]
    gap = ws[:-1] - ws[1:]
    sep = np.ones_like(ws, dtype=bool)
    sep[1:] &= gap > eps[1:] + eps[:-1]
    sep[:-1] &= gap > eps[:-1] + eps[1:]
    np.testing.assert_array_equal(gi[sep], wi[sep])
    return int(sep.sum())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_lists_the_reference_archs():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    with pytest.raises(KeyError):
        tconfigs.get_arch("nope")


def _fields(x):
    if hasattr(x, "_asdict"):
        return dict(x._asdict())
    return dataclasses.asdict(x)


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_and_cells_equal_field_for_field(arch):
    js, ts = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert (ts.arch_id, ts.family, ts.notes) == (js.arch_id, js.family,
                                                 js.notes)
    assert type(ts.config).__name__ == type(js.config).__name__
    assert _fields(ts.config) == _fields(js.config)
    assert [_fields(c) for c in ts.cells] == [_fields(c) for c in js.cells]


def test_meshes_and_dp_axes():
    for multi in (False, True):
        assert tmesh.dp_axes(multi) == jmesh.dp_axes(multi)
    m = tmesh.make_test_mesh(device="cpu")
    assert m.shape == {"data": 4, "model": 2}
    p = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert p.shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.make_production_mesh(device="cpu").n_cells == 256


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _layer_case(name, rng):
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    g = rng.normal(size=(8,)).astype(np.float32)
    if name == "rms_norm":
        return jl.rms_norm(jnp.asarray(x), jnp.asarray(g)), \
            tl.rms_norm(torch.from_numpy(x), torch.from_numpy(g))
    if name == "layer_norm":
        b = rng.normal(size=(8,)).astype(np.float32)
        return (jl.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)),
                tl.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(b)))
    if name == "rope_freqs":
        return jl.rope_freqs(16, 10000.0), tl.rope_freqs(16, 10000.0)
    if name == "apply_rope":
        pos = rng.integers(0, 40, (2, 5)).astype(np.int32)
        return (jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
                tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              10000.0))
    logits = rng.normal(size=(4, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (4, 6)).astype(np.int32)
    mask = (rng.uniform(size=(4, 6)) < 0.7).astype(np.float32)
    kw = {"softmax_cross_entropy": {},
          "softmax_cross_entropy mask z_loss": {"mask": mask,
                                                "z_loss": 1e-4}}[name]
    return (jl.softmax_cross_entropy(
                jnp.asarray(logits), jnp.asarray(labels),
                **{k: (jnp.asarray(v) if k == "mask" else v)
                   for k, v in kw.items()}),
            tl.softmax_cross_entropy(
                torch.from_numpy(logits), torch.from_numpy(labels),
                **{k: (torch.from_numpy(v) if k == "mask" else v)
                   for k, v in kw.items()}))


@pytest.mark.parametrize("name", [
    "rms_norm", "layer_norm", "rope_freqs", "apply_rope",
    "softmax_cross_entropy", "softmax_cross_entropy mask z_loss",
    "dense_init", "embed_init", "dtype_of pad_vocab Axes"])
def test_layers_match_reference(name):
    rng = np.random.default_rng(7)
    if name in ("dense_init", "embed_init"):
        # another generator: the reference's shape, dtype and scale
        # (normal x 1 / sqrt(d_in), or x 0.02), and the same bits from the
        # same seed
        init = getattr(tl, name)

        def draw(gen):
            return init(gen, 256, 192, torch.float32)

        got = draw(torch.Generator().manual_seed(3))
        assert torch.equal(got, draw(torch.Generator().manual_seed(3)))
        want = jax.eval_shape(lambda: getattr(jl, name)(
            jax.random.key(3), 256, 192, jnp.float32))
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        scale = 1 / 16 if name == "dense_init" else 0.02
        np.testing.assert_allclose(float(got.std()), scale, rtol=0.02)
        assert tl.dense_init(None, 4, 3, torch.bfloat16,
                             device="meta").dtype == torch.bfloat16
        return
    if name == "dtype_of pad_vocab Axes":
        for dt in ("float32", "bfloat16", "float16"):
            assert str(tl.dtype_of(dt)).removeprefix("torch.") == \
                np.dtype(jl.dtype_of(dt)).name
        for v, m in ((301, 128), (256, 128), (1, 8)):
            assert tl.pad_vocab(v, m) == jl.pad_vocab(v, m)
        assert (tl.Axes().dp, tl.Axes().tp) == (jl.Axes().dp, jl.Axes().tp)
        return
    want, got = _layer_case(name, rng)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# forward passes and the serve program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RECSYS)
def test_forward_and_serve_program_match(arch):
    jc, tc, params, model = _model(arch)
    cell = _cell(arch, "serve_p99")
    jprog = jsteps._recsys_serve_program(
        _spec(jconfigs, arch, jc), cell, jmesh.make_test_mesh((1, 1)), False)
    tprog = tsteps._recsys_serve_program(
        _spec(tconfigs, arch, tc), cell, Mesh((1, 1), device="cpu"), False)
    batch = _batch(jc, B, seed=11)
    want = np.asarray(jax.jit(jprog.fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    tol = MIND_TOL if jc.model == "mind" else CTR_TOL
    tb = _t(batch)
    fwd = {"mind": lambda: trs.mind_train_logits(model, tc, tb["hist"],
                                                 tb["target"]),
           "dlrm": lambda: trs.dlrm_fwd(model, tb["dense"], tb["sparse"]),
           "autoint": lambda: trs.autoint_fwd(model, tb["sparse"]),
           "widedeep": lambda: trs.widedeep_fwd(model, tb["sparse"])}
    for got in (fwd[jc.model](), tprog.fn(model, tb),
                model(*[tb[k] for k in {"mind": ("hist", "target"),
                                        "dlrm": ("dense", "sparse")}.get(
                    jc.model, ("sparse",))])):
        assert got.shape == (B,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    # the arguments' shapes leaf for leaf, the meta exactly
    assert _t_shapes(tprog.args) == _ref_shapes(jprog.args)
    assert tprog.meta == jprog.meta
    # the port's param tree is the reference's, leaf for leaf
    assert _t_shapes(trs.param_tree(model)) == _ref_shapes(params)


def test_mind_user_fwd_and_scores_match():
    jc, tc, params, model = _model("mind")
    batch = _batch(jc, B, seed=12)
    rng = np.random.default_rng(13)
    mask = (rng.uniform(size=batch["hist"].shape) < 0.8).astype(np.float32)
    cand = rng.normal(size=(300, jc.embed_dim)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    h = jnp.asarray(batch["hist"])
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        want = jrs.mind_user_fwd(jp, jc, h, jm)
        got = trs.mind_user_fwd(model, tc, torch.from_numpy(batch["hist"]),
                                tm)
        assert got.shape == (B, jc.n_interests, jc.embed_dim)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **MIND_TOL)
        want = jrs.mind_score_candidates(jp, jc, h, jnp.asarray(cand), jm)
        got = trs.mind_score_candidates(
            model, tc, torch.from_numpy(batch["hist"]),
            torch.from_numpy(cand), tm)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **MIND_TOL)
    np.testing.assert_allclose(
        trs._squash(torch.from_numpy(cand)).numpy(),
        np.asarray(jrs._squash(jnp.asarray(cand))), rtol=1e-6, atol=1e-7)


def test_two_tower_matches():
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(s.shape[-1])
                   ).astype(np.float32),
        jax.eval_shape(lambda: jrs.init_two_tower(jax.random.key(4), 50, 80,
                                                  d=16, hidden=32)))
    model = recsys_from_numpy(params, None, device="cpu")
    rng = np.random.default_rng(5)
    u = rng.integers(-3, 55, 12).astype(np.int32)
    i = rng.integers(-3, 85, 12).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    for jf, tf, ids in ((jrs.two_tower_user, trs.two_tower_user, u),
                        (jrs.two_tower_item, trs.two_tower_item, i)):
        np.testing.assert_allclose(
            tf(model, torch.from_numpy(ids)).detach().numpy(),
            np.asarray(jf(jp, jnp.asarray(ids))), **CTR_TOL)
    want = float(jrs.two_tower_loss(jp, jnp.asarray(u), jnp.asarray(i)))
    got = float(model(torch.from_numpy(u), torch.from_numpy(i)).detach())
    np.testing.assert_allclose(got, want, **CTR_TOL)
    shapes = trs.param_tree(trs.init_two_tower(
        torch.Generator().manual_seed(0), 50, 80, d=16, hidden=32,
        device="cpu"))
    assert _t_shapes(shapes) == _ref_shapes(params)


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_follows_the_reference_gather(weighted):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(37, 24)).astype(np.float32)
    ids = rng.integers(-40, 80, (9, 13)).astype(np.int32)
    ids[0, :5] = [-1, 37, 36, 0, -37]
    w = rng.uniform(size=ids.shape).astype(np.float32) if weighted else None
    want = jrs.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                             None if w is None else jnp.asarray(w))
    REF_CALLS.clear()
    got = trs.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            None if w is None else torch.from_numpy(w))
    assert REF_CALLS["embedding_bag"] == 1     # kernel H's plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CTR_TOL)
    # the rule itself: on 5 rows, ids 7, -1, 100, -7 read rows 4, 4, 4, 0
    np.testing.assert_array_equal(
        trs.gather_index(torch.tensor([7, -1, 100, -7]), 5).numpy(),
        [4, 4, 4, 0])
    np.testing.assert_array_equal(
        np.asarray(jnp.arange(5)[jnp.asarray([7, -1, 100, -7])]), [4, 4, 4, 0])


@pytest.mark.parametrize("stream", ["ctr dense", "ctr", "behavior"])
def test_streams_equal_bit_for_bit(stream):
    if stream == "behavior":
        js, ts = (m.BehaviorStream(3000, hist_len=20, seed=4)
                  for m in (jdata, tdata))
    else:
        sizes = _smoke(jconfigs.get_arch("dlrm-mlperf").config).table_sizes
        nd = 13 if stream == "ctr dense" else 0
        js, ts = (m.CTRStream(sizes, n_dense=nd, seed=9)
                  for m in (jdata, tdata))
    for b in (5, 64):
        want, got = js.batch(b), ts.batch(b)
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# retrieval programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RECSYS)
def test_retrieval_program_matches(arch):
    jc, tc, params, model = _model(arch)
    cell = _cell(arch, "retrieval_cand")
    jmesh11 = jmesh.make_test_mesh((1, 1))
    jprog = jsteps._recsys_retrieval_program(
        _spec(jconfigs, arch, jc), cell, jmesh11, False)
    tprog = tsteps._recsys_retrieval_program(
        _spec(tconfigs, arch, tc), cell, Mesh((1, 1), device="cpu"), False)
    if jc.model == "mind":
        hist = _batch(jc, 1, seed=21)["hist"]
        want = jax.jit(jprog.fn)(params, jnp.asarray(hist))
        got = tprog.fn(model, torch.from_numpy(hist))
        tol = MIND_TOL
    else:
        # 3,000 candidates, most past the last table (<= 504 rows): those
        # read its last row and tie
        user = _batch(jc, 1, seed=22)
        cand = np.arange(3000, dtype=np.int32)
        with jmesh11:      # its sharding constraint names the mesh's axes
            want = jax.jit(jprog.fn)(params, {k: jnp.asarray(v)
                                              for k, v in user.items()},
                                     jnp.asarray(cand))
        got = tprog.fn(model, _t(user), torch.from_numpy(cand))
        tol = CTR_TOL
    assert got[0].shape == want[0].shape and got[1].dtype == torch.int32
    separated = _topk_equal(got, want, tol)
    assert separated > 0 or jc.model != "mind"
    assert _t_shapes(tprog.args) == _ref_shapes(jprog.args)
    assert tprog.meta == jprog.meta


def test_top_k_keeps_the_lower_index_on_ties():
    s = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -0.5, 3.0]], np.float32)
    want = jax.lax.top_k(jnp.asarray(s), 4)
    got = tsteps._top_k(torch.from_numpy(s), 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _runs(d, ids):
    """The first entry of each run of equal ids."""
    first = np.ones(ids.shape, bool)
    first[1:] = ids[1:] != ids[:-1]
    return d[first], ids[first]


def _reference_draws(key, jcfg, n, d):
    rc = jcfg.resolved(n)
    fn = jax.jit(jforest._batched_level_draws(jax.random.split(key,
                                                               rc.n_trees),
                                              rc, d, "compat"))
    return lambda level: tuple(np.array(a) for a in fn(level))


def test_mind_rpf_retrieval_matches_under_the_reference_draws():
    jc, tc, params, model = _model("mind")
    cell = _cell("mind", "retrieval_cand")
    jm = jmesh.make_test_mesh((1, 1))
    jprog = jsteps._mind_rpf_retrieval_program(
        _spec(jconfigs, "mind", jc), cell, jm, False)
    key = jax.random.key(8)
    with jm:
        jforest_ = jsharded.build_sharded_index(
            key, jnp.asarray(params["item_embed"]), JFOREST, jm,
            db_axes=("data",), tree_axis="model").forest
        hist = _batch(jc, 1, seed=23)["hist"]
        want = jprog.fn(params, jnp.asarray(hist), jforest_)
    draws = CellDraws(lambda di, ti, n: _reference_draws(
        jax.random.fold_in(jax.random.fold_in(key, di), ti), JFOREST, n,
        jc.embed_dim))
    tm = Mesh((1, 1), device="cpu")
    tprog = tsteps._mind_rpf_retrieval_program(
        _spec(tconfigs, "mind", tc), cell, tm, False, draws=draws)
    forest = tsteps.build_catalog_index(model, tm, draws=draws)
    # the cell's forest is the reference's, bit for bit
    (cell_id, tf), = forest.cells
    assert cell_id == (0, 0)
    for name in tforest.Forest._fields:
        want_arr = np.asarray(getattr(jforest_, name))[0, 0]
        np.testing.assert_array_equal(getattr(tf, name).numpy(), want_arr)
    got = tprog.fn(model, torch.from_numpy(hist), forest)
    assert got[0].shape == (1, 100)
    # the merge keeps an item once per interest that found it, side by
    # side at one distance: compare the runs of equal ids, distances
    # ascending (l2), by the compare rule on negated distances
    (gd, gi), (wd, wi) = [_runs(np.asarray(d).ravel(), np.asarray(i).ravel())
                          for d, i in (got, want)]
    assert len(gi) == len(wi)
    assert _topk_equal((-gd, gi), (-wd, wi),
                       dict(rtol=1e-5, atol=1e-6)) > len(wi) // 2
    assert _t_shapes(tprog.args) == _ref_shapes(jprog.args)
    assert tprog.meta == jprog.meta


# ---------------------------------------------------------------------------
# build_cell at full size: meta, shapes and refusals
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jmesh11():
    return jmesh.make_test_mesh((1, 1))


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_meta_and_args_at_full_size(arch):
    jspec = jconfigs.get_arch(arch)
    variants = ["base"] + (["rpf=1"] if arch == "mind" else [])
    for cell in jspec.cells:
        if cell.kind == "train":
            # no train program yet: its meta from the same params
            jp = jax.eval_shape(jsteps._recsys_init(jspec.config))
            tp = tsteps._params_sds(tconfigs.get_arch(arch).config)
            assert tsteps._recsys_meta(tconfigs.get_arch(arch).config, cell,
                                       tp) == \
                jsteps._recsys_meta(jspec.config, cell, jp)
            continue
        for variant in variants:
            if variant != "base" and cell.kind != "retrieval":
                continue
            want = jsteps.build_cell(arch, cell.name, _jmesh11(), False,
                                     variant=variant)
            got = tsteps.build_cell(arch, cell.name, variant=variant,
                                    device="cpu")
            assert got.meta == want.meta, (cell.name, variant)
            assert _t_shapes(got.args) == _ref_shapes(want.args)


@pytest.mark.parametrize("cell", ["molecule", "full_graph_sm",
                                  "minibatch_lg", "ogb_products"])
def test_gnn_cells_meta_and_args_at_full_size(cell):
    # the reference caches its CG tables on first use; a first use under
    # its build_cell's eval_shape would cache tracers
    jmace._paths_and_cg(2)
    want = jsteps.build_cell("mace", cell, _jmesh11(), False)
    got = tsteps.build_cell("mace", cell, device="cpu")
    assert got.meta == want.meta
    assert _t_shapes(got.args) == _ref_shapes(want.args)
    with pytest.raises(ValueError, match="unknown gnn variant"):
        tsteps.build_cell("mace", cell, variant="nope=1", device="cpu")
    if cell != "ogb_products":   # the one-card node cut is that cell's
        with pytest.raises(ValueError, match="unknown gnn variant"):
            tsteps.build_cell("mace", cell, variant="nodes=64", device="cpu")


def test_build_cell_variants():
    with pytest.raises(ValueError, match="no program"):
        tsteps.build_cell("rpf-mnist784", "query_batch", device="cpu")
    with pytest.raises(ValueError, match="unknown recsys variant"):
        tsteps.build_cell("mind", "serve_p99", variant="nope=1",
                          device="cpu")
    capped = tsteps.build_cell("dlrm-mlperf", "retrieval_cand",
                               variant="rows=4000000,cand=131072",
                               device="cpu")
    assert capped.args[2].shape == (131072,)
    assert max(t.shape[0] for t in capped.args[0]["tables"]) == 4_001_792
    # real arguments from a generator: the same seed, the same arguments
    prog = tsteps.build_cell("autoint", "serve_p99", device="cpu")
    a1, a2 = (prog.make_args(torch.Generator().manual_seed(5))
              for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a1[0].parameters(),
                                                   a2[0].parameters()))
    assert torch.equal(a1[1]["sparse"], a2[1]["sparse"])
    assert _t_shapes(tsteps._sds(a1[1])) == _t_shapes(prog.args[1])
