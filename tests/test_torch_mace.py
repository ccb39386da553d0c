"""The port's MACE (``repro_torch.models.mace``, ``models.equivariant``,
``data.graph_data``) held against the reference's (``repro.models.mace``,
``repro.models.equivariant``, ``repro.data.graph_data``).

Small sizes: ``d_hidden`` 8, 1-2 layers, ``batched_molecules(4, 12, 32)``
and ``random_graph(64, 256)`` with 16 node features and 5 classes, its
edges sorted for 4 shards (``sort_edges_for_mesh``, masked padding).  The
parameters are the reference's ``init_mace`` trees, carried into the port
by ``convert.mace_from_numpy``.  The reference runs once per module, in
one jitted function in a subprocess, so that its large XLA compile stays
out of the test process: the outputs and the gradients of ``sum(out *
ct)`` (seeded cotangents over every output) on each graph, and the other
forwards.  The two gloo ranks run as two subprocesses without JAX.

Tolerances: the numpy tables and generators bit for bit; the harmonics
within 1e-7; f32 outputs rtol 1e-5 / atol 1e-6; bf16 exchange 2^-7 of the
largest output (one bf16 unit of ``h``); gradients rtol 1e-4 / atol 1e-6
x the largest; the mesh paths against the local reference rtol 2e-4 /
atol 2e-5 (``tests/test_multidevice.py``'s); two gloo ranks against one
process within 1e-6 of each tensor's largest magnitude; rotations rtol
2e-4 / atol 2e-5 (``tests/test_property.py``'s).  ``launch.steps.gnn_batch``
is checked on small cells without the reference.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
from repro.configs.base import MACEConfig as JMACEConfig
from repro.data import graph_data as jgraph
from repro.models import equivariant as jeq
from repro.models import mace as jmace
from repro_torch.configs.base import MACEConfig, ShapeCell
from repro_torch.convert import mace_from_numpy
from repro_torch.core.sharded_index import Mesh
from repro_torch.data import graph_data as tgraph
from repro_torch.launch import steps as tsteps
from repro_torch.models import equivariant as teq
from repro_torch.models import mace as tmace
from repro_torch.models.layers import Axes
from repro_torch.tree import flatten_with_names

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = dict(rtol=1e-5, atol=1e-6)
MESH_TOL = dict(rtol=2e-4, atol=2e-5)
SMALL = dict(d_hidden=8, n_layers=2)
N_CLASSES = 5


def _cfgs(**kw):
    """(the reference's config, the port's) with ``kw`` over ``SMALL``."""
    j = JMACEConfig(**{**SMALL, **kw})
    return j, MACEConfig(**dataclasses.asdict(j))


def _graphs():
    """The molecules and the node-classification graph as numpy arrays."""
    mol = jgraph.batched_molecules(4, 12, 32, seed=0)
    g = jgraph.random_graph(64, 256, d_feat=16, seed=0)
    s, r, em = jgraph.sort_edges_for_mesh(g["senders"], g["receivers"], 64, 4)
    rng = np.random.default_rng(1)
    cls = {"species": g["species"] % 16, "positions": g["positions"],
           "senders": s, "receivers": r, "edge_mask": em,
           "node_feat": g["node_feat"],
           "ct_energy": rng.normal(size=1).astype(np.float32),
           "ct_node_inv": rng.normal(size=(64, 8)).astype(np.float32),
           "ct_node_logits": rng.normal(size=(64, N_CLASSES)).astype(
               np.float32)}
    mol = {k: v for k, v in mol.items() if k != "n_graphs"}
    mol["ct_energy"] = rng.normal(size=4).astype(np.float32)
    mol["ct_node_inv"] = rng.normal(size=(48, 8)).astype(np.float32)
    return mol, cls


MOL, CLS = _graphs()


def _fill_reference_cache():
    """The reference caches its CG tables on first use: a first use under
    ``jax.eval_shape`` would cache tracers, so fill the cache eagerly."""
    jmace._paths_and_cg(2)


def _fwd_kwargs(g, lib):
    """mace_fwd's graph arguments of ``g`` as ``lib`` arrays."""
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    kw = {k: conv(g[k]) for k in ("species", "positions", "senders",
                                  "receivers")}
    if "graph_ids" in g:
        kw.update(graph_ids=conv(g["graph_ids"]), n_graphs=4)
    else:
        kw.update(node_feat=conv(g["node_feat"]),
                  edge_mask=conv(g["edge_mask"]))
    return kw


def _loss(out, g, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return sum((out[k] * conv(g["ct_" + k])).sum() for k in out)


def _ref_named(tree, leaf=np.asarray):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), leaf(v))
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import MACEConfig
from repro.models import mace

small, n_classes = json.loads(sys.argv[3])
z = dict(np.load(sys.argv[1]))
graphs = {t: {k[len(t) + 1:]: v for k, v in z.items() if k.startswith(t)}
          for t in ("mol", "cls")}
mace._paths_and_cg(2)   # filled eagerly: under a trace it caches tracers


def cfg(**kw):
    return MACEConfig(**dict(small, **kw))


def kwargs(g):
    kw = {k: jnp.asarray(g[k]) for k in ("species", "positions", "senders",
                                         "receivers")}
    if "graph_ids" in g:
        kw.update(graph_ids=jnp.asarray(g["graph_ids"]), n_graphs=4)
    else:
        kw.update(node_feat=jnp.asarray(g["node_feat"]),
                  edge_mask=jnp.asarray(g["edge_mask"]))
    return kw


def first(p, n):
    return dict(p, layers=p["layers"][:n])


init = jax.jit(mace.init_mace, static_argnums=(1, 2))
p_mol = init(jax.random.key(0), cfg(), 0)
p_cls = init(jax.random.key(1), cfg(d_feat_in=16), n_classes)
grad_cases = {"mol": (cfg(n_layers=1), "mol"),
              "cls": (cfg(d_feat_in=16), "cls")}
fwd_cases = {"corr1": cfg(n_layers=1, correlation_order=1),
             "corr2": cfg(n_layers=1, correlation_order=2),
             "bf16": cfg(exchange_dtype="bfloat16")}


def run(p_mol, p_cls):
    res = {}
    for tag, (c, g) in grad_cases.items():
        def lf(p_, c=c, g=g):
            out = mace.mace_fwd(p_, c, **kwargs(graphs[g]))
            return sum((out[k] * jnp.asarray(graphs[g]["ct_" + k])).sum()
                       for k in out), out
        p = first(p_mol if tag == "mol" else p_cls, c.n_layers)
        (_, res[tag]), res[tag + "_grads"] = jax.value_and_grad(
            lf, has_aux=True)(p)
    for tag, c in fwd_cases.items():
        res[tag] = mace.mace_fwd(first(p_mol, c.n_layers), c,
                                 **kwargs(graphs["mol"]))
    return res


res = jax.device_get(jax.jit(run)(p_mol, p_cls))
res["p_mol"], res["p_cls"] = jax.device_get((p_mol, p_cls))
flat = {}
for tag, tree in res.items():
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat["/".join([tag] + [str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in path])] = np.asarray(v)
np.savez(sys.argv[2], **flat)
"""


def _unflatten(named):
    """A tree from its (``a/b/0/c`` name, leaf) pairs: lists where every
    key is an index."""
    tree = {}
    for name, v in named.items():
        *head, last = name.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v

    def lists(t):
        if not isinstance(t, dict):
            return t
        if all(k.isdigit() for k in t):
            return [lists(t[k]) for k in sorted(t, key=int)]
        return {k: lists(v) for k, v in t.items()}
    return lists(tree)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's parameters, outputs and gradients, from one jitted
    function in a subprocess (its XLA compile stays out of the test
    process): the outputs and gradients on the molecules (one layer) and on
    the classification graph (two), and the forwards at correlation orders
    1 and 2 (one layer) and under bf16 exchange (two)."""
    d = tmp_path_factory.mktemp("mace_ref")
    np.savez(d / "in.npz", **{f"{t}/{k}": v for t, g in (("mol", MOL),
                                                          ("cls", CLS))
                             for k, v in g.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(d / "in.npz"),
         str(d / "ref.npz"), json.dumps([SMALL, N_CLASSES])],
        capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(d / "ref.npz") as z:
        by_tag = {}
        for name in z.files:
            tag, _, rest = name.partition("/")
            by_tag.setdefault(tag, {})[rest] = z[name]
    res = {tag: (list(leaves.items()) if tag.endswith("_grads")
                 else _unflatten(leaves))
           for tag, leaves in by_tag.items()}
    return res


def _first_layers(p, n):
    return {**p, "layers": p["layers"][:n]}


def _port_params(ref, tag, n_layers=2):
    return mace_from_numpy(_first_layers(ref["p_" + tag], n_layers), "cpu")


def _port_run(params, cfg, g, **kw):
    """(outputs, [(name, gradient)]) of sum(out * ct) in the port."""
    out = tmace.mace_fwd(params, cfg, **_fwd_kwargs(g, "torch"), **kw)
    named = flatten_with_names(params)
    grads = torch.autograd.grad(_loss(out, g, "torch"),
                                [t for _, t in named])
    return ({k: v.detach().float().numpy() for k, v in out.items()},
            [(n, gr.numpy()) for (n, _), gr in zip(named, grads)])


def _grads_close(got, want, rtol=1e-4, atol_frac=1e-6, **kw):
    """Two lists of (name, gradient), leaf by leaf, over the same names."""
    want = dict(want)
    assert sorted(n for n, _ in got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, g in got:
        np.testing.assert_allclose(g, want[name], rtol=rtol,
                                   atol=kw.get("atol", atol_frac * top),
                                   err_msg=name)


def _outs_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# tables and data
# ---------------------------------------------------------------------------


def test_tables_and_paths_equal_the_reference():
    for l_max in range(3):
        assert teq.coupling_paths(l_max) == jeq.coupling_paths(l_max)
    assert len(teq.coupling_paths(2)) == 15
    assert teq.L_SLICES == jeq.L_SLICES
    for l in range(3):
        np.testing.assert_array_equal(teq.real_sh_transform(l),
                                      jeq.real_sh_transform(l))
    tabs = tmace._tables(2, torch.device("cpu"), torch.float32)
    edge = tabs.edge.view(9, 9, -1).transpose(0, 1)     # [a, b, col]
    col = 0
    for p in tabs.by_l3.tolist():
        path = tabs.paths[p]
        want = jeq.real_clebsch_gordan(*path)
        np.testing.assert_array_equal(teq.real_clebsch_gordan(*path), want)
        np.testing.assert_array_equal(teq.clebsch_gordan(*path),
                                      jeq.clebsch_gordan(*path))
        # the port's tables hold the reference's f32 coefficients
        want32 = np.asarray(jnp.asarray(want, jnp.float32))
        s1, s2, k = teq.L_SLICES[path[0]], teq.L_SLICES[path[1]], want.shape[2]
        np.testing.assert_array_equal(edge[s1, s2, col:col + k].numpy(),
                                      want32)
        col += k
        g, col_path, _ = tabs.node[path[0]]
        cols = (col_path == p).nonzero()[:, 0]
        np.testing.assert_array_equal(
            g.view(want.shape[0], 9, -1)[:, s2][..., cols].numpy(), want32)


def test_real_sph_harm_l2():
    v = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        teq.real_sph_harm_l2(torch.from_numpy(v)).numpy(),
        np.asarray(jeq.real_sph_harm_l2(jnp.asarray(v))), rtol=0, atol=1e-7)


def _equal_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_data_generators_equal_the_reference_bit_for_bit():
    for power_law in (True, False):
        _equal_dicts(tgraph.random_graph(64, 256, 5, seed=3,
                                         power_law=power_law),
                     jgraph.random_graph(64, 256, 5, seed=3,
                                         power_law=power_law))
    g = jgraph.random_graph(100, 700, seed=4)
    for got, want in zip(tgraph.to_csr(g["senders"], g["receivers"], 100),
                         jgraph.to_csr(g["senders"], g["receivers"], 100)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for got, want in zip(
            tgraph.sort_edges_for_mesh(g["senders"], g["receivers"], 100, 4),
            jgraph.sort_edges_for_mesh(g["senders"], g["receivers"], 100, 4)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    _equal_dicts(tgraph.batched_molecules(4, 12, 32, seed=1),
                 jgraph.batched_molecules(4, 12, 32, seed=1))


def test_sampler_repairs_the_reference_broadcast():
    """The reference's first hop raises for fanouts (15, 10) (its offsets'
    bound has shape (F,) against draws of (F, f)); the port's gives a
    sample inside the padded shapes, every local id in range, every seed
    present.  Where the reference's bound broadcasts (one seed, one hop)
    both draw the same sample."""
    g = jgraph.random_graph(2000, 40_000, seed=0)
    csr = jgraph.to_csr(g["senders"], g["receivers"], 2000)
    seeds = np.random.default_rng(0).choice(2000, 64, replace=False)
    with pytest.raises(ValueError):
        jgraph.NeighborSampler(*csr, seed=0).sample(seeds, (15, 10))
    smp = tgraph.NeighborSampler(*csr, seed=0).sample(seeds, (15, 10))
    n = len(smp["node_ids"])
    assert n <= 64 * (1 + 15 + 150)
    assert len(smp["senders"]) == len(smp["receivers"]) <= 64 * (15 + 150)
    for k in ("senders", "receivers", "seed_local"):
        assert smp[k].min() >= 0 and smp[k].max() < n, k
    np.testing.assert_array_equal(smp["node_ids"][smp["seed_local"]], seeds)
    # every sampled edge is an edge of the graph (or an isolated node's
    # self-loop), pointing at a frontier node
    ids = smp["node_ids"]
    src, dst = ids[smp["senders"]], ids[smp["receivers"]]
    adj = set(zip(csr[1].tolist(), np.repeat(np.arange(2000), np.diff(
        csr[0])).tolist()))
    assert all((s, d) in adj or s == d for s, d in zip(src.tolist(),
                                                       dst.tolist()))
    _equal_dicts(tgraph.NeighborSampler(*csr, seed=5).sample(
        np.array([7]), (6,)),
        jgraph.NeighborSampler(*csr, seed=5).sample(np.array([7]), (6,)))


@pytest.mark.parametrize("dpn", [1, 2])
def test_gnn_batch_pads_each_shard_with_masked_self_loops(dpn):
    """A full graph's batch (``launch.steps.gnn_batch``) over ``dpn`` dp
    shards: the shapes of ``_gnn_sizes``; padded nodes species 0, position
    0, features 0, label -1; the graph's edges, each in the shard of its
    receiver, then each shard's block padded with masked self-loops on
    its first node."""
    cell = ShapeCell("full_graph_sm", "train", n_nodes=100, n_edges=300,
                     d_feat=6)
    cfg, sizes, n_cls, host_edges = tsteps.gnn_cell_config(
        MACEConfig(**SMALL), cell, "base", dpn)
    b = tsteps.gnn_batch(cell, sizes, cfg, n_cls, 3, dpn, host_edges)
    n, e = sizes.n_nodes, sizes.n_edges
    assert (n, e) == (128, 512)
    assert {k: v.shape for k, v in b.items()} == {
        "species": (n,), "positions": (n, 3), "node_feat": (n, 6),
        "labels": (n,), "senders": (e,), "receivers": (e,),
        "edge_mask": (e,)}
    g = tgraph.random_graph(100, 300, 6, seed=3)
    np.testing.assert_array_equal(b["species"][:100],
                                  g["species"] % cfg.n_species)
    np.testing.assert_array_equal(b["node_feat"][:100], g["node_feat"])
    assert np.all(b["species"][100:] == 0)
    assert np.all(b["positions"][100:] == 0)
    assert np.all(b["node_feat"][100:] == 0)
    assert np.all(b["labels"][100:] == -1)
    assert b["labels"][:100].min() >= 0 and b["labels"][:100].max() < n_cls
    real = b["edge_mask"] == 1
    assert sorted(zip(b["senders"][real].tolist(),
                      b["receivers"][real].tolist())) == sorted(
        zip(g["senders"].tolist(), g["receivers"].tolist()))
    n_loc, per = n // dpn, e // dpn
    for d in range(dpn):
        s, r, m = (b[k][d * per:(d + 1) * per]
                   for k in ("senders", "receivers", "edge_mask"))
        k = int(m.sum())
        assert np.all(m[:k] == 1) and np.all(m[k:] == 0)
        assert np.all(r[:k] // n_loc == d)
        assert np.all(s[k:] == d * n_loc) and np.all(r[k:] == d * n_loc)


def test_gnn_batch_labels_a_sample_on_its_seeds_only():
    """``minibatch_lg``'s batch is a ``NeighborSampler`` sample: its node
    rows are the host graph's at ``node_ids``, only its seeds carry
    labels, its edges are the sample's then masked self-loops on node 0;
    over two dp shards the first shard's share cannot hold the sample's
    edges, and the batch raises rather than drop them."""
    cell = ShapeCell("minibatch_lg", "train", n_nodes=1000, n_edges=90_000,
                     d_feat=6, batch_nodes=8, fanout=(15, 10))
    cfg, sizes, n_cls, host_edges = tsteps.gnn_cell_config(
        MACEConfig(**SMALL), cell, "graph_edges=40000", 1)
    assert host_edges == 40_000
    assert (sizes.n_nodes, sizes.n_edges) == (1344, 1536)
    b = tsteps.gnn_batch(cell, sizes, cfg, n_cls, 3, 1, host_edges)
    host = tgraph.random_graph(1000, 40_000, 6, seed=3)
    csr = tgraph.to_csr(host["senders"], host["receivers"], 1000)
    seeds = np.random.default_rng([3, 1]).choice(1000, 8, replace=False)
    smp = tgraph.NeighborSampler(*csr, seed=3).sample(seeds, (15, 10))
    ids, k = smp["node_ids"], len(smp["node_ids"])
    np.testing.assert_array_equal(b["node_feat"][:k], host["node_feat"][ids])
    np.testing.assert_array_equal(b["positions"][:k], host["positions"][ids])
    assert np.all(b["node_feat"][k:] == 0) and np.all(b["species"][k:] == 0)
    np.testing.assert_array_equal(np.flatnonzero(b["labels"] >= 0),
                                  np.sort(smp["seed_local"]))
    m = len(smp["senders"])
    np.testing.assert_array_equal(b["senders"][:m], smp["senders"])
    np.testing.assert_array_equal(b["receivers"][:m], smp["receivers"])
    assert np.all(b["edge_mask"][:m] == 1) and np.all(b["edge_mask"][m:] == 0)
    assert np.all(b["senders"][m:] == 0) and np.all(b["receivers"][m:] == 0)
    # every receiver is a seed or a first-hop node, below the first of two
    # shards' 672 nodes, whose 768 edge slots are fewer than the sample's
    assert smp["receivers"].max() < 672 and m > 768
    _, sizes2, _, _ = tsteps.gnn_cell_config(MACEConfig(**SMALL), cell,
                                             "graph_edges=40000", 2)
    with pytest.raises(ValueError, match=f"holds {m} edges, more than the "
                                         f"cell's 768"):
        tsteps.gnn_batch(cell, sizes2, cfg, n_cls, 3, 2, host_edges)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_feat, n_classes", [(0, 0), (16, N_CLASSES)])
def test_init_names_and_shapes_equal_the_reference(d_feat, n_classes):
    jcfg, tcfg = _cfgs(d_hidden=128, d_feat_in=d_feat)
    _fill_reference_cache()
    want = _ref_named(jax.eval_shape(
        lambda: jmace.init_mace(jax.random.key(0), jcfg, n_classes)),
        leaf=lambda v: v)
    got = flatten_with_names(tmace.init_mace(None, tcfg, n_classes, "meta"))
    assert [(n, tuple(t.shape), str(t.dtype)) for n, t in got] == \
        [(n, tuple(w.shape), "torch." + np.dtype(w.dtype).name)
         for n, w in want]
    assert all(t.device.type == "meta" for _, t in got)
    p = tmace.init_mace(torch.Generator().manual_seed(0), tcfg, n_classes,
                        "cpu")
    assert all(t.requires_grad for _, t in flatten_with_names(p))
    assert bool((p["layers"][1]["prod2_w"] == 0.3).all())
    assert bool((p["layers"][1]["prod3_w"] == 0.1).all())


def test_bessel_basis():
    r = np.array([0.0, 1e-9, 1e-6, 0.3, 1.0, 2.5, 4.99, 5.0, 7.0],
                 np.float32)
    np.testing.assert_allclose(
        tmace.bessel_basis(torch.from_numpy(r), 8, 5.0).numpy(),
        np.asarray(jmace.bessel_basis(jnp.asarray(r), 8, 5.0)), **TOL)


@pytest.mark.parametrize("tag", ["mol", "cls"])
def test_forward_and_gradients_match_the_reference(ref, tag):
    """Molecules with graph_ids (energy per graph, one layer); the
    classification graph with node features, cls_head and masked padding
    edges (two layers)."""
    kw = {"d_feat_in": 16} if tag == "cls" else {"n_layers": 1}
    cfg = _cfgs(**kw)[1]
    out, grads = _port_run(_port_params(ref, tag, cfg.n_layers), cfg,
                           MOL if tag == "mol" else CLS)
    _outs_close(out, ref[tag], **TOL)
    _grads_close(grads, ref[tag + "_grads"])


@pytest.mark.parametrize("order", [1, 2])
def test_correlation_orders(ref, order):
    cfg = _cfgs(n_layers=1, correlation_order=order)[1]
    with torch.no_grad():
        out = tmace.mace_fwd(_port_params(ref, "mol", 1), cfg,
                             **_fwd_kwargs(MOL, "torch"))
    _outs_close({k: v.numpy() for k, v in out.items()}, ref[f"corr{order}"],
                **TOL)


def test_edge_chunks_match_the_reference(ref):
    """n_edge_chunks 4 (checkpointed chunks, partial scatters summed)
    against the reference's one pass, outputs and gradients."""
    out, grads = _port_run(_port_params(ref, "cls"), _cfgs(d_feat_in=16)[1],
                           CLS, n_edge_chunks=4)
    _outs_close(out, ref["cls"], **TOL)
    _grads_close(grads, ref["cls_grads"])
    e = len(CLS["senders"])
    with pytest.raises(AssertionError, match="chunk multiple"):
        _port_run(_port_params(ref, "cls"), _cfgs(d_feat_in=16)[1], CLS,
                  n_edge_chunks=next(k for k in range(3, e) if e % k))


def test_bf16_exchange(ref):
    cfg = _cfgs(exchange_dtype="bfloat16")[1]
    with torch.no_grad():
        out = tmace.mace_fwd(_port_params(ref, "mol"), cfg,
                             **_fwd_kwargs(MOL, "torch"))
    for k, want in ref["bf16"].items():
        np.testing.assert_allclose(out[k].numpy(), want, rtol=0,
                                   atol=2.0 ** -7 * np.abs(want).max(),
                                   err_msg=k)


def test_a_masked_self_loop_changes_nothing(ref):
    """A padded edge (a self-loop with edge_mask 0) has rbf 0, so its
    radial weights and message are exactly 0: the outputs keep every bit,
    and the gradients, positions' included, stay finite."""
    cfg = _cfgs()[1]
    params = _port_params(ref, "mol")
    kw = _fwd_kwargs(MOL, "torch")
    base = tmace.mace_fwd(params, cfg, **kw)
    e = len(MOL["senders"])
    loops = torch.tensor([5] * 3, dtype=torch.int32)
    kw2 = dict(kw, senders=torch.cat([kw["senders"], loops]),
               receivers=torch.cat([kw["receivers"], loops]),
               edge_mask=torch.cat([torch.ones(e), torch.zeros(3)]),
               positions=kw["positions"].clone().requires_grad_())
    out = tmace.mace_fwd(params, cfg, **kw2)
    for k in base:
        assert torch.equal(out[k], base[k]), k
    named = flatten_with_names(params)
    grads = torch.autograd.grad(_loss(out, MOL, "torch"),
                                [t for _, t in named] + [kw2["positions"]])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_rotation_and_translation_invariance():
    cfg = _cfgs(n_layers=1, n_rbf=4, r_cut=3.0)[1]
    for seed in range(3):
        rng = np.random.default_rng(seed)
        params = tmace.init_mace(torch.Generator().manual_seed(seed), cfg,
                                 device="cpu")
        mol = tgraph.batched_molecules(2, 12, 40, seed=seed)
        kw = {k: torch.from_numpy(mol[k]) for k in (
            "species", "senders", "receivers", "graph_ids")}
        pos = mol["positions"]
        q, r_ = np.linalg.qr(rng.normal(size=(3, 3)))
        rot = (q * np.sign(np.diag(r_))).astype(np.float32)
        if np.linalg.det(rot) < 0:
            rot[:, 0] = -rot[:, 0]
        with torch.no_grad():
            e = [tmace.mace_fwd(params, cfg, positions=torch.from_numpy(
                np.ascontiguousarray(x, np.float32)), n_graphs=2,
                **kw)["energy"].numpy()
                for x in (pos, pos @ rot.T, pos + rng.normal(size=3))]
        np.testing.assert_allclose(e[1], e[0], **MESH_TOL)
        np.testing.assert_allclose(e[2], e[0], **MESH_TOL)


# ---------------------------------------------------------------------------
# the mesh path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_groupless_mesh_matches_the_local_reference(ref, shape):
    """The edges are sorted for 4 shards, so for 2 too: each dp cell
    scatters into its own nodes."""
    mesh = Mesh(shape, device="cpu")
    out, grads = _port_run(_port_params(ref, "cls"), _cfgs(d_feat_in=16)[1],
                           CLS, axes=Axes(("data",), "model", mesh))
    _outs_close(out, ref["cls"], **MESH_TOL)
    _grads_close(grads, ref["cls_grads"], rtol=2e-4, atol=2e-5)


def test_a_group_needs_one_rank_a_cell(ref):
    class OneRank:
        pass
    mesh = Mesh((2, 1), device="cpu")
    mesh.group, mesh.world = OneRank(), 1
    with pytest.raises(ValueError, match="one rank a cell"):
        _port_run(_port_params(ref, "cls"), _cfgs(d_feat_in=16)[1], CLS,
                  axes=Axes(("data",), "model", mesh))


RANKS = """
import os, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs.base import MACEConfig, ShapeCell
from repro_torch.core.sharded_index import Mesh
from repro_torch.models import mace
from repro_torch.models.layers import Axes
from repro_torch.tree import flatten_with_names, unflatten_like


def main(rank, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=2)
    try:
        z = dict(np.load(os.path.join(d, "in.npz")))
        skel = mace.init_mace(None, MACEConfig(d_hidden=8, n_layers=2,
                                               d_feat_in=16), 5, "meta")
        p = unflatten_like(skel, {{n: torch.from_numpy(z["p/" + n])
                                  .requires_grad_()
                                  for n, _ in flatten_with_names(skel)}})
        g = {{k: torch.from_numpy(z[k]) for k in (
            "species", "senders", "receivers", "edge_mask", "node_feat")}}
        pos = torch.from_numpy(z["positions"]).requires_grad_()
        mesh = Mesh((2, 1), device="cpu", group=dist.group.WORLD)
        out = mace.mace_fwd(p, MACEConfig(d_hidden=8, n_layers=2,
                                          d_feat_in=16), positions=pos,
                            axes=Axes(("data",), "model", mesh), **g)
        loss = sum((out[k] * torch.from_numpy(z["ct_" + k])).sum()
                   for k in out)
        named = flatten_with_names(p) + [("positions", pos)]
        gs = torch.autograd.grad(loss, [t for _, t in named])
        res = {{"out/" + k: v.detach().numpy() for k, v in out.items()}}
        res.update({{"g/" + n: g_.numpy() for (n, _), g_ in zip(named, gs)}})
        np.savez(os.path.join(d, f"rank{{rank}}.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[2]), sys.argv[1])
"""


def test_two_gloo_ranks_equal_the_groupless_mesh(ref, tmp_path):
    """(2, 1) over two ranks: the exchange's all-gather and its
    reduce-scatter backward, the readout's gathers and sums, the
    parameters' and positions' gradients summed over the dp peers."""
    params = _port_params(ref, "cls")
    np.savez(tmp_path / "in.npz",
             **{"p/" + n: t.detach().numpy()
                for n, t in flatten_with_names(params)},
             **{k: v for k, v in CLS.items()})
    script = tmp_path / "ranks.py"
    script.write_text(RANKS.format())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ranks = [subprocess.Popen([sys.executable, str(script), str(tmp_path),
                               str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    for run in ranks:
        log = run.communicate(timeout=300)[0]
        assert run.returncode == 0, log

    pos = torch.from_numpy(CLS["positions"]).requires_grad_()
    kw = dict(_fwd_kwargs(CLS, "torch"), positions=pos)
    out = tmace.mace_fwd(params, _cfgs(d_feat_in=16)[1],
                         axes=Axes(("data",), "model",
                                   Mesh((2, 1), device="cpu")), **kw)
    named = flatten_with_names(params) + [("positions", pos)]
    gs = torch.autograd.grad(_loss(out, CLS, "torch"),
                             [t for _, t in named])
    want = {"out/" + k: v.detach().numpy() for k, v in out.items()}
    want.update({"g/" + n: g.numpy() for (n, _), g in zip(named, gs)})
    # an unmasked self-loop (random_graph draws a few) has rvec = 0, where
    # d u / d rvec = I / (r + 1e-12) ~ 4e11: its two endpoints' terms
    # cancel in f32 and leave that node's position gradient to the order
    # of the sums, in both packages; the other nodes' are compared
    loops = (CLS["senders"] == CLS["receivers"]) & (CLS["edge_mask"] > 0)
    keep = ~np.isin(np.arange(64), CLS["senders"][loops])
    assert 0 < (~keep).sum() < 8
    want["g/positions"] = want["g/positions"][keep]
    for r in range(2):
        z = dict(np.load(tmp_path / f"rank{r}.npz"))
        z["g/positions"] = z["g/positions"][keep]
        assert sorted(z) == sorted(want)
        for k, w in want.items():   # the ranks sum in another order
            np.testing.assert_allclose(z[k], w, rtol=0,
                                       atol=1e-6 * np.abs(w).max(), err_msg=k)
