"""The port's last modules held against the reference's:
``repro_torch.distributed`` (the re-exports), ``launch/steps.py``'s
``CellProgram.meta_args``, ``launch/dryrun.py`` (the one-card dry run on
the ``meta`` device) and ``roofline.py`` (the H100's constants).

The dry run's counts are held against arithmetic written out here for one
cell of each family, from the configuration and the port's own products
(FLOPs as ``torch.utils.flop_counter`` counts them: 2 m n k a product):

* an LM train step (smollm-135m ``train_4k``): per token and layer the
  q / k / v / o projections, the SwiGLU MLP (3 products) and the attention
  over all S keys (scores and values, the full square: the causal half is
  not skipped), three passes (the forward and two in the backward) and, under
  ``remat``, the checkpointed MLP and attention once more; the tied logits
  three passes.  ``model_flops`` counts 6 N and the causal half, so the
  count lies above it.
* an MoE decode step (granite-moe-1b ``decode_32k``): per token and layer
  the projections, the router and the attention over the whole cache; per
  layer every expert's SwiGLU on all cap + 1 slots (cap =
  ``int(max(top_k * capacity_factor * T / E, 4))``); the logits.
* ``mace/molecule``: ``model_flops`` is the reference's edge tensor
  product, radial MLP and node CG contractions, three passes; the port
  runs the same products and two more: the harmonics times the CG tables
  per edge ((E, 9) @ (9, 9 W), under a tenth of the edge product at C =
  128) and the node products' 0 / 1 scatter ((K, M), at most the table
  product again, a >= 1 rows a block), so the count lies between 1 and 2
  times ``model_flops``.
* ``mind/serve_p99``: per user the bilinear map (2 H d^2), each interest's
  residual MLP (d -> 4d -> d, 16 d^2 a interest), two routing products an
  iteration (2 K H d each) and the label-aware attention (2 K d twice);
  ``model_flops`` counts one interest's MLP, so the count lies above it.
* ``dlrm-mlperf/train_batch``: ``model_flops`` is three times the forward;
  the first bottom layer takes no input gradient (the dense features are
  data), so the count is ``model_flops`` less 2 B n_dense bot_mlp[0],
  exactly.

Argument bytes are held equal to the reference's ``build_cell(...,
make_test_mesh((1, 1)), False).args``.
"""
import json
import math

import jax
import pytest

from jax_release import release_compiled_executables  # noqa: F401
import repro.distributed as jdist
from repro import roofline as jroof
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
import repro_torch.distributed as tdist
from repro_torch import roofline
from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.core.search import merge_topk_pairs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models.layers import Axes
from repro_torch.tree import flatten_with_names

CELLS = [(a, c.name) for a in ASSIGNED for c in get_arch(a).cells
         if not c.skip]
# one cell of each family: (arch, cell)
FAMILY_CELLS = [("smollm-135m", "train_4k"),
                ("granite-moe-1b-a400m", "decode_32k"),
                ("mace", "molecule"), ("mind", "serve_p99"),
                ("dlrm-mlperf", "train_batch")]


def test_distributed_reexports():
    assert tdist.__all__ == jdist.__all__
    assert tdist.merge_topk_pairs is merge_topk_pairs
    assert tdist.dp_axes is tmesh.dp_axes
    assert tdist.make_production_mesh is tmesh.make_production_mesh
    assert tdist.make_test_mesh is tmesh.make_test_mesh
    assert tdist.Axes is Axes
    assert tdist.dp_axes(True) == jdist.dp_axes(True)
    assert tdist.make_production_mesh(device="cpu").shape == {
        "data": 16, "model": 16}


@pytest.mark.parametrize("arch,cell", CELLS,
                         ids=[f"{a}/{c}" for a, c in CELLS])
def test_meta_args_match_args(arch, cell):
    """``meta_args`` gives ``args``' leaves (names, shapes, dtypes) on
    ``meta``; a train state's parameters require grad, as ``make_args``'
    do, and its step, moments and batch do not."""
    prog = steps.build_cell(arch, cell, device="meta")
    got = flatten_with_names(prog.meta_args())
    want = flatten_with_names(prog.args)
    assert [n for n, _ in got] == [n for n, _ in want]
    trains = prog.meta["kind"] == "train"
    for (name, t), (_, s) in zip(got, want):
        assert t.device.type == "meta", name
        assert (tuple(t.shape), t.dtype) == (s.shape, s.dtype), name
        if trains:
            assert t.requires_grad == name.startswith("0/params/"), name
        elif not name.startswith("0/"):
            assert not t.requires_grad, name


def test_meta_args_draw_no_data(monkeypatch):
    """No stream, generator or sampler runs: each raises if called."""
    def refuse(*a, **k):
        raise AssertionError("meta_args drew host data")

    for name in ("MarkovTokens", "BehaviorStream", "CTRStream",
                 "NeighborSampler", "random_graph", "batched_molecules",
                 "build_catalog_index", "gnn_batch", "lm_tokens",
                 "recsys_data"):
        monkeypatch.setattr(steps, name, refuse)
    for arch, cell in [("mace", "minibatch_lg"), ("mace", "ogb_products"),
                       ("smollm-135m", "train_4k"), ("mind", "train_batch"),
                       ("dlrm-mlperf", "retrieval_cand")]:
        steps.build_cell(arch, cell, device="meta").meta_args()
    prog = steps.build_cell("mind", "retrieval_cand", variant="rpf=1",
                            device="meta")
    _, _, forest = prog.meta_args()
    assert [(di, ti) for (di, ti), _ in forest.cells] == [(0, 0)]


@pytest.fixture(scope="module")
def family_records():
    return {(a, c): dryrun.run_cell(a, c, save=False)
            for a, c in FAMILY_CELLS}


@pytest.mark.parametrize("arch,cell", FAMILY_CELLS,
                         ids=[f"{a}/{c}" for a, c in FAMILY_CELLS])
def test_argument_bytes_match_reference(arch, cell, family_records):
    jax_mesh = jmesh.make_test_mesh((1, 1))
    if arch == "mace":
        # the reference caches its CG tables on first use: fill the cache
        # before its build traces init_mace
        from repro.models import mace as jmace
        jmace._paths_and_cg(2)
    jprog = jsteps.build_cell(arch, cell, jax_mesh, False)
    want = sum(math.prod(x.shape) * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(jprog.args))
    rec = family_records[(arch, cell)]
    assert rec["memory"]["argument_bytes"] == want
    assert rec["meta"]["model_flops"] == pytest.approx(
        jprog.meta["model_flops"], rel=1e-12)


def _lm_layer_terms(cfg, s):
    """Per token and layer: (projections, SwiGLU MLP, attention over s
    keys); and the logits a token."""
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.head_dim, (
        cfg.n_kv_heads * cfg.head_dim)
    proj = 2 * d * (hq + 2 * hkv) + 2 * hq * d
    mlp = 3 * 2 * d * cfg.d_ff
    attn = 2 * 2 * s * hq
    return proj, mlp, attn, 2 * d * cfg.padded_vocab


def _expected_flops(arch, cell_name):
    spec = get_arch(arch)
    cfg = spec.config
    cell = {c.name: c for c in spec.cells}[cell_name]
    if arch == "smollm-135m":
        t = cell.global_batch * cell.seq_len
        proj, mlp, attn, logits = _lm_layer_terms(cfg, cell.seq_len)
        layer = 3 * (proj + mlp + attn) + (mlp + attn if cfg.remat else 0)
        return t * (cfg.n_layers * layer + 3 * logits)
    if arch == "granite-moe-1b-a400m":
        t = cell.global_batch
        proj, _, attn, logits = _lm_layer_terms(cfg, cell.seq_len)
        cap = int(max(cfg.top_k * cfg.capacity_factor * t / cfg.n_experts,
                      4))
        experts = cfg.n_experts * (cap + 1) * 3 * 2 * cfg.d_model * cfg.d_ff
        router = 2 * cfg.d_model * cfg.n_experts
        return (t * (cfg.n_layers * (proj + router + attn) + logits)
                + cfg.n_layers * experts)
    if arch == "mind":
        d, h, k = cfg.embed_dim, cfg.hist_len, cfg.n_interests
        return cell.batch * (2 * h * d * d + 16 * k * d * d
                             + 2 * cfg.capsule_iters * 2 * k * h * d
                             + 2 * 2 * k * d)
    if arch == "dlrm-mlperf":
        meta = steps.build_cell(arch, cell_name, device="meta").meta
        return meta["model_flops"] - 2 * cell.batch * cfg.n_dense * (
            cfg.bot_mlp[0])
    return None


@pytest.mark.parametrize("arch,cell", FAMILY_CELLS,
                         ids=[f"{a}/{c}" for a, c in FAMILY_CELLS])
def test_flops_against_arithmetic(arch, cell, family_records):
    rec = family_records[(arch, cell)]
    assert rec["trace_s"] < 30
    counted, model = rec["cost"]["flops"], rec["meta"]["model_flops"]
    assert counted == sum(rec["cost"]["flops_by_op"].values())
    if arch == "mace":
        assert model <= counted <= 2 * model
        return
    assert counted == _expected_flops(arch, cell)
    if arch == "dlrm-mlperf":
        assert counted < model
    else:
        assert counted >= model


def test_flops_follow_a_cut():
    """``nl`` and ``batch`` cut an LM cell's count as they cut its work."""
    full = dryrun.run_cell("smollm-135m", "decode_32k", save=False)
    cut = dryrun.run_cell("smollm-135m", "decode_32k", "nl=15,batch=8",
                          save=False)
    cfg = get_arch("smollm-135m").config
    cell = {c.name: c for c in get_arch("smollm-135m").cells}["decode_32k"]
    proj, mlp, attn, logits = _lm_layer_terms(cfg, cell.seq_len)
    for rec, nl, b in ((full, cfg.n_layers, cell.global_batch),
                       (cut, 15, 8)):
        assert rec["cost"]["flops"] == b * (nl * (proj + mlp + attn)
                                            + logits)
    assert cut["meta"]["model_flops"] < full["meta"]["model_flops"]


@pytest.mark.parametrize("arch,cell", CELLS,
                         ids=[f"{a}/{c}" for a, c in CELLS])
def test_analytic_model_bytes_match_reference(arch, cell):
    kind = {c.name: c for c in get_arch(arch).cells}[cell].kind
    # the reference's roofline passes its meta's kind: "serve" for a
    # retrieval cell
    for k in {kind, "serve" if kind == "retrieval" else kind}:
        assert roofline.analytic_model_bytes(arch, cell, k) == \
            jroof.analytic_model_bytes(arch, cell, k)


def test_analytic_model_bytes_follow_cuts():
    base = roofline.analytic_model_bytes("smollm-135m", "decode_32k",
                                         "decode")
    cut = roofline.analytic_model_bytes("smollm-135m", "decode_32k",
                                        "decode", "batch=8")
    cfg = get_arch("smollm-135m").config
    cache_row = (cfg.n_layers * 32768 * cfg.n_kv_heads * cfg.head_dim * 4)
    assert base - cut == (128 - 8) * cache_row
    assert roofline.analytic_model_bytes(
        "wide-deep", "retrieval_cand", "retrieval", "cand=131072") == (
        131072 * get_arch("wide-deep").config.embed_dim * 4)
    full = roofline.analytic_model_bytes("mace", "ogb_products", "train")
    eighth = roofline.analytic_model_bytes("mace", "ogb_products", "train",
                                           "nodes=306128")
    assert eighth == pytest.approx(full / 8, rel=1e-5)


def test_roofline_terms_by_hand():
    rec = {"arch": "mind", "cell": "serve_p99", "mesh": "card",
           "variant": "base", "kind": "serve", "compute_dtype": "float32",
           "memory": {"argument_bytes": 6_700_000_000,
                      "output_bytes": 3_350_000_000},
           "cost": {"flops": 134_000_000_000},
           "collectives": {"total_bytes": 0},
           "meta": {"model_flops": 67_000_000_000, "kind": "serve"}}
    t = roofline.roofline_terms(rec)
    assert t["compute_s"] == pytest.approx(134e9 / 67e12)       # 2 ms
    assert t["memory_s"] == pytest.approx(10.05e9 / 3.35e12)    # 3 ms
    assert t["collective_s"] == 0.0
    assert (t["dominant"], t["bound_s"]) == ("memory",
                                             pytest.approx(3e-3))
    bytes_ = 512 * 50 * 64 * 4
    assert t["model_bytes"] == bytes_
    assert t["ideal_s"] == pytest.approx(max(1e-3, bytes_ / 3.35e12))
    assert t["model_flops_ratio"] == pytest.approx(0.5)
    assert t["roofline_fraction"] == pytest.approx(1e-3 / 3e-3)
    assert t["fits_hbm"]
    bf16 = roofline.roofline_terms(dict(rec, compute_dtype="bfloat16"))
    assert bf16["compute_s"] == pytest.approx(134e9 / 989e12)


def test_dryrun_cli(tmp_path, monkeypatch, capsys):
    out = str(tmp_path)
    recs = dryrun.main(["--arch", "mind", "--cell", "serve_p99",
                        "--out", out])
    path = dryrun.artifact_path("mind", "serve_p99", directory=out)
    with open(path) as f:
        rec = json.load(f)
    assert rec == json.loads(json.dumps(recs[0]))
    assert (rec["mesh"], rec["n_devices"], rec["variant"]) == ("card", 1,
                                                              "base")
    assert rec["collectives"]["total_bytes"] == 0
    assert path.endswith("mind__serve_p99__card.json")
    dryrun.main(["--arch", "mind", "--cell", "serve_p99", "--variant",
                 "rows=20000", "--out", out])
    assert dryrun.main(["--arch", "mind", "--cell", "serve_p99", "--out",
                        out, "--skip-existing"]) == []
    rows = roofline.merged_table(out)
    assert [(r["cell"], r["variant"]) for r in rows] == [
        ("serve_p99", "base"), ("serve_p99", "rows=20000")]
    assert rows[1]["argument_gib"] < rows[0]["argument_gib"]
    table = roofline.format_table(rows)
    assert "rows=20000" in table and "mind" in table
    # a cell that cannot trace fails the run
    monkeypatch.setattr(steps, "build_cell", lambda *a, **k: 1 / 0)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mind", "--cell", "serve_p99", "--out", out])
    assert e.value.code == 1
