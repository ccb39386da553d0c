"""The cell programs sharded over a ``DeviceMesh``, held against the port's
unsharded programs and (the dense LM) the reference's sharded program.

Small architectures are registered in both packages' registries (the
same shapes): a dense LM (f32, 2 layers, heads split over tp), an MoE LM
(4 experts, top-2, a shared expert, a capacity that drops nothing) and
its top-1 twin under ``moe_a2a`` (the all-to-all dispatch), DLRM with a 20,000-row table (row-split over ``model``), MIND with a
20,000-item catalog and its twin on 4,000 items for the ``rpf=1``
retrieval, and MACE at d_hidden 8 on 4 molecules.

* The reference draws every model's weights with its own ``init_*`` in
  this process; a subprocess with 4 forced host devices runs its dense
  LM's train step and prefill on them, jitted with its ``in_shardings``
  on a (2, 2) mesh.
* The port runs in a second subprocess that imports neither JAX nor the
  reference and spawns four gloo ranks on a (2, 2) ``DeviceMesh``: each
  loads the weights through ``convert.py``, draws the arguments with
  ``make_args`` (one seed), splits them with ``shard_args`` and runs
  ``fn``; rank 0 saves the outputs gathered whole, the expert-parallel
  path each MoE decode took, and the MACE energies' gradient by the
  positions on the mesh and without one.
* This process runs each program unsharded on the same weights and seeds
  (the dense LM's train step also under Adafactor, its factored moments
  placed as the reference's ``_vr`` / ``_vc``).
* MIND's ``rpf=1`` retrieval on the (2, 2) mesh: the reference's
  subprocess builds its stacked forest first and writes it for the gloo
  ranks, then runs its program under its ``in_shardings``; each rank
  builds its own forest cell, runs the sharded step on the program's
  interests (also under a validity bitmap), the cell, and the cell on
  the reference's forest.  Rank cells and steps are held bit for bit
  against the logical ``Mesh((2, 2))`` in this process, the cells by the
  compare rule over runs of equal ids (the merge keeps an item once per
  interest that found it) against the logical program and the
  reference's.

Tolerances (``tests/test_torch_lm.py``'s and ``test_torch_moe.py``'s):
model outputs and train states rtol 1e-5 / atol 1e-5, the recommenders'
and MACE's f32 outputs rtol 1e-5 / atol 1e-6.  The prefill and decode
cells run on an f32 cache (in both packages): the cells' bf16 cache
rounds k and v, which a sharded program sums in another order, to the
neighbouring bf16 value here and there, and a one-unit change of a cache
entry moves the logits by ~3e-3, past the LM gates' 2e-3.

A fake-group dry run of the ``rpf=1`` cell on (4, 2) checks the merge's
all-gather bytes and rank 0's shards; meshes off the default group are
refused.  A fake-group dry run of the dense LM's train cell on (4, 2)
checks the per-rank record: 8 devices, argument bytes the sum of rank 0's shards,
collectives counted, FLOPs within [1/8, 1/8 x 1.25] of the one-card
record's (the batch splits over 4, the projections and logits over 2
more; the attention's heads are gathered whole, so its few products split
over 4 only), and ``roofline_terms`` dividing the ideal by 8.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the small architectures, exec'd with ``base`` the package's configs.base
ARCHS = """
import dataclasses


def tiny_archs(base, mace_cfg):
    lm = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              d_ff=128, vocab_size=500, param_dtype="float32",
              compute_dtype="float32")
    lm_cells = (base.ShapeCell("train_4k", "train", seq_len=16,
                               global_batch=4),
                base.ShapeCell("prefill_32k", "prefill", seq_len=16,
                               global_batch=4),
                base.ShapeCell("decode_32k", "decode", seq_len=16,
                               global_batch=4))
    rc = (base.ShapeCell("train_batch", "train", batch=8),
          base.ShapeCell("serve_p99", "serve", batch=8))
    return {
        "tiny-lm": base.ArchSpec("tiny-lm", "lm", base.LMConfig(
            name="tiny-lm", **lm), lm_cells),
        "tiny-moe": base.ArchSpec("tiny-moe", "lm", base.LMConfig(
            name="tiny-moe", moe=True, n_experts=4, top_k=2,
            capacity_factor=8.0, shared_expert=True, **lm), lm_cells),
        "tiny-moe-a2a": base.ArchSpec("tiny-moe-a2a", "lm", base.LMConfig(
            name="tiny-moe-a2a", moe=True, n_experts=4, top_k=1,
            capacity_factor=8.0, shared_expert=True, moe_a2a=True, **lm),
            lm_cells),
        "tiny-dlrm": base.ArchSpec("tiny-dlrm", "recsys", base.RecsysConfig(
            name="tiny-dlrm", model="dlrm", n_dense=4, n_sparse=3,
            embed_dim=8, table_sizes=(20000, 100, 50), bot_mlp=(16, 8),
            top_mlp=(16, 1)), rc),
        "tiny-mind": base.ArchSpec("tiny-mind", "recsys", base.RecsysConfig(
            name="tiny-mind", model="mind", embed_dim=8, n_interests=4,
            capsule_iters=3, hist_len=6, item_vocab=20000), rc),
        "tiny-mace": base.ArchSpec("tiny-mace", "gnn", dataclasses.replace(
            mace_cfg, d_hidden=8), (base.ShapeCell(
                "molecule", "train", n_nodes=8, n_edges=16, n_graphs=4),)),
        # tiny-mind's twin on a 4,000-item catalog for the rpf=1 retrieval
        # (its forest over 20,000 rows takes seconds to build)
        "tiny-mind-4k": base.ArchSpec("tiny-mind-4k", "recsys",
                                      base.RecsysConfig(
            name="tiny-mind-4k", model="mind", embed_dim=8, n_interests=4,
            capsule_iters=3, hist_len=6, item_vocab=4000), (base.ShapeCell(
                "retrieval_cand", "retrieval", batch=1,
                n_candidates=4000),)),
    }


def nest(flat):
    out = {}
    for name, v in flat.items():
        node, parts = out, name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(out)


SEED = 5
"""

REFERENCE = ARCHS + """
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.configs import base
from repro.data.lm_data import MarkovTokens
from repro.launch import steps
from repro.launch.mesh import make_test_mesh
from repro.models import mace, recsys, transformer
from repro.train.optimizer import adamw, constant_schedule
from repro.train.train_state import TrainState

mace._paths_and_cg(2)
archs = tiny_archs(base, configs.get_arch("mace").config)
configs.REGISTRY.update(archs)
out = {}


def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[prefix + "/" + name] = np.asarray(leaf)


weights = dict(np.load(sys.argv[1]))
in_mesh = (jax.set_mesh if hasattr(jax, "set_mesh") else lambda m: m)

# MIND's rpf=1 retrieval on its (2, 2) mesh under its in_shardings; the
# stacked forest goes to the gloo ranks as soon as it is built
from repro.core import sharded_index as jsharded
from repro.core.forest import ForestConfig
mind = jax.tree.map(jnp.asarray, nest({k[len("w/mind4k/"):]: v
                                       for k, v in weights.items()
                                       if k.startswith("w/mind4k/")}))
spec = archs["tiny-mind-4k"]
mesh = make_test_mesh((2, 2))
prog = steps._mind_rpf_retrieval_program(spec, spec.cells[0], mesh, False)
with in_mesh(mesh):
    forest = jsharded.build_sharded_index(
        jax.random.key(0), mind["item_embed"],
        ForestConfig(n_trees=80, capacity=16, split_ratio=0.3), mesh,
        db_axes=("data",), tree_axis="model").forest
    forest_path = os.path.join(os.path.dirname(sys.argv[2]), "rpf_forest")
    np.savez(forest_path + ".tmp.npz",
             **{k: np.asarray(v) for k, v in forest._asdict().items()})
    os.replace(forest_path + ".tmp.npz", forest_path + ".npz")
    d, i = jax.jit(prog.fn, in_shardings=prog.in_shardings)(
        *jax.device_put((mind, jnp.asarray(weights["rpf/hist"]), forest),
                        prog.in_shardings))
out["ref/rpf/d"], out["ref/rpf/i"] = np.asarray(d), np.asarray(i)

p = jax.tree.map(jnp.asarray, nest({k[len("w/lm/"):]: v
                                    for k, v in weights.items()
                                    if k.startswith("w/lm/")}))

cfg = archs["tiny-lm"].config
mesh = make_test_mesh((2, 2))
tok = MarkovTokens(cfg.vocab_size, seed=SEED).sample(4, 16)
prog = steps.build_cell("tiny-lm", "train_4k", mesh, False)
opt = adamw(constant_schedule(1e-4), state_dtype=jnp.float32)
state = TrainState(jnp.zeros((), jnp.int32), p, opt.init(p), None)
batch = {"tokens": jnp.asarray(tok[:, :-1]), "labels": jnp.asarray(tok[:, 1:])}
with in_mesh(mesh):
    new_state, metrics = jax.jit(prog.fn, in_shardings=prog.in_shardings)(
        *jax.device_put((state, batch), prog.in_shardings))
    out["ref/train/loss"] = np.asarray(metrics["loss"])
    save("ref/train/params", new_state.params)
    prog = steps.build_cell("tiny-lm", "prefill_32k", mesh, False)
    cache = transformer.init_cache(cfg, 4, 16, jnp.float32)
    logits, cache = jax.jit(prog.fn, in_shardings=prog.in_shardings)(
        *jax.device_put((p, cache, jnp.asarray(tok[:, :-1])),
                        prog.in_shardings))
out["ref/prefill/logits"] = np.asarray(logits)
np.savez(sys.argv[2], **out)
"""

PORT = ARCHS + """
import os, socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES = [("tiny-lm", "train_4k"), ("tiny-lm", "train_4k@opt=adafactor"),
         ("tiny-lm", "prefill_32k"),
         ("tiny-moe", "decode_32k"), ("tiny-moe-a2a", "decode_32k"),
         ("tiny-dlrm", "serve_p99"), ("tiny-dlrm", "train_batch"),
         ("tiny-mind", "serve_p99"), ("tiny-mace", "molecule")]


def rank_main(rank, port, weights, out_path):
    torch.set_num_threads(1)     # small shapes: a thread a rank
    from repro_torch import configs
    from repro_torch.configs import base
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models import recsys as rs
    from repro_torch.models.layers import P, placements
    from repro_torch.tree import flatten_with_names
    sys.path.insert(0, os.path.dirname(out_path))
    import sharded_common as common
    configs.REGISTRY.update(tiny_archs(base, configs.get_arch(
        "mace").config))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    dm = tmesh.make_device_mesh((2, 2), ("data", "model"), "cpu")
    got = {}
    # which expert-parallel path each MoE cell takes
    from repro_torch.models import moe as tmoe
    paths = dict.fromkeys(("_moe_fwd_sharded_dtensor",
                           "_moe_fwd_a2a_dtensor"), 0)
    for name in paths:
        def counted(*a, _f=getattr(tmoe, name), _n=name, **k):
            paths[_n] += 1
            return _f(*a, **k)
        setattr(tmoe, name, counted)
    for arch, cell in CASES:
        paths.update(dict.fromkeys(paths, 0))
        prog = common.program(arch, cell, dm)
        args = prog.shard_args(common.args(prog, arch, cell, weights))
        res = prog.fn(*args)
        for name, t in flatten_with_names(res):
            if isinstance(t, torch.Tensor):
                t = t.full_tensor() if hasattr(t, "full_tensor") else t
                got[f"{arch}/{cell}/{name}"] = t.detach().float().numpy()
        for name, n in paths.items():
            got[f"path/{arch}/{cell}/{name}"] = np.asarray(n)
    # the MACE energies' gradient by the positions, on the mesh and on
    # the same inputs gathered whole
    from repro_torch.models.layers import Axes
    from repro_torch.tree import tree_map
    prog = common.program("tiny-mace", "molecule", dm)
    state, batch = common.args(prog, "tiny-mace", "molecule", weights)
    # every edge's sender in the other dp shard: each shard's edges then
    # add to the gradient of positions that the other shard holds
    n = batch["species"].shape[0]
    batch = dict(batch, senders=(batch["senders"] + n // 2) % n)
    sstate, sbatch = prog.shard_args((state, batch))
    got["mace_forces/mesh"] = common.mace_forces(
        sstate.params, sbatch, 2, Axes(mesh=dm)).full_tensor().numpy()
    got["mace_forces/plain"] = common.mace_forces(
        tree_map(lambda t: t.detach(), state.params), batch, 2).numpy()
    # the MIND history bag on the row-split catalog
    mind = common.weights_model("tiny-mind", weights)
    hist, w = common.bag_inputs()
    table = common.distribute(mind.item_embed.detach(), P("model", None), dm)
    ids = common.distribute(hist, P("data", None), dm)
    wd = common.distribute(w, P("data", None), dm)
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        bag = rs.embedding_bag(table, ids, wd)
    got["bag"] = bag.full_tensor().numpy()
    assert tuple(bag.placements) == tuple(placements(P("data", None), dm))
    coord = dm.get_coordinate()
    got[f"coord{rank}"] = np.asarray(coord)
    from repro_torch.core.sharded_index import Mesh
    logical = Mesh((2, 2), ("data", "model"), device="cpu",
                   group=dist.group.WORLD)
    got[f"cell{rank}"] = np.asarray(list(logical.local_cells()))
    # MIND's rpf=1 retrieval: this rank's forest cell, the sharded step on
    # the interests the program computes, the whole cell, and the cell on
    # the reference's stacked forest
    from repro_torch.convert import forest_from_numpy
    prog = common.program("tiny-mind-4k", "retrieval_cand@rpf=1", dm)
    params, hist, forest = prog.shard_args(common.rpf_args(dm, weights))
    for name, t in forest._asdict().items():
        got[f"rpf/cell{rank}/{name}"] = t.to_local()[0, 0].numpy()
    got["rpf/cell/0"], got["rpf/cell/1"] = prog.fn(params, hist, forest)
    with implicit_replication(), torch.no_grad():
        interests = rs.mind_user_fwd(params, params.cfg, hist)
        got["rpf/interests"] = interests.full_tensor().reshape(4, 8)
        got["rpf/step/0"], got["rpf/step/1"] = common.rpf_step(dm)(
            forest, got["rpf/interests"], params.item_embed)
        live = common.distribute(common.rpf_live(), P("data"), dm)
        got["rpf/live/0"], got["rpf/live/1"] = common.rpf_step(
            dm, with_validity=True)(forest, got["rpf/interests"],
                                    params.item_embed, live)
    ref_forest = forest_from_numpy(common.wait_for(os.path.join(
        os.path.dirname(out_path), "rpf_forest.npz")), device="cpu")
    ref_forest = steps.shard_args(ref_forest, prog.placements[2], dm)
    got["rpf/on_ref/0"], got["rpf/on_ref/1"] = prog.fn(params, hist,
                                                       ref_forest)
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else v
           for k, v in got.items()}
    gathered = [None] * 4
    dist.all_gather_object(gathered, got if rank else None)
    if rank == 0:
        for g in gathered[1:]:
            got.update({k: v for k, v in g.items()
                        if k.startswith(("coord", "cell", "rpf/cell"))})
            # every rank gets the merged answer
            for k in ("rpf/cell/0", "rpf/cell/1", "rpf/step/0",
                      "rpf/step/1"):
                assert np.array_equal(g[k], got[k]), k
        np.savez(out_path, **got)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import repro_torch.launch.steps  # noqa: F401 -- imported once, forked
    weights = dict(np.load(sys.argv[1]))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(rank_main, args=(port, weights, sys.argv[2]),
                       nprocs=4, start_method="fork")
"""

# helpers both this process and the gloo ranks use (written next to the
# outputs, imported by the ranks)
COMMON = """
import numpy as np
import torch

from repro_torch import convert
from repro_torch.launch import steps
from repro_torch.models import mace as tmace
from repro_torch.tree import flatten_with_names


def nest(flat):
    out = {}
    for name, v in flat.items():
        node, parts = out, name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(out)


FAMILY = {"tiny-lm": "lm", "tiny-moe": "moe", "tiny-moe-a2a": "moe",
          "tiny-dlrm": "dlrm", "tiny-mind": "mind", "tiny-mace": "mace",
          "tiny-mind-4k": "mind4k"}


def weights_model(arch, weights):
    from repro_torch.configs import get_arch
    fam = FAMILY[arch]
    tree = nest({k[len(f"w/{fam}/"):]: v for k, v in weights.items()
                 if k.startswith(f"w/{fam}/")})
    cfg = get_arch(arch).config
    if fam in ("lm", "moe"):
        return convert.lm_from_numpy(tree, cfg, device="cpu")
    if fam == "mace":
        return convert.mace_from_numpy(tree, device="cpu")
    return convert.recsys_from_numpy(tree, cfg, device="cpu")


def program(arch, cell, mesh=None):
    # a cell may carry a variant: "train_4k@opt=adafactor"
    cell, _, variant = cell.partition("@")
    if mesh is None:
        return steps.build_cell(arch, cell, device="cpu",
                                variant=variant or "base")
    return steps.build_cell(arch, cell, mesh, variant=variant or "base")


def _load_into(model, converted):
    with torch.no_grad():
        for (_, p), (_, w) in zip(flatten_with_names(model),
                                  flatten_with_names(converted)):
            p.copy_(w)


def args(prog, arch, cell, weights):
    a = list(prog.make_args(torch.Generator().manual_seed(5)))
    model = a[0].params if hasattr(a[0], "params") else a[0]
    _load_into(model, weights_model(arch, weights))
    if cell in ("prefill_32k", "decode_32k"):   # an f32 cache: see the
        # module docstring
        from repro_torch.models.attention import KVCache
        a[1] = KVCache(a[1].k.float(), a[1].v.float())
    return tuple(a)


def rpf_args(mesh, weights):
    # the rpf=1 program's arguments on the loaded weights: the forest
    # built over their catalog (make_args would build it over the drawn
    # one), the history make_args draws at seed 5
    from repro_torch.configs import get_arch
    params = weights_model("tiny-mind-4k", weights)
    hist = steps.recsys_data(get_arch("tiny-mind-4k").config, 1, 5,
                             "cpu")["hist"]
    return params, hist, steps.build_catalog_index(params, mesh)


def rpf_step(mesh, with_validity=False):
    # the sharded step of the rpf=1 program on a 2 x 2 mesh
    from repro_torch.core.sharded_index import make_query_fn
    local = steps.MIND_FOREST._replace(n_trees=40)
    return make_query_fn(local, 2048, mesh, k=steps.K_RETRIEVE,
                         metric="l2", with_validity=with_validity)


def rpf_live():
    # a row bitmap over the 4,096 catalog rows, a third of them dead
    return torch.rand(4096, generator=torch.Generator().manual_seed(3)) > 0.3


def wait_for(path, timeout=240.0):
    # the reference's subprocess writes its forest while the ranks run
    import os
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(path)
        time.sleep(0.05)
    return dict(np.load(path))


def mace_forces(params, batch, dpn, axes=None):
    # d(sum_g (g + 1) * energy_g) / d positions of the tiny MACE's
    # molecule batch (laid out for dpn dp shards), through mace_fwd on
    # the mesh of axes (or on none)
    from repro_torch.configs import get_arch
    spec = get_arch("tiny-mace")
    cfg, sizes, _, _ = steps.gnn_cell_config(spec.config, spec.cells[0],
                                             "base", dpn)
    pos = batch["positions"].detach().requires_grad_(True)
    out = tmace.mace_fwd(
        params, cfg, batch["species"], pos, batch["senders"],
        batch["receivers"], edge_mask=batch["edge_mask"],
        graph_ids=batch["graph_ids"], n_graphs=sizes.n_graphs, axes=axes,
        n_edge_chunks=sizes.n_edge_chunks)
    energy = out["energy"]
    energy = energy.full_tensor() if hasattr(energy, "full_tensor") \
        else energy
    coef = torch.arange(1, sizes.n_graphs + 1, dtype=energy.dtype)
    return torch.autograd.grad((energy * coef).sum(), pos)[0]


def bag_inputs():
    g = torch.Generator().manual_seed(11)
    hist = torch.randint(-3, 20010, (8, 6), generator=g, dtype=torch.int32)
    return hist, torch.rand(8, 6, generator=g)


def distribute(t, spec, mesh):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.layers import placements
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _reference_weights() -> dict:
    """Every small model's weights from the reference's ``init_*``, flat
    by '/'-joined name under ``w/<family>/``."""
    import jax
    from repro import configs as jconfigs
    from repro.configs import base as jbase
    from repro.models import mace as jmace
    from repro.models import recsys as jrs
    from repro.models import transformer as jtr
    jmace._paths_and_cg(2)      # fill the CG cache before any trace
    ns = {}
    exec(ARCHS, ns)
    archs = ns["tiny_archs"](jbase, jconfigs.get_arch("mace").config)
    inits = {"lm": lambda k: jtr.init_lm(k, archs["tiny-lm"].config),
             "moe": lambda k: jtr.init_lm(k, archs["tiny-moe"].config),
             "dlrm": lambda k: jrs.init_dlrm(k, archs["tiny-dlrm"].config),
             "mind": lambda k: jrs.init_mind(k, archs["tiny-mind"].config),
             "mace": lambda k: jmace.init_mace(
                 k, archs["tiny-mace"].config, 0),
             "mind4k": lambda k: jrs.init_mind(
                 k, archs["tiny-mind-4k"].config)}
    out = {}
    key = jax.random.key(0)
    for i, (fam, init) in enumerate(inits.items()):
        tree = init(jax.random.fold_in(key, i))
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            out[f"w/{fam}/{name}"] = np.asarray(leaf)
    # the history the rpf=1 program's make_args draws at seed 5
    from repro_torch.data.recsys_data import BehaviorStream
    cfg = archs["tiny-mind-4k"].config
    out["rpf/hist"] = BehaviorStream(cfg.item_vocab, cfg.hist_len,
                                     seed=ns["SEED"]).batch(1)["hist"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's weights and outputs, the gloo ranks' outputs, the
    helpers module)."""
    d = tmp_path_factory.mktemp("sharded_cells")
    (d / "ref.py").write_text(REFERENCE)
    (d / "port.py").write_text(PORT)
    (d / "sharded_common.py").write_text(COMMON)
    weights = _reference_weights()
    np.savez(d / "weights.npz", **weights)
    port_env = dict(_env(), OMP_NUM_THREADS="1")
    port_env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(d / script), str(d / "weights.npz"),
         str(d / out)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for script, out, env in (("ref.py", "ref.npz", _env()),
                                 ("port.py", "port.npz", port_env))]
    try:
        # the reference first: the ranks wait for its rpf=1 forest
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    sys.path.insert(0, str(d))
    import sharded_common
    ref = dict(np.load(d / "ref.npz"))
    ref.update(weights)
    yield ref, dict(np.load(d / "port.npz")), sharded_common
    sys.path.remove(str(d))


@pytest.fixture(scope="module")
def registered():
    from repro_torch import configs
    from repro_torch.configs import base
    ns = {}
    exec(ARCHS, ns)
    archs = ns["tiny_archs"](base, configs.get_arch("mace").config)
    saved = dict(configs.REGISTRY)
    configs.REGISTRY.update(archs)
    yield archs
    configs.REGISTRY.clear()
    configs.REGISTRY.update(saved)


def _plain(common, weights, arch, cell):
    from repro_torch.tree import flatten_with_names
    prog = common.program(arch, cell)
    res = prog.fn(*common.args(prog, arch, cell, weights))
    return {f"{arch}/{cell}/{n}": t.detach().float().numpy()
            for n, t in flatten_with_names(res)
            if isinstance(t, torch.Tensor)}


CASES = [("tiny-lm", "train_4k", dict(rtol=1e-5, atol=1e-5)),
         ("tiny-lm", "train_4k@opt=adafactor", dict(rtol=1e-5, atol=1e-5)),
         ("tiny-lm", "prefill_32k", dict(rtol=1e-5, atol=1e-5)),
         ("tiny-moe", "decode_32k", dict(rtol=1e-5, atol=1e-5)),
         ("tiny-moe-a2a", "decode_32k", dict(rtol=1e-5, atol=1e-5)),
         ("tiny-dlrm", "serve_p99", dict(rtol=1e-5, atol=1e-6)),
         ("tiny-dlrm", "train_batch", dict(rtol=1e-5, atol=1e-6)),
         ("tiny-mind", "serve_p99", dict(rtol=1e-5, atol=1e-6)),
         ("tiny-mace", "molecule", dict(rtol=1e-5, atol=1e-6))]


@pytest.mark.parametrize("arch,cell,tol", CASES,
                         ids=[f"{a}/{c}" for a, c, _ in CASES])
def test_gloo_mesh_equals_unsharded(arch, cell, tol, runs, registered):
    ref, got, common = runs
    want = _plain(common, ref, arch, cell)
    assert want and set(want) <= set(got)
    for name, w in want.items():
        if name.endswith("/aux"):
            continue      # the MoE aux is a mean over cells (as the
            # reference's sharded paths define it)
        else:
            np.testing.assert_allclose(got[name], w, err_msg=name, **tol)


def test_gloo_moe_paths(runs):
    """The MoE decodes take the reference's expert-parallel paths: top-2
    ``moe_fwd_sharded``; top-1 under ``moe_a2a``, ``moe_fwd_a2a``."""
    _, got, _ = runs
    for arch, path in (("tiny-moe", "_moe_fwd_sharded_dtensor"),
                       ("tiny-moe-a2a", "_moe_fwd_a2a_dtensor")):
        taken = {k.rsplit("/", 1)[1]: int(v) for k, v in got.items()
                 if k.startswith(f"path/{arch}/decode_32k/")}
        assert taken[path] > 0 and sum(taken.values()) == taken[path], \
            (arch, taken)


def test_gloo_mace_forces_equal_unsharded(runs):
    """The gradient of the MACE energies by the positions on the (2, 2)
    mesh, each edge's sender in the other dp shard (a shard's edges add to
    the gradient of the other's positions), equals the one without a mesh
    on the same inputs."""
    _, got, _ = runs
    want = got["mace_forces/plain"]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got["mace_forces/mesh"], want, rtol=1e-5,
                               atol=1e-6)


def test_gloo_mind_bag_equals_unsharded(runs, registered):
    from repro_torch.models import recsys as rs
    ref, got, common = runs
    mind = common.weights_model("tiny-mind", ref)
    hist, w = common.bag_inputs()
    want = rs.embedding_bag(mind.item_embed.detach(), hist, w)
    np.testing.assert_allclose(got["bag"], want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_ranks_hold_the_row_major_cells(runs):
    """Rank r sits at the DeviceMesh's row-major coordinate r and holds
    cell r of a ``core.sharded_index.Mesh`` of the same shape over the
    same group (one rank a cell)."""
    _, got, _ = runs
    for r in range(4):
        assert tuple(got[f"coord{r}"]) == divmod(r, 2)
        assert list(got[f"cell{r}"]) == [r]


def _runs(d, ids):
    """The first entry of each run of equal ids (the rpf=1 merge keeps an
    item once per interest that found it, side by side)."""
    d, ids = np.asarray(d).ravel(), np.asarray(ids).ravel()
    first = np.ones(ids.shape, bool)
    first[1:] = ids[1:] != ids[:-1]
    return d[first], ids[first]


def _runs_agree(got, want, tol=dict(rtol=1e-5, atol=1e-6)):
    """The compare rule over runs of equal ids: distances (ascending)
    within ``tol``, ids equal at every run separated from its neighbours
    by more than the tolerance; returns the separated runs' count."""
    (gd, gi), (wd, wi) = _runs(*got), _runs(*want)
    assert len(gi) == len(wi)
    gd, wd = gd.astype(np.float64), wd.astype(np.float64)
    np.testing.assert_allclose(gd, wd, **tol)
    eps = tol["rtol"] * np.abs(wd) + tol["atol"]
    gap = wd[1:] - wd[:-1]
    sep = np.ones_like(wd, dtype=bool)
    sep[1:] &= gap > eps[1:] + eps[:-1]
    sep[:-1] &= gap > eps[:-1] + eps[1:]
    np.testing.assert_array_equal(gi[sep], wi[sep])
    return int(sep.sum())


@pytest.fixture(scope="module")
def rpf_logical(runs, registered):
    """The rpf=1 retrieval on a logical (2, 2) ``Mesh`` in this process on
    the same weights: (args, program, answer)."""
    from repro_torch.core.sharded_index import Mesh
    from repro_torch.launch import steps
    ref, _, common = runs
    mesh = Mesh((2, 2), device="cpu")
    args = common.rpf_args(mesh, ref)
    prog = steps.build_cell("tiny-mind-4k", "retrieval_cand", mesh,
                            variant="rpf=1")
    return args, prog, prog.fn(*args)


def test_gloo_rpf_cells_are_the_logical_cells(runs, rpf_logical):
    """Each gloo rank built its own forest cell from its own catalog rows,
    bit for bit cell r of the logical (2, 2) mesh's build."""
    _, got, _ = runs
    (_, _, forest), _, _ = rpf_logical
    assert [c for c, _ in forest.cells] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r, (_, cell) in enumerate(forest.cells):
        assert cell.thresh.shape[0] == 40        # 80 trees over 2 shards
        for name, t in cell._asdict().items():
            np.testing.assert_array_equal(got[f"rpf/cell{r}/{name}"],
                                          t.numpy(), err_msg=name)


@pytest.mark.parametrize("validity", [False, True])
def test_gloo_rpf_step_is_the_logical_step(validity, runs, rpf_logical):
    """The DeviceMesh step on the interests the ranks computed is bit for
    bit the logical mesh's step on them: each rank reranked its own rows
    (and its own slice of a row-split validity bitmap) and the lists were
    merged in cell order."""
    _, got, common = runs
    (params, _, forest), _, _ = rpf_logical
    from repro_torch.core.sharded_index import Mesh
    step = common.rpf_step(Mesh((2, 2), device="cpu"), validity)
    q = torch.from_numpy(got["rpf/interests"])
    with torch.no_grad():
        d, i = (step(forest, q, params.item_embed, common.rpf_live())
                if validity else step(forest, q, params.item_embed))
    assert int((i >= 0).sum()) > 100
    name = "rpf/live" if validity else "rpf/step"
    if validity:
        assert common.rpf_live()[i[i >= 0].long()].all()
        assert not np.array_equal(got["rpf/step/1"], i.numpy())
    np.testing.assert_array_equal(got[f"{name}/1"], i.numpy())
    np.testing.assert_array_equal(got[f"{name}/0"], d.numpy())


def test_gloo_rpf_cell_equals_logical_program(runs, rpf_logical):
    """The rpf=1 cell on the (2, 2) DeviceMesh against the logical mesh's
    program, by the compare rule over runs of equal ids (the interests on
    four ranks may differ from the unsharded ones in the last bits)."""
    _, got, _ = runs
    _, _, want = rpf_logical
    assert got["rpf/cell/1"].shape == (1, 100)
    assert _runs_agree((got["rpf/cell/0"], got["rpf/cell/1"]),
                       (want[0].numpy(), want[1].numpy())) > 10


def test_gloo_rpf_cell_equals_reference_sharded(runs):
    """The gloo ranks' rpf=1 cell on the reference's stacked forest
    against the reference's program on its (2, 2) mesh."""
    ref, got, _ = runs
    assert _runs_agree((got["rpf/on_ref/0"], got["rpf/on_ref/1"]),
                       (ref["ref/rpf/d"], ref["ref/rpf/i"])) > 10


def test_fake_group_dry_run_rpf(registered):
    """The rpf=1 cell on a fake (4, 2) mesh: rank 0 holds its shards (a
    512-row catalog shard, one cell of 40 trees) and the merge's one
    all-gather of distances and one of ids, (4, 8 x 100) 4-byte arrays,
    is counted."""
    import torch.distributed as dist
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.layers import placements
    from repro_torch.tree import leaves
    card = dryrun.run_cell("tiny-mind-4k", "retrieval_cand", "rpf=1",
                           save=False)
    try:
        dm = tmesh.make_fake_mesh((4, 2), ("data", "model"))
        rec = dryrun.run_cell("tiny-mind-4k", "retrieval_cand", "rpf=1",
                              save=False, mesh="single", device_mesh=dm)
        prog = steps.build_cell("tiny-mind-4k", "retrieval_cand", dm,
                                variant="rpf=1")
        want, shards = 0, []
        for s, spec in zip(leaves(prog.args), leaves(prog.placements)):
            shape, _ = compute_local_shape_and_global_offset(
                s.shape, dm, placements(spec, dm))
            shards.append(tuple(shape))
            want += math.prod(shape) * s.dtype.itemsize
    finally:
        dist.destroy_process_group()
    assert (1024, 8) in shards           # the catalog's 4,096 rows over 4
    assert (1, 1, 40, 1024) in shards    # the rank's perm: its cell
    assert rec["n_devices"] == 8
    assert rec["memory"]["argument_bytes"] == want
    assert want < card["memory"]["argument_bytes"]
    coll = rec["collectives"]
    assert coll["counts"]["all-gather"] == 2
    assert coll["bytes"]["all-gather"] == 2 * 4 * 8 * 100 * 4
    # the history's rows summed over the catalog's row shards
    assert coll["counts"]["all-reduce"] == 1
    assert coll["bytes"]["all-reduce"] == 1 * 6 * 8 * 4


def _bad_mesh(kind):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import mesh as tmesh
    if kind == "subset":            # 4 of the group's 8 ranks
        tmesh.make_fake_mesh((4, 2))
        return DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
    tmesh.make_fake_mesh((2, 2))
    if kind == "permuted":          # ranks in column-major order
        return DeviceMesh("cpu", torch.tensor([[0, 2], [1, 3]]),
                          mesh_dim_names=("data", "model"))
    return DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("model", "data"))


@pytest.mark.parametrize("kind,match", [
    ("subset", "does not span the default process group"),
    ("permuted", "does not span the default process group"),
    ("dims", "dimensions must be db_axes")])
def test_sharded_index_refuses_a_device_mesh_off_the_group(kind, match):
    """The DeviceMesh step gathers the cells' lists over the default
    group in rank order: a mesh that does not span that group in
    row-major order, or orders its dimensions otherwise, is refused by
    both the build and the step."""
    import torch.distributed as dist
    from repro_torch.core.forest import ForestConfig
    from repro_torch.core.sharded_index import (build_sharded_index,
                                                make_query_fn)
    cfg = ForestConfig(n_trees=4, capacity=8)
    try:
        mesh = _bad_mesh(kind)
        with pytest.raises(ValueError, match=match):
            build_sharded_index(0, torch.zeros(64, 4), cfg, mesh)
        with pytest.raises(ValueError, match=match):
            make_query_fn(cfg, 32, mesh)
    finally:
        dist.destroy_process_group()


def test_dense_lm_equals_reference_sharded(runs, registered):
    """The gloo ranks' dense LM against the reference's jitted program
    with its ``in_shardings`` on 4 host devices."""
    ref, got, _ = runs
    np.testing.assert_allclose(got["tiny-lm/train_4k/1/loss"],
                               ref["ref/train/loss"], rtol=1e-5)
    names = sorted(k for k in ref if k.startswith("ref/train/params/"))
    assert names
    for k in names:
        mine = "tiny-lm/train_4k/0/params/" + k[len("ref/train/params/"):]
        np.testing.assert_allclose(got[mine], ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["tiny-lm/prefill_32k/0"],
                               ref["ref/prefill/logits"], rtol=1e-5,
                               atol=1e-5)


def test_fake_group_dry_run_per_rank(registered):
    """The dense LM's train cell on a fake (4, 2) mesh: rank 0's record."""
    import torch.distributed as dist
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch import roofline
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.layers import placements
    from repro_torch.tree import leaves
    card = dryrun.run_cell("tiny-lm", "train_4k", save=False)
    try:
        dm = tmesh.make_fake_mesh((4, 2), ("data", "model"))
        rec = dryrun.run_cell("tiny-lm", "train_4k", save=False,
                              mesh="single", device_mesh=dm)
        prog = steps.build_cell("tiny-lm", "train_4k", dm)
        want = 0
        for s, spec in zip(leaves(prog.args), leaves(prog.placements)):
            shape, _ = compute_local_shape_and_global_offset(
                s.shape, dm, placements(spec, dm))
            want += math.prod(shape) * s.dtype.itemsize
    finally:
        dist.destroy_process_group()
    assert rec["n_devices"] == 8 and rec["mesh"] == "single"
    assert rec["memory"]["argument_bytes"] == want
    assert want < card["memory"]["argument_bytes"]
    # the activations and the gradients on top of the arguments
    assert rec["memory"]["peak_bytes"] > want
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    ratio = rec["cost"]["flops"] / card["cost"]["flops"]
    assert 1 / 8 <= ratio <= 1 / 8 * 1.25, ratio
    t, t1 = roofline.roofline_terms(rec), roofline.roofline_terms(card)
    assert t["ideal_s"] == pytest.approx(t1["ideal_s"] / 8)
    # eight cards are one node: NVLink
    assert t["collective_s"] == pytest.approx(
        rec["collectives"]["total_bytes"] / roofline.NVLINK_BW)
    assert roofline.roofline_terms(dict(rec, n_devices=256))[
        "collective_s"] == pytest.approx(
        rec["collectives"]["total_bytes"] / roofline.INTERNODE_BW)


def test_rank_counter_live_peak():
    """``RankCounter``'s live bytes by hand on ``meta``: a chain's peak is
    the input, the product and the tanh at once; a tensor autograd saves
    stays live after its Python object is gone, until the graph goes."""
    from repro_torch.launch.dryrun import RankCounter
    act = 64 * 1024 * 4
    w = torch.empty(1024, 1024, device="meta")
    with torch.no_grad(), RankCounter() as c:
        h = torch.empty(64, 1024, device="meta")
        for _ in range(4):
            h = torch.tanh(h @ w)
        assert c.live == act
    assert c.peak == 3 * act
    w.requires_grad_(True)
    with RankCounter() as c:
        y = torch.tanh(torch.empty(64, 1024, device="meta") @ w)
        z = y.sum()
        del y     # the product's backward holds its input, tanh's its output
        assert c.live == 2 * act + 4
        del z
        assert c.live == 0
