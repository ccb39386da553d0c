"""Cell programs (port of ``repro/launch/steps.py``): (arch x shape-cell x
mesh) -> a step function, its arguments' shapes, and a way to make them.

For every LM train, prefill and decode cell (dense and MoE), every recsys
train, serve and retrieval cell and every MACE train cell this builds a
``CellProgram``:
  * ``fn``, the step: serve and retrieval run under ``torch.no_grad``;
    train (``fn(state, batch) -> (state, {"loss"})``) takes one AdamW
    step (``adamw(constant_schedule(1e-3))``) on the reference's BCE with
    logits, writing the ``TrainState``'s tensors in place;
  * ``args``, ``ShapeDtype`` stand-ins for every input, leaf for leaf the
    reference's ``ShapeDtypeStruct``s (the parameters' shapes are read on
    the ``meta`` device, so nothing is allocated; a train cell's state is
    ``TrainState(step, params, AdamState(step, m, v), None)``);
  * ``meta``, model flops and parameter counts (``_recsys_meta``; a train
    cell counts three times the forward's flops);
  * ``make_args(generator)``, real arguments on the mesh's device: the
    model's init drawn from ``generator`` (on that device) and, for a train
    cell, its state, batches from the data streams seeded with
    ``generator.initial_seed()`` (with labels for a train cell; seeded
    uniform ids for a MIND batch over ``STREAM_MAX_BATCH`` users, where
    ``BehaviorStream``'s loop over users would take seconds), candidate
    ids ``arange(n)``, and for ``rpf=1`` the catalog's forest
    (``build_catalog_index``);
  * ``meta_args()``, arguments that ``fn`` accepts on the ``meta`` device
    and that draw no data: the model built there (no storage), a train
    cell's ``TrainState`` with ``make_args``' leaves and ``requires_grad``,
    the batch (and an LM's cache and ``pos``, an ``rpf=1`` retrieval's
    forest) empty tensors of ``args``' shapes and dtypes.
    ``launch/dryrun.py`` runs ``fn`` on them to count its FLOPs and bytes.

The LM cells (``models/transformer``): train takes one step of the
reference's optimizer (AdamW at ``constant_schedule(1e-4)``, its moments
bf16 for bf16 parameters, or Adafactor under ``opt=adafactor``) on
``loss_fn`` (the chunked CE, chunks of 512, where the padded vocabulary
holds 100,000 or more), its batch ``MarkovTokens`` (B, S) tokens and next
tokens; prefill (``fn(params, cache, tokens) -> (logits, cache)``) runs
``decode_step`` at position 0 with ``last_only``; decode (``fn(params,
cache, tokens, pos)``) one token a sequence.  Both take a bf16 cache
whatever the compute dtype, write it in place and return it; decode's
``make_args`` fills it with seeded normal values and sets ``pos`` to its
last slot, so a step reads the whole cache.  The MoE configurations
(granite-moe-1b, llama4-maverick-400b) build the same programs; with no
mesh passed to the model their MoE layers run the local ``moe_fwd``.

The MACE cells (``models/mace``) take one step of AdamW at
``constant_schedule(1e-3)`` on the node CE over labels >= 0 or the energy
MSE, at the reference's padded sizes (``_gnn_sizes``: ``n_nodes``,
``n_edges``, ``n_edge_chunks``), on a batch from ``gnn_batch``:
``batched_molecules``, ``random_graph`` or a ``NeighborSampler`` sample,
its edges sorted by receiver shard and padded per shard with masked
self-loops.

Every program also carries ``placements``, the reference's
``in_shardings`` without their mesh: a tree of specs (``models/layers.P``)
leaf for leaf over ``args``, built from the models' ``*_specs`` as the
reference builds them (``lm_param_specs``, ``cache_specs``,
``_recsys_specs``, the Adafactor factors' ``_vr`` / ``_vc``, the batch
split over dp).  The mesh is either

* the port's logical ``core.sharded_index.Mesh`` (``Mesh((1, 1))`` on the
  device by default): the programs run on plain tensors as they always
  did; the ``rpf=1`` retrieval runs cells on it, and the MACE cells'
  message passing runs ``mace_fwd``'s mesh path over its dp axes, as the
  reference's ``_gnn_program`` always passes its mesh; or
* a ``DeviceMesh`` with the reference's axis names (``launch/mesh``):
  ``shard_args(args, placements, mesh)`` (``prog.shard_args(args)``)
  turns ``make_args``' or ``meta_args``' tensors into DTensors split as
  the placements say, this rank keeping its shard, and ``fn`` runs on
  them: the models constrain activations where the reference does, the
  LM cells pass the mesh so their MoE blocks take the expert-parallel
  paths, the tables gather vocab-parallel, MACE passes messages over the
  mesh's dp group, and the ``rpf=1`` retrieval takes the reference's
  stacked forest under ``P(dp, "model")``, built rank by rank (each rank
  its own cell) by ``make_args``, and runs the sharded query step of
  ``core.sharded_index`` on it.  Tensors a program makes itself
  (positions, masks, constants) are replicated (``implicit_replication``);
  an op with no DTensor rule raises.

``variant`` is "base" or comma-separated keys.  LM cells take the
reference's keys (``_apply_lm_variant``: ``nl=N`` cuts the depth,
``attn=blockwise`` streams attention over KV blocks, ``remat``, ``opt``,
...) and, for one card, ``batch=N``, the cell's batch cut to N.  Recsys
cells: ``rpf=1`` serves MIND's ``retrieval_cand`` through the paper's index
(the reference's); for one card, ``rows=N`` caps every table at N rows
(DLRM-MLPerf's 187.8M rows are 96 GB of f32) and ``cand=N`` scores N
candidates in a CTR model's retrieval instead of 1,048,576.  MACE cells:
the reference's ``ex=bf16|f32`` and ``unroll=1``; for one card,
``nodes=N`` (``ogb_products``: N nodes, the edges by the same ratio)
and ``graph_edges=N`` (``minibatch_lg``: the host graph the sampler draws
from holds N edges; the sample's padded shapes are the reference's).  An
unknown key raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import (ArchSpec, LMConfig, MACEConfig,
                                      RecsysConfig, ShapeCell)
from repro_torch.configs.mace_arch import N_CLASSES
from repro_torch.core.forest import Forest, ForestConfig
from repro_torch.core.sharded_index import (CellDraws, Mesh, ShardedForest,
                                            build_sharded_index,
                                            make_query_fn, merge_topk_pairs)
from repro_torch.data.graph_data import (NeighborSampler, batched_molecules,
                                         random_graph, sort_edges_for_mesh,
                                         to_csr)
from repro_torch.data.lm_data import MarkovTokens
from repro_torch.data.recsys_data import BehaviorStream, CTRStream
from repro_torch.kernels.common import topk_smallest
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import mace as mace_mod
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (Axes, P, constrain, is_device_mesh,
                                       is_dtensor, mesh_sizes, placements,
                                       upcast)
from repro_torch.train.optimizer import (AdamState, FactorState, adafactor,
                                         adamw, constant_schedule)
from repro_torch.train.train_state import (TrainState, init_train_state,
                                           make_train_step)
from repro_torch.tree import (children, flatten_with_names, leaves,
                              tree_map)

K_RETRIEVE = 100
# 1M candidates padded to 2^20 (the reference shards them over 256 and 512
# chips)
N_CAND = 1_048_576
# the paper's index over MIND's catalog (the reference's rpf=1 program)
MIND_FOREST = ForestConfig(n_trees=80, capacity=16, split_ratio=0.3)
# the largest MIND batch drawn from BehaviorStream
STREAM_MAX_BATCH = 65_536


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """An input's shape and dtype (the reference's ``ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


class CellProgram(NamedTuple):
    fn: Callable
    args: tuple                # ShapeDtype trees, the reference's layout
    meta: dict                 # model_flops etc.
    make_args: Callable        # (generator) -> real args on the device
    meta_args: Callable        # () -> args on "meta", no data drawn
    placements: tuple          # spec trees over args (in_shardings' specs)
    mesh: object = None        # the mesh the program was built on

    def shard_args(self, args, mesh=None):
        """``args`` as DTensors on ``mesh`` (the program's DeviceMesh by
        default), split as ``placements`` say."""
        return shard_args(args, self.placements,
                          self.mesh if mesh is None else mesh)


def _shard_leaf(t: torch.Tensor, spec: P, mesh):
    from torch.distributed.tensor import distribute_tensor
    pl = placements(spec, mesh)
    if is_dtensor(t):
        return t.redistribute(mesh, pl)
    out = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
    return out.requires_grad_(t.requires_grad)


def shard_args(args, specs, mesh):
    """The tree ``args`` with each tensor a DTensor on the ``DeviceMesh``
    ``mesh``, placed as its spec in ``specs`` (a tree of ``P`` over
    ``args``) says; every rank passes the whole tensors and keeps its
    shard.  A model's parameters are replaced in place (the model is
    returned); ``None`` stays ``None``."""
    from torch import nn
    if args is None:
        return None
    if isinstance(args, nn.Module):
        named = dict(flatten_with_names(specs))
        for name, p in list(args.named_parameters()):
            owner = args
            *path, leaf = name.split(".")
            for part in path:
                owner = getattr(owner, part)
            sharded = _shard_leaf(p.data, named[name.replace(".", "/")],
                                  mesh)
            setattr(owner, leaf, nn.Parameter(sharded, p.requires_grad))
        return args
    if isinstance(args, torch.Tensor):
        return _shard_leaf(args, specs, mesh)
    kids = children(args)
    if kids is None:
        raise TypeError(f"no placement for a {type(args).__name__}")
    spec_kids = dict(children(specs))
    built = [shard_args(c, spec_kids[k], mesh) for k, c in kids]
    if isinstance(args, dict):
        return dict(zip([k for k, _ in kids], built))
    if hasattr(args, "_fields"):
        return type(args)(*built)
    return type(args)(built)


def _on_mesh(fn: Callable, mesh) -> Callable:
    """``fn`` as it runs on ``mesh``: on a DeviceMesh the tensors the
    program makes itself count as replicated."""
    if not is_device_mesh(mesh):
        return fn

    def run(*args):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return fn(*args)
    return run


def _device_of(mesh) -> torch.device:
    """Where a program on ``mesh`` makes its arguments."""
    if is_device_mesh(mesh):
        return torch.device(mesh.device_type)
    return mesh.device


def _axes(mesh, multi_pod: bool) -> Axes:
    return Axes(dp=dp_axes(multi_pod), tp="model", mesh=mesh)


def _model_axes(mesh, multi_pod: bool) -> Optional[Axes]:
    """The axes an LM program hands its model: with the mesh on a
    DeviceMesh, none on the logical mesh (one card runs ``moe_fwd``)."""
    return _axes(mesh, multi_pod) if is_device_mesh(mesh) else None


def _sds(tree):
    """tensor tree -> ShapeDtype tree."""
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), tree)


def _empty(tree):
    """ShapeDtype tree -> empty tensors on the ``meta`` device."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _dp_size(mesh, dp: tuple[str, ...]) -> int:
    out = 1
    for a in dp:
        out *= mesh_sizes(mesh)[a]
    return out


def _adam_specs(pspecs):
    return AdamState(P(), pspecs, pspecs)


def _factor_specs(pspecs):
    """Adafactor's factored moments: vr drops the last param axis, vc the
    second-to-last; their specs follow the params' accordingly."""
    def _vr(s_):
        return P(*s_[:-1]) if len(s_) >= 2 else s_

    def _vc(s_):
        return P(*(s_[:-2] + s_[-1:])) if len(s_) >= 2 else P(None)

    return FactorState(P(), tree_map(_vr, pspecs), tree_map(_vc, pspecs))


# ===========================================================================
# LM cells
# ===========================================================================


def _lm_init(cfg: LMConfig):
    """``init(generator=None, device="meta")`` -> the model."""
    return lambda generator=None, device="meta": tr.init_lm(generator, cfg,
                                                            device)


def lm_tokens(cfg: LMConfig, b: int, s: int, seed: int, device) -> dict:
    """A ``MarkovTokens(cfg.vocab_size, seed=seed)`` batch of ``b``
    sequences of ``s`` tokens and their next tokens, on ``device``."""
    tok = MarkovTokens(cfg.vocab_size, seed=seed).sample(b, s)
    return {"tokens": torch.from_numpy(tok[:, :-1]).to(device),
            "labels": torch.from_numpy(tok[:, 1:]).to(device)}


def _logit_chunk(cfg: LMConfig) -> int:
    """The train program's CE chunk: 512 where the padded vocabulary holds
    100,000 or more (gemma3's 262,144, stablelm's 100,352), else 0 (the
    dense CE)."""
    return 512 if cfg.padded_vocab >= 100_000 else 0


def _lm_optimizer(cfg: LMConfig):
    if cfg.opt == "adafactor":
        return adafactor(constant_schedule(1e-4))
    state_dtype = (torch.bfloat16 if cfg.param_dtype == "bfloat16"
                   else torch.float32)
    return adamw(constant_schedule(1e-4), state_dtype=state_dtype)


def _lm_train_program(spec: ArchSpec, cell: ShapeCell, mesh: Mesh,
                      multi_pod: bool, b: int) -> CellProgram:
    cfg: LMConfig = spec.config
    opt = _lm_optimizer(cfg)
    logit_chunk = _logit_chunk(cfg)
    params_meta = _lm_init(cfg)()
    state_sds = _sds(TrainState(torch.zeros((), dtype=torch.int32,
                                            device="meta"),
                                params_meta, opt.init(params_meta), None))
    s = cell.seq_len
    batch_sds = {"tokens": ShapeDtype((b, s), torch.int32),
                 "labels": ShapeDtype((b, s), torch.int32)}
    model_axes = _model_axes(mesh, multi_pod)
    step = make_train_step(
        lambda p, b_: tr.loss_fn(p, b_, cfg, model_axes,
                                 logit_chunk=logit_chunk), opt)

    def train_step(state: TrainState, batch):
        state, metrics = step(state, batch)
        return state, {k: v.detach() for k, v in metrics.items()}

    def make_args(generator: torch.Generator):
        model = _lm_init(cfg)(generator, _device_of(mesh))
        return (init_train_state(model, opt),
                lm_tokens(cfg, b, s, generator.initial_seed(),
                          _device_of(mesh)))

    axes = _axes(mesh, multi_pod)
    pspecs = tr.lm_param_specs(cfg, axes)
    opt_specs = (_factor_specs(pspecs) if cfg.opt == "adafactor"
                 else _adam_specs(pspecs))
    dp = tuple(axes.dp)
    return CellProgram(
        fn=_on_mesh(train_step, mesh),
        args=(state_sds, batch_sds),
        meta=_lm_meta(cfg, cell, n_tokens=b * s, kind="train"),
        make_args=make_args,
        meta_args=lambda: (init_train_state(_lm_init(cfg)(), opt),
                           _empty(batch_sds)),
        placements=(TrainState(P(), pspecs, opt_specs, None),
                    {"tokens": P(dp, None), "labels": P(dp, None)}),
        mesh=mesh,
    )


def _lm_prefill_program(spec: ArchSpec, cell: ShapeCell, mesh: Mesh,
                        multi_pod: bool, b: int) -> CellProgram:
    cfg: LMConfig = spec.config
    s = cell.seq_len
    params_sds = _sds(_lm_init(cfg)())
    cache_sds = _sds(tr.init_cache(cfg, b, s, torch.bfloat16, "meta"))
    tok_sds = ShapeDtype((b, s), torch.int32)

    model_axes = _model_axes(mesh, multi_pod)

    @torch.no_grad()
    def prefill(params, cache, tokens):
        return tr.decode_step(params, cache, tokens, 0, cfg, axes=model_axes,
                              last_only=True)

    def make_args(generator: torch.Generator):
        return (_lm_init(cfg)(generator, _device_of(mesh)),
                tr.init_cache(cfg, b, s, torch.bfloat16, _device_of(mesh)),
                lm_tokens(cfg, b, s, generator.initial_seed(),
                          _device_of(mesh))["tokens"])

    pspecs, cspecs, bspec = _lm_serve_specs(cfg, mesh, multi_pod, b)
    return CellProgram(
        fn=_on_mesh(prefill, mesh),
        args=(params_sds, cache_sds, tok_sds),
        meta=_lm_meta(cfg, cell, n_tokens=b * s, kind="prefill"),
        make_args=make_args,
        meta_args=lambda: (_lm_init(cfg)(), _empty(cache_sds),
                           _empty(tok_sds)),
        placements=(pspecs, cspecs, P(bspec, None)),
        mesh=mesh,
    )


def _lm_decode_program(spec: ArchSpec, cell: ShapeCell, mesh: Mesh,
                       multi_pod: bool, b: int) -> CellProgram:
    cfg: LMConfig = spec.config
    s_max = cell.seq_len
    params_sds = _sds(_lm_init(cfg)())
    cache_sds = _sds(tr.init_cache(cfg, b, s_max, torch.bfloat16, "meta"))
    tok_sds = ShapeDtype((b, 1), torch.int32)
    pos_sds = ShapeDtype((), torch.int32)

    model_axes = _model_axes(mesh, multi_pod)

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        return tr.decode_step(params, cache, tokens, pos, cfg,
                              axes=model_axes)

    def make_args(generator: torch.Generator):
        dev = _device_of(mesh)
        cache = tr.init_cache(cfg, b, s_max, torch.bfloat16, dev)
        for t in cache:
            t.normal_(generator=generator)
        return (_lm_init(cfg)(generator, dev), cache,
                lm_tokens(cfg, b, 1, generator.initial_seed(),
                          dev)["tokens"],
                torch.tensor(s_max - 1, dtype=torch.int32, device=dev))

    pspecs, cspecs, bspec = _lm_serve_specs(cfg, mesh, multi_pod, b)
    return CellProgram(
        fn=_on_mesh(decode, mesh),
        args=(params_sds, cache_sds, tok_sds, pos_sds),
        meta=_lm_meta(cfg, cell, n_tokens=b, kind="decode"),
        make_args=make_args,
        meta_args=lambda: (_lm_init(cfg)(), _empty(cache_sds),
                           _empty(tok_sds), _empty(pos_sds)),
        placements=(pspecs, cspecs, P(bspec, None), P()),
        mesh=mesh,
    )


def _lm_serve_specs(cfg: LMConfig, mesh, multi_pod: bool, b: int):
    """(param specs, cache specs, the batch's dp entry) of a prefill or
    decode program: the cache split over the batch where it divides dp,
    and over its sequence on tp."""
    axes = _axes(mesh, multi_pod)
    dp_ok = b % _dp_size(mesh, axes.dp) == 0
    bspec = tuple(axes.dp) if dp_ok else None
    cspec = P(None, bspec, axes.tp, None, None)
    return tr.lm_param_specs(cfg, axes), tr.KVCache(cspec, cspec), bspec


def _lm_meta(cfg: LMConfig, cell: ShapeCell, n_tokens: int, kind: str) -> dict:
    n_total = cfg.param_count()
    # active params per token (MoE: top_k routed + shared of the MoE layers)
    if cfg.moe:
        expert_p = 3 * cfg.d_model * cfg.d_ff
        n_moe = cfg.n_layers // cfg.moe_every
        routed_total = n_moe * cfg.n_experts * expert_p
        active = n_total - routed_total + n_moe * cfg.top_k * expert_p
    else:
        active = n_total
    flops_per_token = {"train": 6, "prefill": 2, "decode": 2}[kind] * active
    # attention flops (dominant for long context): 2*2*L*S*d_attn per token
    s = cell.seq_len
    attn = 0
    win = cfg.layer_windows
    for w in win:
        eff = min(w, s) if w else s
        per_tok_ctx = eff / 2 if kind != "decode" else eff
        attn += (12 if kind == "train" else 4) * \
            cfg.n_heads * cfg.head_dim * per_tok_ctx
    return {
        "params_total": n_total,
        "params_active": active,
        "n_tokens": n_tokens,
        "model_flops": n_tokens * (flops_per_token + attn),
        "kind": kind,
    }


def _apply_lm_variant(cfg: LMConfig, variant: str) -> LMConfig:
    """Perf-iteration variants (the reference's keys)."""
    if variant == "base":
        return cfg
    changes = {}
    for item in variant.split(","):
        k, _, v = item.partition("=")
        if k == "attn_shard":
            changes["attn_shard"] = v
        elif k == "remat":
            changes["remat"] = v == "1"
        elif k == "fsdp":
            changes["fsdp"] = v == "1"
        elif k == "cap":
            changes["capacity_factor"] = float(v)
        elif k == "unroll":
            changes["unroll"] = v == "1"
        elif k == "attn":
            changes["attn_impl"] = v
        elif k == "kvblock":
            changes["kv_block"] = int(v)
        elif k == "nl":
            changes["n_layers"] = int(v)   # depth-extrapolation calibration
        elif k == "efsdp":
            changes["expert_fsdp"] = int(v)
        elif k == "opt":
            changes["opt"] = v
        elif k == "gq":
            changes["moe_gather_quant"] = v == "1"
        elif k == "a2a":
            changes["moe_a2a"] = v == "1"
        else:
            raise ValueError(f"unknown variant key {k}")
    return dataclasses.replace(cfg, **changes)


def _lm_batch_variant(variant: str) -> tuple[str, Optional[int]]:
    """(the variant without its port-only ``batch=N`` key, N or None)."""
    keep, batch = [], None
    for item in (variant.split(",") if variant != "base" else []):
        key, _, val = item.partition("=")
        if key == "batch":
            batch = int(val)
        else:
            keep.append(item)
    return ",".join(keep) or "base", batch


# ===========================================================================
# GNN (MACE) cells
# ===========================================================================


class GraphSizes(NamedTuple):
    """A gnn cell's shapes: the reference's padded ``n_nodes`` /
    ``n_edges`` and ``n_edge_chunks``, and the graph they hold."""

    n_nodes: int
    n_edges: int
    n_edge_chunks: int
    n_graphs: int
    d_feat: int
    raw_nodes: int      # the generated graph's nodes (the sample's at most)
    raw_edges: int


def _gnn_sizes(cell: ShapeCell, dpn: int,
               nodes: Optional[int] = None) -> GraphSizes:
    """The reference's sizes (``_gnn_program``); ``nodes=N`` cuts
    ``ogb_products`` to N nodes and its edges by the same ratio."""
    if cell.name == "molecule":
        raw_nodes = n_nodes = cell.n_nodes * cell.n_graphs        # 3840
        raw_edges = cell.n_edges * cell.n_graphs                  # 8192
        n_graphs, d_feat = cell.n_graphs, 0
    elif cell.name == "minibatch_lg":
        # padded fanout-sample sizes: seeds + seeds*15 + seeds*150
        raw_nodes = cell.batch_nodes * (1 + 15 + 150)
        n_nodes = _pad_to(raw_nodes, 32)
        raw_edges = cell.batch_nodes * (15 + 150)
        n_graphs, d_feat = 1, cell.d_feat
    else:
        raw_nodes = nodes or cell.n_nodes
        n_nodes = _pad_to(raw_nodes, 32)
        raw_edges = (cell.n_edges if nodes is None
                     else cell.n_edges * nodes // cell.n_nodes)
        n_graphs, d_feat = 1, cell.d_feat
    # stream big edge sets in rematerialized chunks (<= ~512k edges/device
    # live at once); pad the edge count so chunks shard evenly
    n_edge_chunks = max(1, -(-raw_edges // (262144 * dpn)))
    n_edges = _pad_to(raw_edges, n_edge_chunks * 512)
    return GraphSizes(n_nodes, n_edges, n_edge_chunks, n_graphs, d_feat,
                      raw_nodes, raw_edges)


def _gnn_variant(cfg: MACEConfig, cell: ShapeCell, variant: str
                 ) -> tuple[MACEConfig, Optional[int], Optional[int]]:
    """(config, nodes, graph_edges) of a gnn ``variant``: the reference's
    ``ex=bf16|f32`` and ``unroll=1``, and for one card ``nodes=N``
    (``ogb_products`` cut to N nodes) and ``graph_edges=N``
    (``minibatch_lg``'s host graph cut to N edges)."""
    nodes = graph_edges = None
    for item in (variant.split(",") if variant != "base" else []):
        k, _, v = item.partition("=")
        if k == "ex":
            cfg = dataclasses.replace(
                cfg, exchange_dtype={"bf16": "bfloat16",
                                     "f32": "float32"}[v])
        elif k == "nodes" and cell.name == "ogb_products":
            nodes = int(v)
        elif k == "graph_edges" and cell.name == "minibatch_lg":
            graph_edges = int(v)
        elif k != "unroll":
            raise ValueError(f"unknown gnn variant key {k} for {cell.name}")
    return cfg, nodes, graph_edges


def gnn_batch(cell: ShapeCell, sizes: GraphSizes, cfg: MACEConfig,
              n_classes: int, seed: int, dpn: int,
              graph_edges: Optional[int] = None) -> dict:
    """The cell's batch as numpy arrays, every stream seeded from ``seed``.

    ``molecule``: ``batched_molecules`` and N(0, 1) energies.  The full
    graphs: ``random_graph`` at the cell's nodes and edges, labels uniform
    over its classes.  ``minibatch_lg``: a ``NeighborSampler`` sample of
    ``batch_nodes`` seeds at the cell's fanouts over the host graph
    (``graph_edges`` edges, the cell's by default), its node rows gathered
    by ``node_ids``, labels on its seeds and -1 elsewhere.  Species modulo
    ``n_species``; padded nodes species 0, position 0, features 0, label
    -1.  The edges sorted by receiver shard over ``dpn`` dp shards
    (``sort_edges_for_mesh``), each shard's block padded to ``n_edges /
    dpn`` with masked self-loops on its first node."""
    rng = np.random.default_rng([seed, 1])
    out = {}
    if cell.name == "molecule":
        g = batched_molecules(cell.n_graphs, cell.n_nodes, cell.n_edges,
                              seed=seed)
        out["graph_ids"] = g["graph_ids"]
        out["energy"] = rng.normal(size=cell.n_graphs).astype(np.float32)
    elif cell.name == "minibatch_lg":
        host = random_graph(cell.n_nodes, graph_edges or cell.n_edges,
                            cell.d_feat, seed=seed)
        indptr, indices = to_csr(host["senders"], host["receivers"],
                                 cell.n_nodes)
        seeds = rng.choice(cell.n_nodes, cell.batch_nodes, replace=False)
        smp = NeighborSampler(indptr, indices, seed=seed).sample(
            seeds, cell.fanout)
        ids = smp["node_ids"]
        g = {"senders": smp["senders"], "receivers": smp["receivers"],
             **{k: host[k][ids] for k in ("positions", "species",
                                          "node_feat")}}
        labels = np.full(len(ids), -1, np.int32)
        labels[smp["seed_local"]] = rng.integers(0, n_classes, len(seeds))
    else:
        g = random_graph(sizes.raw_nodes, sizes.raw_edges, sizes.d_feat,
                         seed=seed)
        labels = rng.integers(0, n_classes, sizes.raw_nodes).astype(np.int32)
    n_real = len(g["species"])
    pad = sizes.n_nodes - n_real
    if pad < 0 or (pad and "graph_ids" in out):
        raise ValueError(f"{n_real} nodes do not pad to {sizes.n_nodes}")

    def padded(a, fill=0):
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1),
                      constant_values=fill)

    out["species"] = padded(g["species"] % cfg.n_species).astype(np.int32)
    out["positions"] = padded(g["positions"]).astype(np.float32)
    if sizes.d_feat:
        out["node_feat"] = padded(g["node_feat"]).astype(np.float32)
    if n_classes:
        out["labels"] = padded(labels, -1).astype(np.int32)
    s, r, mask = sort_edges_for_mesh(g["senders"], g["receivers"],
                                     sizes.n_nodes, dpn)
    per, have = sizes.n_edges // dpn, len(s) // dpn
    if have > per:
        raise ValueError(f"a dp shard holds {have} edges, more than the "
                         f"cell's {per}")
    first = (np.arange(dpn) * (sizes.n_nodes // dpn))[:, None]
    for name, a, fill in (("senders", s, first), ("receivers", r, first),
                          ("edge_mask", mask, 0)):
        block = np.broadcast_to(np.asarray(fill, a.dtype), (dpn, per)).copy()
        block[:, :have] = a.reshape(dpn, have)
        out[name] = block.reshape(-1)
    return out


def gnn_loss(cfg: MACEConfig, sizes: GraphSizes, n_classes: int,
             axes: Optional[Axes], unroll: bool = False,
             outputs: bool = False) -> Callable:
    """``loss_fn(params, batch) -> (loss, {})``: the node CE over labels
    >= 0 (a cell with classes) or the energy MSE, as the reference's;
    ``outputs`` puts ``mace_fwd``'s outputs, detached, in the dict."""
    def loss_fn(p, batch):
        out = mace_mod.mace_fwd(
            p, cfg, batch["species"], batch["positions"], batch["senders"],
            batch["receivers"], node_feat=batch.get("node_feat"),
            edge_mask=batch["edge_mask"], graph_ids=batch.get("graph_ids"),
            n_graphs=sizes.n_graphs, axes=axes,
            n_edge_chunks=sizes.n_edge_chunks, unroll=unroll)
        if n_classes:
            logits = upcast(out["node_logits"])
            lab = batch["labels"]
            valid = lab >= 0
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.take_along_dim(
                logits, torch.clamp(lab, min=0).long()[:, None], dim=-1)[:, 0]
            loss = torch.sum((lse - ll) * valid) / torch.clamp(
                torch.sum(valid), min=1)
        else:
            loss = torch.mean((out["energy"] - batch["energy"]) ** 2)
        return loss, ({k: v.detach() for k, v in out.items()} if outputs
                      else {})
    return loss_fn


def gnn_cell_config(cfg: MACEConfig, cell: ShapeCell, variant: str,
                    dpn: int
                    ) -> tuple[MACEConfig, GraphSizes, int, Optional[int]]:
    """(config, sizes, classes, host graph edges) of the program of the
    gnn cell ``cell`` of ``cfg`` over ``dpn`` dp shards."""
    cfg, nodes, graph_edges = _gnn_variant(cfg, cell, variant)
    sizes = _gnn_sizes(cell, dpn, nodes)
    cfg = dataclasses.replace(cfg, d_feat_in=sizes.d_feat)
    return cfg, sizes, N_CLASSES.get(cell.name, 0), graph_edges


def _gnn_program(spec: ArchSpec, cell: ShapeCell, mesh: Mesh,
                 multi_pod: bool, variant: str = "base") -> CellProgram:
    dp = dp_axes(multi_pod)
    dpn = _dp_size(mesh, dp)
    cfg, sizes, n_classes, graph_edges = gnn_cell_config(
        spec.config, cell, variant, dpn)
    opt = adamw(constant_schedule(1e-3))
    params_sds = _sds(mace_mod.init_mace(None, cfg, n_classes, "meta"))
    step_sds = ShapeDtype((), torch.int32)
    state_sds = TrainState(step_sds, params_sds,
                           AdamState(step_sds, params_sds, params_sds), None)
    n, e = sizes.n_nodes, sizes.n_edges
    batch_sds = {
        "species": ShapeDtype((n,), torch.int32),
        "positions": ShapeDtype((n, 3), torch.float32),
        "senders": ShapeDtype((e,), torch.int32),
        "receivers": ShapeDtype((e,), torch.int32),
        "edge_mask": ShapeDtype((e,), torch.float32),
    }
    if sizes.d_feat:
        batch_sds["node_feat"] = ShapeDtype((n, sizes.d_feat), torch.float32)
    if n_classes:
        batch_sds["labels"] = ShapeDtype((n,), torch.int32)
    else:
        batch_sds["graph_ids"] = ShapeDtype((n,), torch.int32)
        batch_sds["energy"] = ShapeDtype((sizes.n_graphs,), torch.float32)
    axes = Axes(dp=dp, tp="model", mesh=mesh)

    def make_args(generator: torch.Generator):
        params = mace_mod.init_mace(generator, cfg, n_classes, _device_of(mesh))
        batch = gnn_batch(cell, sizes, cfg, n_classes,
                          generator.initial_seed(), dpn, graph_edges)
        return (init_train_state(params, opt),
                {k: torch.from_numpy(v).to(_device_of(mesh))
                 for k, v in batch.items()})

    # model flops: per-edge tensor-product work dominates
    paths = 15
    c = cfg.d_hidden
    per_edge = cfg.n_layers * (2 * paths * c * 27 + 2 * cfg.n_rbf * 64
                               + 2 * 64 * paths * c)
    per_node = cfg.n_layers * (2 * paths * c * 81 * 2) + 2 * c * c
    n_params = int(sum(np.prod(x.shape) for x in leaves(params_sds)))
    meta = {
        "model_flops": 3 * (e * per_edge + n * per_node),
        "n_nodes": n, "n_edges": e, "kind": "train",
        "params_total": n_params, "params_active": n_params,
        "n_tokens": n,
    }
    # gnn_loss's metrics are empty: a step returns {"loss"}
    step = make_train_step(gnn_loss(cfg, sizes, n_classes, axes,
                                    "unroll=1" in variant), opt)
    # MACE params are small: replicated
    pspecs = tree_map(lambda _: P(), params_sds)
    batch_specs = {"species": P(dp), "positions": P(dp, None),
                   "senders": P(dp), "receivers": P(dp), "edge_mask": P(dp)}
    if sizes.d_feat:
        batch_specs["node_feat"] = P(dp, None)
    if n_classes:
        batch_specs["labels"] = P(dp)
    else:
        batch_specs["graph_ids"] = P(dp)
        batch_specs["energy"] = P(None)
    return CellProgram(
        fn=_on_mesh(step, mesh), args=(state_sds, batch_sds), meta=meta,
        make_args=make_args,
        meta_args=lambda: (init_train_state(mace_mod.init_mace(
            None, cfg, n_classes, "meta"), opt), _empty(batch_sds)),
        placements=(TrainState(P(), pspecs, _adam_specs(pspecs), None),
                    batch_specs),
        mesh=mesh)


# ===========================================================================
# RecSys cells
# ===========================================================================


def _recsys_fwd(cfg: RecsysConfig):
    if cfg.model == "dlrm":
        return lambda p, b: rs.dlrm_fwd(p, b["dense"], b["sparse"])
    if cfg.model == "autoint":
        return lambda p, b: rs.autoint_fwd(p, b["sparse"])
    if cfg.model == "widedeep":
        return lambda p, b: rs.widedeep_fwd(p, b["sparse"])
    if cfg.model == "mind":
        return lambda p, b: rs.mind_train_logits(p, cfg, b["hist"],
                                                 b["target"])
    raise ValueError(cfg.model)


def _recsys_init(cfg: RecsysConfig):
    """``init(generator=None, device="meta")`` -> the model."""
    init = rs.INITS[cfg.model]
    return lambda generator=None, device="meta": init(generator, cfg, device)


def _params_sds(cfg: RecsysConfig) -> dict:
    return _sds(rs.param_tree(_recsys_init(cfg)()))


def _recsys_specs(cfg: RecsysConfig, axes: Axes) -> dict:
    """The model's spec tree as the reference's cells place it: big
    tables (1,000,000 rows or more) row-split over every axis, medium
    ones (16,384 or more) over tp, small ones replicated."""
    all_axes = tuple(axes.dp) + (axes.tp,)

    def tables_spec():
        return [P(all_axes, None) if v >= 1_000_000 else
                (P(axes.tp, None) if v >= 16384 else P(None, None))
                for v in cfg.table_sizes]

    if cfg.model == "dlrm":
        s = rs.dlrm_specs(cfg, axes)
        s["tables"] = tables_spec()
        return s
    if cfg.model == "autoint":
        s = rs.autoint_specs(cfg, axes)
        s["tables"] = tables_spec()
        return s
    if cfg.model == "widedeep":
        s = rs.widedeep_specs(cfg, axes)
        s["tables"] = tables_spec()
        s["wide_tables"] = tables_spec()
        return s
    if cfg.model == "mind":
        return rs.mind_specs(cfg, axes)
    raise ValueError(cfg.model)


def _recsys_batch(cfg: RecsysConfig, b: int, axes: Optional[Axes],
                  train: bool) -> dict:
    """The batch's ShapeDtypes (the reference's sds)."""
    return _recsys_batch_specs(cfg, b, axes, train)[0]


def _recsys_batch_specs(cfg: RecsysConfig, b: int, axes: Optional[Axes],
                        train: bool) -> tuple[dict, dict]:
    """(the batch's ShapeDtypes, their specs): every leaf split over dp
    on its first axis."""
    dp = tuple(axes.dp) if axes is not None else ("data",)
    sds, specs = {}, {}
    if cfg.model == "mind":
        sds["hist"] = ShapeDtype((b, cfg.hist_len), torch.int32)
        sds["target"] = ShapeDtype((b,), torch.int32)
        specs["hist"] = P(dp, None)
        specs["target"] = P(dp)
    else:
        if cfg.n_dense:
            sds["dense"] = ShapeDtype((b, cfg.n_dense), torch.float32)
            specs["dense"] = P(dp, None)
        sds["sparse"] = ShapeDtype((b, cfg.n_sparse), torch.int32)
        specs["sparse"] = P(dp, None)
    if train:
        sds["labels"] = ShapeDtype((b,), torch.float32)
        specs["labels"] = P(dp)
    return sds, specs


def recsys_data(cfg: RecsysConfig, b: int, seed: int, device,
                train: bool = False) -> dict:
    """A batch of ``b`` on ``device`` (with its labels for ``train``):
    ``CTRStream`` for the CTR models, ``BehaviorStream`` for MIND up to
    ``STREAM_MAX_BATCH`` users and seeded uniform ids past it."""
    if cfg.model != "mind":
        out = CTRStream(cfg.table_sizes, cfg.n_dense, seed=seed,
                        multi_hot=cfg.multi_hot).batch(b)
    elif b <= STREAM_MAX_BATCH:
        out = BehaviorStream(cfg.item_vocab, cfg.hist_len, seed=seed).batch(b)
    else:
        rng = np.random.default_rng(seed)
        out = {"hist": rng.integers(0, cfg.item_vocab, (b, cfg.hist_len),
                                    dtype=np.int32),
               "target": rng.integers(0, cfg.item_vocab, b, dtype=np.int32),
               "labels": np.ones((b,), np.float32)}
    return {k: torch.from_numpy(out[k]).to(device)
            for k in _recsys_batch(cfg, b, None, train=train)}


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """The mean binary cross-entropy of ``logits``, written as the
    reference writes it."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def recsys_loss(cfg: RecsysConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss, {})`` of the model's BCE."""
    fwd = _recsys_fwd(cfg)
    return lambda p, b: (bce_with_logits(fwd(p, b), b["labels"]), {})


def _top_k(scores: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, descending, ties to the lower index."""
    neg, pos = topk_smallest(-scores, k)
    return -neg, pos.int()


def _recsys_train_program(spec: ArchSpec, cell: ShapeCell, mesh: Mesh,
                          multi_pod: bool) -> CellProgram:
    cfg: RecsysConfig = spec.config
    opt = adamw(constant_schedule(1e-3))
    params_sds = _params_sds(cfg)
    step_sds = ShapeDtype((), torch.int32)
    state_sds = TrainState(step_sds, params_sds,
                           AdamState(step_sds, params_sds, params_sds), None)
    axes = _axes(mesh, multi_pod)
    batch_sds, batch_specs = _recsys_batch_specs(cfg, cell.batch, axes,
                                                 train=True)
    pspecs = _recsys_specs(cfg, axes)
    step = make_train_step(recsys_loss(cfg), opt)

    def train_step(state: TrainState, batch):
        state, metrics = step(state, batch)
        return state, {"loss": metrics["loss"]}

    def make_args(generator: torch.Generator):
        model = _recsys_init(cfg)(generator, _device_of(mesh))
        return (init_train_state(model, opt),
                recsys_data(cfg, cell.batch, generator.initial_seed(),
                            _device_of(mesh), train=True))

    return CellProgram(
        fn=_on_mesh(train_step, mesh),
        args=(state_sds, batch_sds),
        meta=_recsys_meta(cfg, cell, params_sds),
        make_args=make_args,
        meta_args=lambda: (init_train_state(_recsys_init(cfg)(), opt),
                           _empty(batch_sds)),
        placements=(TrainState(P(), pspecs, _adam_specs(pspecs), None),
                    batch_specs),
        mesh=mesh,
    )


def _recsys_serve_program(spec: ArchSpec, cell: ShapeCell, mesh: Mesh,
                          multi_pod: bool) -> CellProgram:
    cfg: RecsysConfig = spec.config
    axes = _axes(mesh, multi_pod)
    params_sds = _params_sds(cfg)
    batch_sds, batch_specs = _recsys_batch_specs(cfg, cell.batch, axes,
                                                 train=False)
    fwd = _recsys_fwd(cfg)

    @torch.no_grad()
    def serve_step(params, batch):
        return fwd(params, batch)

    def make_args(generator: torch.Generator):
        return (_recsys_init(cfg)(generator, _device_of(mesh)),
                recsys_data(cfg, cell.batch, generator.initial_seed(),
                            _device_of(mesh)))

    return CellProgram(
        fn=_on_mesh(serve_step, mesh),
        args=(params_sds, batch_sds),
        meta=_recsys_meta(cfg, cell, params_sds, train=False),
        make_args=make_args,
        meta_args=lambda: (_recsys_init(cfg)(), _empty(batch_sds)),
        placements=(_recsys_specs(cfg, axes), batch_specs),
        mesh=mesh,
    )


def _forest_sds(local_cfg: ForestConfig, n_local: int, cells: tuple) -> Forest:
    """The ShapeDtypes of the cells' forests, with the reference's leading
    (db shard, tree shard) axes."""
    lm = cells + (local_cfg.n_trees, local_cfg.max_nodes)
    i32, f32 = torch.int32, torch.float32
    return Forest(
        proj_idx=ShapeDtype(lm + (local_cfg.n_proj,), i32),
        proj_coef=ShapeDtype(lm + (local_cfg.n_proj,), f32),
        thresh=ShapeDtype(lm, f32), child_base=ShapeDtype(lm, i32),
        perm=ShapeDtype(cells + (local_cfg.n_trees, n_local), i32),
        leaf_offset=ShapeDtype(lm, i32), leaf_count=ShapeDtype(lm, i32),
        n_nodes=ShapeDtype(cells + (local_cfg.n_trees,), i32))


def build_catalog_index(params: rs.MIND, mesh, multi_pod: bool = False,
                        draws: Optional[CellDraws] = None):
    """``MIND_FOREST`` over the catalog ``params.item_embed``, its rows
    split over the mesh's db axes and its trees over ``model``; cell (di,
    ti) draws from ``seal_seed(seal_seed(0, di), ti)``, or from
    ``draws``.  On a logical ``Mesh`` the ``ShardedForest`` of this
    process's cells; on a ``DeviceMesh`` the stacked ``Forest`` as
    DTensors, this rank's cell built from its own rows."""
    with torch.no_grad():
        return build_sharded_index(0, params.item_embed.detach(),
                                   MIND_FOREST, mesh,
                                   db_axes=dp_axes(multi_pod),
                                   tree_axis="model", draws=draws)


def _mind_rpf_retrieval_program(spec: ArchSpec, cell: ShapeCell,
                                mesh: Mesh, multi_pod: bool, *,
                                draws: Optional[CellDraws] = None,
                                kernel_mode: str = "auto") -> CellProgram:
    """retrieval_cand served THROUGH the paper's index (variant rpf=1).

    The item catalog is row-sharded over dp (each shard owns a forest over
    its rows, trees sharded over the ``model`` axis); the interest vectors
    traverse the forest (kernel A), rerank only ~L*C candidates per shard
    (kernel B), and a small top-k merge crosses the mesh -- vs the
    brute-force variant's full-catalog scoring.  Ranked by l2, as the
    reference's (whose docstring assumes unit-norm rows that ``init_mind``
    does not make).  ``kernel_mode="ref"`` runs the plain versions.

    On a logical ``Mesh`` the forest argument is a ``ShardedForest`` of
    cells; on a ``DeviceMesh`` it is the reference's stacked ``Forest``
    under ``P(dp, "model")``: the interests come from the DTensor
    parameters (the history through ``row_split_gather``) and go to the
    sharded step whole, and each rank queries its own cell against its
    own catalog rows.
    """
    cfg: RecsysConfig = spec.config
    dp = dp_axes(multi_pod)
    dpn = _dp_size(mesh, dp)
    rows = _pad_to(cfg.item_vocab, cfg.row_pad_to)
    n_local = rows // dpn
    fcfg = MIND_FOREST
    tpn = mesh_sizes(mesh)["model"]
    l_local = max(1, fcfg.n_trees // tpn)
    local_cfg = fcfg._replace(n_trees=l_local).resolved(n_local)

    params_sds = _params_sds(cfg)
    forest_sds = _forest_sds(local_cfg, n_local, (dpn, tpn))
    hist_sds = ShapeDtype((1, cfg.hist_len), torch.int32)
    qstep = make_query_fn(local_cfg, n_local, mesh, db_axes=dp,
                          tree_axis="model", k=K_RETRIEVE, metric="l2",
                          kernel_mode=kernel_mode)

    @torch.no_grad()
    def retrieve(params, hist, forest):
        interests = rs.mind_user_fwd(params, cfg, hist)      # (1, K, D)
        if is_dtensor(interests):
            # the sharded step takes its queries whole on every rank
            interests = interests.full_tensor()
        flat = interests.reshape(cfg.n_interests, cfg.embed_dim)
        d, ids = qstep(forest, flat, params.item_embed)
        # merge the per-interest lists into one top-k
        return merge_topk_pairs(d.reshape(1, -1), ids.reshape(1, -1),
                                K_RETRIEVE)

    def make_args(generator: torch.Generator):
        params = _recsys_init(cfg)(generator, _device_of(mesh))
        hist = recsys_data(cfg, 1, generator.initial_seed(),
                           _device_of(mesh))["hist"]
        return params, hist, build_catalog_index(params, mesh, multi_pod,
                                                 draws)

    # model flops: traversal + rerank of L*C candidates per interest
    cand = fcfg.n_trees * local_cfg.leaf_pad
    flops = 2 * cand * cfg.n_interests * cfg.embed_dim

    def meta_args():
        if is_device_mesh(mesh):
            return _recsys_init(cfg)(), _empty(hist_sds), _empty(forest_sds)
        cells = tuple(((di, ti), tree_map(lambda s: torch.empty(
            s.shape[2:], dtype=s.dtype, device="meta"), forest_sds))
            for di in range(dpn) for ti in range(tpn))
        return (_recsys_init(cfg)(), _empty(hist_sds),
                ShardedForest(cells, n_local, local_cfg))

    # the catalog is resharded over dp rows for the index: every card owns
    # catalog rows
    pspecs = dict(_recsys_specs(cfg, _axes(mesh, multi_pod)))
    pspecs["item_embed"] = P(tuple(dp), None)
    return CellProgram(
        fn=_on_mesh(retrieve, mesh),
        args=(params_sds, hist_sds, forest_sds),
        meta=_recsys_meta(cfg, cell, params_sds, train=False, flops=flops),
        make_args=make_args,
        meta_args=meta_args,
        placements=(pspecs, P(None, None),
                    tree_map(lambda _: P(tuple(dp), "model"), forest_sds)),
        mesh=mesh,
    )


def _recsys_retrieval_program(spec: ArchSpec, cell: ShapeCell, mesh: Mesh,
                              multi_pod: bool, n_cand: int = N_CAND
                              ) -> CellProgram:
    """Score ``n_cand`` candidates for one request; top-k output.

    MIND: interests x item-embedding product over the whole catalog (its
    padded rows too), max over interests.  CTR models: broadcast the user
    context over the candidate item field (the last sparse field), whose
    gather clamps every id past its table to the last row.
    """
    cfg: RecsysConfig = spec.config
    axes = _axes(mesh, multi_pod)
    all_axes = tuple(axes.dp) + (axes.tp,)
    params_sds = _params_sds(cfg)
    pspecs = _recsys_specs(cfg, axes)
    k, dev = K_RETRIEVE, _device_of(mesh)

    if cfg.model == "mind":
        hist_sds = ShapeDtype((1, cfg.hist_len), torch.int32)

        @torch.no_grad()
        def retrieve(params, hist):
            interests = rs.mind_user_fwd(params, cfg, hist)      # (1, K, D)
            scores = torch.einsum("bkd,nd->bkn", interests,
                                  params.item_embed)
            return _top_k(torch.amax(scores, dim=1), k)          # (1, N)

        def make_args(generator: torch.Generator):
            return (_recsys_init(cfg)(generator, dev),
                    recsys_data(cfg, 1, generator.initial_seed(),
                                dev)["hist"])

        return CellProgram(
            fn=_on_mesh(retrieve, mesh), args=(params_sds, hist_sds),
            meta=_recsys_meta(cfg, cell, params_sds, train=False,
                              flops=2 * N_CAND * cfg.n_interests
                              * cfg.embed_dim),
            make_args=make_args,
            meta_args=lambda: (_recsys_init(cfg)(), _empty(hist_sds)),
            placements=(pspecs, P(None, None)),
            mesh=mesh,
        )

    cand_sds = ShapeDtype((n_cand,), torch.int32)
    user_sds = _recsys_batch(cfg, 1, axes, train=False)
    item_field = cfg.n_sparse - 1   # last sparse field = item id
    fwd = _recsys_fwd(cfg)

    @torch.no_grad()
    def retrieve(params, user, cand_ids):
        n = cand_ids.shape[0]
        b = {}
        if is_dtensor(cand_ids):
            # the user's context over the candidates, split as they are
            cand = P(all_axes, None)
            if "dense" in user:
                b["dense"] = constrain(user["dense"].expand(n, cfg.n_dense),
                                       cand)
            ctx = constrain(user["sparse"][:, :item_field].expand(
                n, item_field), cand)
            sp = torch.cat([ctx, cand_ids[:, None]], dim=1)
        else:
            if "dense" in user:
                b["dense"] = user["dense"].expand(n, cfg.n_dense)
            sp = user["sparse"].expand(n, cfg.n_sparse).clone()
            sp[:, item_field] = cand_ids
        b["sparse"] = sp
        scores = constrain(fwd(params, b), P(all_axes))
        top, pos = _top_k(scores, k)
        if is_dtensor(cand_ids):
            cand_ids = constrain(cand_ids, P(None))
        return top, cand_ids[pos.long()]

    def make_args(generator: torch.Generator):
        return (_recsys_init(cfg)(generator, dev),
                recsys_data(cfg, 1, generator.initial_seed(), dev),
                torch.arange(n_cand, dtype=torch.int32, device=dev))

    # a cand=N cut counts the N candidates it scores
    scored = dataclasses.replace(cell, n_candidates=min(cell.n_candidates,
                                                        n_cand))
    return CellProgram(
        fn=_on_mesh(retrieve, mesh),
        args=(params_sds, user_sds, cand_sds),
        meta=_recsys_meta(cfg, scored, params_sds, train=False),
        make_args=make_args,
        meta_args=lambda: (_recsys_init(cfg)(), _empty(user_sds),
                           _empty(cand_sds)),
        placements=(pspecs, tree_map(lambda _: P(None, None), user_sds),
                    P(all_axes)),
        mesh=mesh,
    )


def _recsys_meta(cfg: RecsysConfig, cell: ShapeCell, params_sds,
                 train: bool = True, flops: Optional[int] = None) -> dict:
    n_params = int(sum(np.prod(x.shape) for x in leaves(params_sds)))
    b = cell.batch if cell.n_candidates == 0 else cell.n_candidates
    if flops is None:
        # active per example: embedding rows + MLP/attention mults
        mlp = 0
        if cfg.model == "dlrm":
            dims = (cfg.n_dense,) + cfg.bot_mlp
            mlp += sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
            f = cfg.n_sparse + 1
            top_in = f * (f - 1) // 2 + cfg.embed_dim
            dims = (top_in,) + cfg.top_mlp
            mlp += sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
            mlp += 2 * f * f * cfg.embed_dim
        elif cfg.model == "autoint":
            d = cfg.embed_dim
            for i in range(cfg.n_attn_layers):
                d_in = d if i == 0 else cfg.d_attn
                h = cfg.n_attn_heads * cfg.d_attn
                mlp += cfg.n_sparse * (2 * 3 * d_in * h + 2 * h * cfg.d_attn)
                mlp += 2 * cfg.n_sparse ** 2 * h * 2
            mlp += 2 * cfg.n_sparse * cfg.d_attn
        elif cfg.model == "widedeep":
            dims = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp + (1,)
            mlp += sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        else:  # mind
            d = cfg.embed_dim
            mlp += cfg.capsule_iters * 2 * cfg.hist_len * cfg.n_interests * d
            mlp += 2 * d * 4 * d * 2
        flops = b * mlp * (3 if train else 1)
    return {"model_flops": int(flops), "params_total": n_params,
            "params_active": n_params, "n_tokens": b,
            "kind": "train" if train else "serve"}


# ===========================================================================
# entry point
# ===========================================================================


def _recsys_variant(cfg: RecsysConfig, variant: str
                    ) -> tuple[RecsysConfig, bool, int]:
    """(config, rpf, n_cand) of a recsys ``variant``."""
    rpf, n_cand = False, N_CAND
    for item in (variant.split(",") if variant != "base" else []):
        key, _, val = item.partition("=")
        if key == "rpf":
            rpf = val == "1"
        elif key == "rows":
            cap = int(val)
            cfg = dataclasses.replace(
                cfg, table_sizes=tuple(min(s, cap) for s in cfg.table_sizes),
                item_vocab=min(cfg.item_vocab, cap))
        elif key == "cand":
            n_cand = int(val)
        else:
            raise ValueError(f"unknown recsys variant key {key!r}")
    return cfg, rpf, n_cand


def build_cell(arch_id: str, cell_name: str, mesh: Optional[Mesh] = None,
               multi_pod: bool = False, variant: str = "base",
               device=None) -> CellProgram:
    """The cell's program on ``mesh`` (default: a one-cell logical mesh on
    ``device``, the GPU unless ``device="cpu"``): a
    ``core.sharded_index.Mesh``, or a ``DeviceMesh`` with the reference's
    axis names, over which ``fn`` takes DTensors (``prog.shard_args``)."""
    spec = get_arch(arch_id)
    cell = {c.name: c for c in spec.cells}[cell_name]
    if cell.skip:
        raise ValueError(f"cell {arch_id}/{cell_name} is skipped: "
                         f"{cell.skip_reason}")
    if mesh is None:
        shape, axes = (((1, 1, 1), ("pod", "data", "model")) if multi_pod
                       else ((1, 1), ("data", "model")))
        mesh = Mesh(shape, axes, device=device)
    if spec.family == "gnn":
        return _gnn_program(spec, cell, mesh, multi_pod, variant)
    if spec.family == "lm":
        rest, batch = _lm_batch_variant(variant)
        cfg = _apply_lm_variant(spec.config, rest)
        spec = dataclasses.replace(spec, config=cfg)
        b = batch or cell.global_batch
        if cell.kind == "train":
            return _lm_train_program(spec, cell, mesh, multi_pod, b)
        if cell.kind == "prefill":
            return _lm_prefill_program(spec, cell, mesh, multi_pod, b)
        if cell.kind == "decode":
            return _lm_decode_program(spec, cell, mesh, multi_pod, b)
    if spec.family == "recsys":
        cfg, rpf, n_cand = _recsys_variant(spec.config, variant)
        spec = dataclasses.replace(spec, config=cfg)
        if cell.kind == "train":
            return _recsys_train_program(spec, cell, mesh, multi_pod)
        if cell.kind == "serve":
            return _recsys_serve_program(spec, cell, mesh, multi_pod)
        if cell.kind == "retrieval":
            if rpf and cfg.model == "mind":
                return _mind_rpf_retrieval_program(spec, cell, mesh,
                                                   multi_pod)
            return _recsys_retrieval_program(spec, cell, mesh, multi_pod,
                                             n_cand)
    raise ValueError(f"no program for {arch_id}/{cell_name}")
