"""MACE: higher-order E(3)-equivariant message passing (arXiv:2206.07697)
(port of ``repro/models/mace.py``).

Features are dense (n_nodes, C, M) tensors with M = sum_l (2l+1) = 9 for
l_max = 2, per-l blocks static slices; message passing gathers by edge
sender and scatters to receivers with ``index_add_``, the reference's
``segment_sum``; the order-nu=3 ACE contraction is two iterated
channel-wise CG tensor products over the fixed 15-path list of l <= 2.
The reference leaves all of it to XLA with no Pallas kernel, so the port
is plain PyTorch.  On the card ``index_add_`` sums with float atomics:
two runs of a step may differ in the last bits unless
``torch.use_deterministic_algorithms(True)`` is on.

"f32" means at least f32: the CG tables, the node features and the
accumulators take the inputs' dtype promoted with f32 (the reference
hard-codes f32), so a float64 input computes in float64.  The parameters
are a dict tree of tensors (the reference's ``init_mace`` tree), leaves
that require gradients.

The two einsums are written out as products whose intermediates stay
small (``_tables`` lays the tables out): the edge messages contract the
spherical harmonics with the tables first, (E, 9) @ (9, 9 W) -> (E, 9,
W), W = 51 the output columns of all 15 paths, then take one batched
product with the gathered features, (E, C, 9) @ (E, 9, W) -> (E, C, W);
the node products form the outer product of one l1 block with the whole
other operand, (n, C, a, 9), and contract it with the tables of that
l1's paths, (n, C, 9 a) @ (9 a, K), a product whose backward keeps only
the table.  Left to right, ``torch.einsum`` would form (E, C, b, k) and
(b, c, n, C) tensors, 25 floats a (row, channel) for the (2, 2, 2) path
alone.  The gathers are ``index_select`` (whose backward is an
``index_add_``) and the species embedding a one-hot product.

``mace_fwd(..., axes=Axes(dp, tp, mesh))`` runs the reference's
``_a_features_sharded`` over the port's ``core.sharded_index.Mesh``: edges
sorted by receiver shard (``data/graph_data.sort_edges_for_mesh``), each
dp cell owning nodes [di n_loc, (di + 1) n_loc), gathering every cell's
``h`` in ``cfg.exchange_dtype`` and scattering its edges into
``recv - di n_loc``; the tp cells hold replicas.  Without a process group
each dp shard is computed once, in turn, and the shards concatenated.
With one, each rank takes one cell (any other layout raises) and holds
its shard's nodes through the layers: the exchange is an all-gather over
the cell's dp peers whose backward reduce-scatters the cotangent, the
readout's node outputs are gathered and its energies summed over the dp
peers (their backward the rank's own part of the cotangent), and the
gradients of the inputs every rank holds (the parameters, positions and
node features) are summed over the dp peers (``models/collectives.py``).
Every rank passes the same inputs and gets the group-less mesh's outputs
and gradients.  On a ``DeviceMesh`` (the cell programs' DTensors, split
over dp as the reference's ``_c`` constrains them) each rank holds its dp
shard's nodes and edges and the exchange runs over the mesh's dp group
(``_mace_fwd_dtensor``).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import MACEConfig
from repro_torch.device import resolve_device
from repro_torch.models.equivariant import (L_SLICES, coupling_paths,
                                            real_clebsch_gordan,
                                            real_sph_harm_l2)
from repro_torch.models.collectives import (AllGather, Concat, Grid, Sum,
                                            SumGrads, axes_mesh, device_cell,
                                            everyone, mesh_placements,
                                            peer_cells)
from repro_torch.models.layers import (P, constrain, contiguous_stride,
                                       is_device_mesh, normal, upcast)
from repro_torch.tree import leaves, tree_map

M_TOT = 9  # sum (2l+1), l <= 2


class _Tables(NamedTuple):
    """The CG coefficients laid out for the products (``_tables``)."""

    paths: list            # (l1, l2, l3) in the reference's order
    by_l3: torch.Tensor    # (P,) the paths sorted by l3 (stable)
    l3_blocks: tuple       # per l3: (its paths, 2 l3 + 1)
    edge: torch.Tensor     # (M, M W): [b, (a, col)], W = sum_p (2 l3 + 1)
    node: tuple            # per l1: (table (a M, K), col -> path (K,),
    #                        col -> output component (K, M) 0 / 1)
    degree: torch.Tensor   # (M,) each component's l


@functools.lru_cache(maxsize=None)
def _tables(l_max: int, device: torch.device, dtype: torch.dtype) -> _Tables:
    """The coupling paths' real CG tables in ``dtype`` on ``device``.

    ``edge`` holds every path's table at its (l1, l2) rows in W columns,
    the paths ordered by l3 (the order of ``by_l3``), each path's 2 l3 + 1
    columns together.  ``node`` holds per l1 the table of that l1's paths
    (K columns) with each column's path and output component."""
    paths = coupling_paths(l_max)
    by_l3 = sorted(range(len(paths)), key=lambda p: paths[p][2])
    cgs = {p: torch.from_numpy(real_clebsch_gordan(*paths[p]))
           for p in by_l3}
    width = sum(2 * paths[p][2] + 1 for p in by_l3)
    edge = torch.zeros((M_TOT, M_TOT, width), dtype=torch.float64)
    col = 0
    for p in by_l3:
        l1, l2, l3 = paths[p]
        edge[L_SLICES[l1], L_SLICES[l2], col:col + 2 * l3 + 1] = cgs[p]
        col += 2 * l3 + 1
    l3_blocks = tuple((sum(paths[p][2] == l3 for p in by_l3), 2 * l3 + 1)
                      for l3 in range(l_max + 1))
    node = []
    for l1 in range(l_max + 1):
        mine = [p for p in range(len(paths)) if paths[p][0] == l1]
        k_all = sum(2 * paths[p][2] + 1 for p in mine)
        g = torch.zeros((2 * l1 + 1, M_TOT, k_all), dtype=torch.float64)
        col_path = torch.zeros(k_all, dtype=torch.long)
        scatter = torch.zeros((k_all, M_TOT), dtype=torch.float64)
        col = 0
        for p in mine:
            _, l2, l3 = paths[p]
            k = 2 * l3 + 1
            g[:, L_SLICES[l2], col:col + k] = cgs[p]
            col_path[col:col + k] = p
            scatter[col:col + k, L_SLICES[l3]] = torch.eye(k,
                                                           dtype=torch.float64)
            col += k
        node.append((g.reshape(-1, k_all).to(device=device, dtype=dtype),
                     col_path.to(device), scatter.to(device=device,
                                                     dtype=dtype)))
    degree = [l for l in range(l_max + 1) for _ in range(2 * l + 1)]
    return _Tables(paths, torch.tensor(by_l3, device=device), l3_blocks,
                   edge.transpose(0, 1).reshape(M_TOT, -1).to(
                       device=device, dtype=dtype), tuple(node),
                   torch.tensor(degree, device=device))


def bessel_basis(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Radial Bessel basis with smooth cosine cutoff. r: (E,) -> (E, n_rbf)."""
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rr = torch.clamp(r, min=1e-6)[:, None]
    basis = math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * rr / r_cut) / rr
    env = 0.5 * (torch.cos(math.pi * torch.clip(r / r_cut, 0, 1)) + 1.0)
    return basis * env[:, None]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_mace(generator: Optional[torch.Generator], cfg: MACEConfig,
              n_classes: int = 0, device=None) -> dict:
    """The reference's tree drawn from ``generator`` on ``device`` (the GPU
    unless ``device="cpu"``; ``"meta"`` allocates nothing): N(0, 0.25)
    species embeddings, dense weights N(0, 1/d_in), the product weights
    the constants 0.3 and 0.1; every leaf f32 and requiring gradients."""
    dev = torch.device("meta") if device is not None and torch.device(
        device).type == "meta" else resolve_device(device)
    c = cfg.d_hidden
    n_paths = len(coupling_paths(cfg.l_max))

    def draw(shape, scale):
        return normal(generator, shape, dev).mul_(scale)

    params = {
        "species_embed": draw((cfg.n_species, c), 0.5),
        "readout_w1": draw((c, c), 1 / math.sqrt(c)),
        "readout_w2": draw((c, 1), 1 / math.sqrt(c)),
        "layers": [],
    }
    if cfg.d_feat_in:
        params["feat_proj"] = draw((cfg.d_feat_in, c),
                                   1 / math.sqrt(cfg.d_feat_in))
    if n_classes:
        params["cls_head"] = draw((c, n_classes), 1 / math.sqrt(c))
    for _ in range(cfg.n_layers):
        params["layers"].append({
            # radial MLP: bessel -> hidden -> per-(edge-path, channel) weights
            "radial_w1": draw((cfg.n_rbf, 64), 1 / math.sqrt(cfg.n_rbf)),
            "radial_w2": draw((64, n_paths * c), 1 / math.sqrt(64.0)),
            # channel mixers per l for messages and self-connection
            "mix_msg": draw((cfg.l_max + 1, c, c), 1 / math.sqrt(c)),
            "mix_self": draw((cfg.l_max + 1, c, c), 1 / math.sqrt(c)),
            # learned per-(path, channel) weights for the nu=2 / nu=3 products
            "prod2_w": torch.full((n_paths, c), 0.3, device=dev),
            "prod3_w": torch.full((n_paths, c), 0.1, device=dev),
        })
    for t in leaves(params):
        t.requires_grad_()
    return params


# ---------------------------------------------------------------------------
# tensor-product helpers
# ---------------------------------------------------------------------------


def _cg_product(a: torch.Tensor, b: torch.Tensor, weights: torch.Tensor,
                l_max: int) -> torch.Tensor:
    """Channel-wise weighted CG product of two (..., C, M) feature arrays.

    Per l1: the outer product of a's l1 block with all of b, (..., C, a,
    M), times the tables of that l1's paths, (a M, K) -> (..., C, K); each
    column times its path's channel weights, then summed into its output
    component by a 0 / 1 (K, M) product.  The outer product is the largest
    intermediate (45 floats a (node, channel) at l1 = 2) and lives only
    until its product, whose backward keeps only the table; the backward
    keeps the K columns of each l1, 51 floats a (node, channel) in all."""
    tabs = _tables(l_max, a.device, a.dtype)
    blocks = torch.split(a, [2 * l + 1 for l in range(l_max + 1)], dim=-1)
    out = None
    for blk, (g, col_path, scatter) in zip(blocks, tabs.node):
        outer = blk[..., :, None] * b[..., None, :]          # (..., C, a, M)
        t = outer.flatten(-2) @ g                            # (..., C, K)
        o = (t * weights.index_select(0, col_path).T) @ scatter
        out = o if out is None else out + o
    return out


def _mix_per_l(x: torch.Tensor, w: torch.Tensor, l_max: int) -> torch.Tensor:
    """Per-l channel mixing: x (..., C, M), w (l_max+1, C, C).

    One product over the M components, each with its degree's matrix:
    the reference's per-l einsums without slicing ``x`` or concatenating
    the results."""
    degree = _tables(l_max, w.device, w.dtype).degree
    return torch.einsum("...cm,mcd->...dm", x, w.index_select(0, degree))


def _msg_chunk(layer: dict, cfg: MACEConfig, h_src: torch.Tensor,
               rbf_c: torch.Tensor, sph_c: torch.Tensor,
               send_c: torch.Tensor) -> torch.Tensor:
    """Per-edge messages (Ec, C, M) for one chunk, gathered from ``h_src``.

    The harmonics times the tables first, (Ec, M) @ (M, M W) -> (Ec, M,
    W), then one batched product with the gathered features, (Ec, C, M) @
    (Ec, M, W) -> (Ec, C, W): every path's output columns, ordered by l3.
    Per output degree l3 (as the reference accumulates) its paths' columns
    times their radial weights, summed over the paths; no intermediate
    holds more than W = 51 floats an (edge, channel)."""
    c = cfg.d_hidden
    tabs = _tables(cfg.l_max, rbf_c.device, rbf_c.dtype)
    n_paths = len(tabs.paths)
    # the radial weights as (Ec, C, P), the paths in l3 order
    w2 = layer["radial_w2"].view(-1, n_paths, c).index_select(
        1, tabs.by_l3).transpose(1, 2).reshape(-1, c * n_paths)
    rw = (F.silu(rbf_c @ layer["radial_w1"]) @ w2).view(-1, c, n_paths)
    hj = upcast(torch.index_select(h_src, 0, send_c))       # (Ec, C, M)
    t = (sph_c @ tabs.edge).view(-1, M_TOT, tabs.edge.shape[1] // M_TOT)
    msg = torch.bmm(hj, t)                                  # (Ec, C, W)
    outs = []
    for x, r, (n_p, k) in zip(
            torch.split(msg, [n * k for n, k in tabs.l3_blocks], dim=-1),
            torch.split(rw, [n for n, _ in tabs.l3_blocks], dim=-1),
            tabs.l3_blocks):
        outs.append(torch.sum(x.view(-1, c, n_p, k) * r[..., None], dim=-2))
    return torch.cat(outs, dim=-1)


def _scatter_messages(layer: dict, cfg: MACEConfig, h_src: torch.Tensor,
                      rbf: torch.Tensor, sph: torch.Tensor,
                      send: torch.Tensor, recv: torch.Tensor, n_out: int,
                      ec: int) -> torch.Tensor:
    """sum over edges of their messages at their receivers, (n_out, C, M),
    in chunks of ``ec`` edges; with more than one chunk each chunk's
    messages and scatter run under ``checkpoint`` (recomputed in the
    backward), so only one chunk's (ec, P, C) tensors are live."""
    def contrib(hf, rbf_c, sph_c, send_c, recv_c):
        m = _msg_chunk(layer, cfg, hf, rbf_c, sph_c, send_c)
        return m.new_zeros((n_out,) + tuple(m.shape[1:])).index_add_(
            0, recv_c, m)

    e = send.shape[0]
    if ec >= e:
        return contrib(h_src, rbf, sph, send, recv)
    acc = None
    for lo in range(0, e, ec):
        sl = slice(lo, lo + ec)
        part = checkpoint(contrib, h_src, rbf[sl], sph[sl], send[sl],
                          recv[sl], use_reentrant=False)
        acc = part if acc is None else acc + part
    return acc


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def mace_fwd(params: dict, cfg: MACEConfig, species: torch.Tensor,
             positions: torch.Tensor, senders: torch.Tensor,
             receivers: torch.Tensor,
             node_feat: Optional[torch.Tensor] = None,
             edge_mask: Optional[torch.Tensor] = None,
             graph_ids: Optional[torch.Tensor] = None, n_graphs: int = 1,
             axes=None, n_edge_chunks: int = 1, unroll: bool = False) -> dict:
    """species (n,), positions (n,3), senders/receivers (E,).

    Returns {node_inv (n,C), energy (n_graphs,), node_logits?}.

    ``axes`` (``models.layers.Axes`` with a ``mesh``) runs the message
    passing on the mesh's cells (the module's docstring).  ``n_edge_chunks``
    > 1 streams the per-edge messages in chunks, each under
    ``checkpoint``: live memory is one chunk's (E/c, P, C) tensors, in the
    forward and the backward; the partial scatters are summed.  The
    reference's ``unroll`` picks a Python loop or a ``lax.scan`` of the
    same sum; the port's loop is both, so ``unroll`` changes nothing.
    """
    del unroll
    n = species.shape[0]
    mesh = getattr(axes, "mesh", None) if axes is not None else None
    if is_device_mesh(mesh):
        return _mace_fwd_dtensor(params, cfg, species, positions, senders,
                                 receivers, node_feat, edge_mask, graph_ids,
                                 n_graphs, axes, n_edge_chunks)
    e_total = senders.shape[0]
    n_chunks = max(1, n_edge_chunks)
    exchange = None
    if mesh is None:
        assert e_total % n_chunks == 0, "pad edges to a chunk multiple"
        shards = [(0, n, slice(None))]   # (di, n_loc, its edges)
        ec = e_total // n_chunks
        lo, hi = 0, n
    else:
        grid = Grid(mesh, axes.dp, axes.tp)
        n_loc, e_loc, ec = _split_sizes(n, e_total, grid.dp_n, n_chunks)
        dis = sorted({di for di, _ in grid.local})   # each dp shard once
        shards = [(di, n_loc, slice(di * e_loc, (di + 1) * e_loc))
                  for di in dis]
        ex_dtype = _exchange_dtype(cfg)
        if grid.group is not None:
            peers = peer_cells(mesh, mesh.rank, grid.dp)
            params = tree_map(lambda t: SumGrads.apply(t, mesh, peers),
                              params)
            positions = SumGrads.apply(positions, mesh, peers)
            if node_feat is not None and node_feat.requires_grad:
                node_feat = SumGrads.apply(node_feat, mesh, peers)
            lo, hi = dis[0] * n_loc, (dis[0] + 1) * n_loc

            def exchange(h_):
                return AllGather.apply(h_.to(ex_dtype), mesh, peers, 0,
                                       False).to(h_.dtype)
        else:
            lo, hi = 0, n

            def exchange(h_):
                return h_.to(ex_dtype).to(h_.dtype)

    edges = [(di, n_loc, senders[sl], receivers[sl],
              None if edge_mask is None else edge_mask[sl])
             for di, n_loc, sl in shards]
    out = _mace_body(params, cfg, species[lo:hi], positions,
                     None if node_feat is None else node_feat[lo:hi],
                     None if graph_ids is None else graph_ids[lo:hi],
                     n_graphs, edges, ec, exchange)
    if mesh is not None and grid.group is not None:
        out = {k: (Sum if k == "energy" else Concat).apply(
            v, mesh, peers) for k, v in out.items()}
    return out


def _split_sizes(n: int, e_total: int, dp_n: int, n_chunks: int):
    """(nodes a dp shard, edges a dp shard, edges a chunk)."""
    if n % dp_n or e_total % dp_n:
        raise ValueError(f"{n} nodes and {e_total} edges must split "
                         f"evenly over {dp_n} dp shards")
    n_loc, e_loc = n // dp_n, e_total // dp_n
    ec = max(e_loc // n_chunks, 1)
    if e_loc % ec:
        raise ValueError(f"{e_loc} edges a dp shard do not split into "
                         f"chunks of {ec}")
    return n_loc, e_loc, ec


def _exchange_dtype(cfg: MACEConfig) -> torch.dtype:
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg.exchange_dtype]


def _mace_body(params: dict, cfg: MACEConfig, species: torch.Tensor,
               positions: torch.Tensor, node_feat: Optional[torch.Tensor],
               graph_ids: Optional[torch.Tensor], n_graphs: int,
               edges: list, ec: int, exchange) -> dict:
    """The forward over the nodes this process holds (``species``,
    ``node_feat`` and ``graph_ids`` their rows; ``positions`` every
    node's): ``edges`` lists (dp index, nodes a shard, senders, receivers,
    mask) of each dp shard held, whose receivers fall in that shard's
    nodes (none with ``exchange`` None: one shard, all nodes);
    ``exchange(h)`` gives every node's features from the held ones."""
    dt = torch.promote_types(torch.promote_types(
        positions.dtype, params["species_embed"].dtype), torch.float32)

    # --- edge geometry (this process's edges) ------------------------------
    geo = []
    for di, n_loc, send, recv, mask in edges:
        rvec = (positions[send] - positions[recv]).to(dt)          # (E, 3)
        r = torch.linalg.norm(rvec + 1e-12, dim=-1)
        u = rvec / (r[:, None] + 1e-12)
        sph = real_sph_harm_l2(u)                                  # (E, 9)
        rbf = bessel_basis(r, cfg.n_rbf, cfg.r_cut)                # (E, n_rbf)
        if mask is not None:
            rbf = rbf * mask[:, None].to(dt)
        geo.append((di, n_loc, rbf, sph, send, recv - di * n_loc))

    # --- initial node features (l=0 only), the nodes this process holds --
    # the embedding rows by a one-hot product: its backward is a product
    # too, where a gather's would scatter 16 rows from every node
    emb = params["species_embed"]
    h0 = (species[:, None] == torch.arange(
        emb.shape[0], device=species.device)).to(emb.dtype) @ emb
    if node_feat is not None and "feat_proj" in params:
        h0 = h0 + node_feat @ params["feat_proj"]
    h = F.pad(h0.to(dt)[..., None], (0, M_TOT - 1))               # (n, C, M)

    def a_features(layer, h_):
        if exchange is None:
            (_, n_out, rbf_, sph_, send_, recv_), = geo
            return _scatter_messages(layer, cfg, h_, rbf_, sph_, send_,
                                     recv_, n_out, ec)
        h_full = exchange(h_)
        return torch.cat([_scatter_messages(layer, cfg, h_full, rbf_, sph_,
                                            send_, recv_, n_loc_, ec)
                          for _, n_loc_, rbf_, sph_, send_, recv_ in geo])

    for layer in params["layers"]:
        a_feat = a_features(layer, h)

        # higher-order ACE products (correlation order 3):
        # B = A + w2*AxA + w3*(AxA)xA
        b_feat = a_feat
        if cfg.correlation_order >= 2:
            a2 = _cg_product(a_feat, a_feat, layer["prod2_w"], cfg.l_max)
            b_feat = b_feat + a2
            if cfg.correlation_order >= 3:
                a3 = _cg_product(a2, a_feat, layer["prod3_w"], cfg.l_max)
                b_feat = b_feat + a3

        # message mixing + gated nonlinearity on invariants + residual
        m = _mix_per_l(b_feat, layer["mix_msg"], cfg.l_max)
        gate = torch.sigmoid(m[..., 0])[..., None]
        h = _mix_per_l(upcast(h), layer["mix_self"], cfg.l_max) + m * gate
        if cfg.exchange_dtype == "bfloat16":
            # store/exchange node features in bf16; per-edge math stays f32
            h = h.to(torch.bfloat16)

    node_inv = upcast(h[..., 0])                                  # (n, C)
    site_e = (F.silu(node_inv @ params["readout_w1"])
              @ params["readout_w2"])[:, 0]                       # (n,)
    if graph_ids is None:
        energy = torch.sum(site_e, dim=0, keepdim=True)
    else:
        energy = site_e.new_zeros((n_graphs,)).index_add_(
            0, graph_ids.long(), site_e)
    out = {"node_inv": node_inv, "energy": energy}
    if "cls_head" in params:
        out["node_logits"] = node_inv @ params["cls_head"]
    return out


def _mace_fwd_dtensor(params, cfg, species, positions, senders, receivers,
                      node_feat, edge_mask, graph_ids, n_graphs, axes,
                      n_edge_chunks):
    """``mace_fwd`` over a DeviceMesh (the reference's
    ``_a_features_sharded`` shard_map): the inputs are DTensors split
    over dp on their first axis (params replicated).  Each rank runs its
    dp shard's nodes and edges, every rank's positions gathered for the
    edge geometry; the exchange all-gathers ``h`` over the dp group
    (``AllGather``, its backward a reduce-scatter).  The node outputs come
    back split over dp, the energy summed over it; the gradients of the
    parameters and of the gathered positions are partial over dp (each
    shard's nodes and edges add theirs)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dm, dp = axes.mesh, tuple(axes.dp)
    n, e_total = species.shape[0], senders.shape[0]
    dp_n = math.prod(dm.size(dm.mesh_dim_names.index(a)) for a in dp)
    n_loc, _, ec = _split_sizes(n, e_total, dp_n, max(1, n_edge_chunks))
    di, _ = device_cell(dm, dp, axes.tp)

    def rows(t):
        if t is None:
            return None
        return constrain(t, P(dp, *([None] * (t.ndim - 1)))).to_local()

    # inputs every rank holds whole: each dp shard's edges add to their
    # gradients, partial over dp
    partial = mesh_placements(dm, dp, Partial(), Replicate())
    params = tree_map(lambda t: t.to_local(grad_placements=partial), params)
    pos_all = constrain(positions, P()).to_local(grad_placements=partial)
    dpm = axes_mesh(dm, dp)
    peers, ex_dtype = everyone(dpm), _exchange_dtype(cfg)

    def exchange(h_):
        return AllGather.apply(h_.to(ex_dtype), dpm, peers, 0,
                               False).to(h_.dtype)

    edges = [(di, n_loc, rows(senders), rows(receivers), rows(edge_mask))]
    out = _mace_body(params, cfg, rows(species), pos_all, rows(node_feat),
                     rows(graph_ids), n_graphs, edges, ec, exchange)

    def back(k, v):
        if k == "energy":
            pl = mesh_placements(dm, dp, Partial(), Replicate())
            shape = tuple(v.shape)
        else:
            pl = mesh_placements(dm, dp, Shard(0), Replicate())
            shape = (n,) + tuple(v.shape[1:])
        return DTensor.from_local(v, dm, pl, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))
    return {k: back(k, v) for k, v in out.items()}
