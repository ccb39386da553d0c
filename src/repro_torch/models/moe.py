"""Mixture-of-Experts FFN with sort-free scatter dispatch (top-k, capacity)
(port of ``repro/models/moe.py``).

Tokens are routed with a scatter to an (E, capacity + 1, D) buffer laid out
expert-major; slot ``capacity`` of each expert is the drop slot, which
takes every token past the expert's capacity and never reaches an output
or a gradient (``torch.where(keep, ...)``).  Position-in-expert is a stable
argsort of the expert ids, a ``searchsorted`` and an inverse permutation,
so it equals the reference's exactly; the top-k keeps the lower expert id
among equal probabilities, as ``jax.lax.top_k`` does (a stable descending
sort).  Nothing selects tokens with a boolean mask, so a layer makes no
host sync.  The expert products are ``torch.bmm`` over the expert axis on
all ``capacity + 1`` slots, as the reference's einsums run on them.

The expert-parallel paths (``moe_fwd_sharded``: each tp cell runs its
E / tp experts over its dp shard's tokens and a psum over tp combines;
``moe_fwd_a2a``: top-1 buckets exchanged by two all-to-alls) run over the
port's ``core.sharded_index.Mesh``.  Without a process group every cell
runs in this process in turn: the psum is a sum of the cells' partials,
the all-to-alls an exchange of bucket rows between the cells of one dp
row, the fsdp weight gather a concatenation of the dp shards.  With a
group each rank holds one cell; every rank passes the same ``x`` and
``params`` and gets the group-less mesh's output, aux loss and gradients.
The collectives run over the whole group (a rank's chunk for a rank
outside its dp row or tp column is empty or zero): the psum an
``all_reduce``, the all-to-alls ``all_to_all_single``, the weight gathers
``all_gather_into_tensor``, their backward ``reduce_scatter_tensor``; the
gradients of the cells' replicated inputs are summed over the group in
the backward, as the reference's replicated inputs are.  Each collective
is a ``torch.autograd.Function`` whose backward is its transpose: the
psum's passes each cell's partial the cotangent unchanged.  The grid, the
gathers and the sums are ``models/collectives.py``'s, shared with MACE;
the all-to-all is this module's.

``make_quantized_all_gather`` is the reference's ``custom_vjp``: an int8
gather of the weights with per-(expert, column) scales, whose backward is
the straight-through transpose (a reduce-scatter of the cotangent).
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from repro_torch.device import resolve_device
from repro_torch.models.collectives import (AllGather, Grid, Sum, SumGrads,
                                            axes_mesh, dequantize,
                                            device_cell, everyone,
                                            mesh_placements, peer_cells,
                                            quantize)
from repro_torch.models.layers import (Axes, P, constrain, contiguous_stride,
                                       is_device_mesh, normal, upcast)


def init_moe(generator: torch.Generator | None, d_model: int, d_ff: int,
             n_experts: int, dtype: torch.dtype, shared_expert: bool,
             device: torch.device | str | None = None,
             lead: tuple[int, ...] = ()) -> dict:
    """The layer's parameters drawn from ``generator`` on ``device`` (the
    GPU unless ``device="cpu"``; ``"meta"`` allocates nothing; ``lead``
    stacks them, as the transformer's layers are stacked): the router f32
    N(0, 1/d_model), experts and shared expert N(0, 1/d_in) in
    ``dtype``."""
    dev = torch.device("meta") if device is not None and torch.device(
        device).type == "meta" else resolve_device(device)
    p = {
        "router": _draw(generator, lead + (d_model, n_experts),
                        1.0 / math.sqrt(d_model), torch.float32, dev),
        "w_gate": _expert_init(generator, n_experts, d_model, d_ff, dtype,
                               dev, lead),
        "w_up": _expert_init(generator, n_experts, d_model, d_ff, dtype,
                             dev, lead),
        "w_down": _expert_init(generator, n_experts, d_ff, d_model, dtype,
                               dev, lead),
    }
    if shared_expert:
        p["shared"] = {
            "w_gate": _draw(generator, lead + (d_model, d_ff),
                            1.0 / math.sqrt(d_model), dtype, dev),
            "w_up": _draw(generator, lead + (d_model, d_ff),
                          1.0 / math.sqrt(d_model), dtype, dev),
            "w_down": _draw(generator, lead + (d_ff, d_model),
                            1.0 / math.sqrt(d_ff), dtype, dev),
        }
    return p


def _expert_init(generator, e, d_in, d_out, dtype, device: torch.device,
                 lead: tuple[int, ...] = ()) -> torch.Tensor:
    return _draw(generator, lead + (e, d_in, d_out), 1.0 / math.sqrt(d_in),
                 dtype, device)


# f32 draws of at most this many elements at a time (1 GiB): llama4's
# experts are three (2, 128, 5120, 8192) leaves, whose whole f32 draw would
# be a 21.5 GB transient beside the bf16 parameters
_DRAW_CHUNK = 1 << 28


def _draw(generator, shape: tuple[int, ...], scale: float,
          dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, scale^2) of ``shape`` in ``dtype``, drawn in f32 one slab of
    leading rows at a time and cast before the next is drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if device.type == "meta":
        return out
    flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out.view(1,
                                                                     *shape)
    per = max(1, _DRAW_CHUNK // (flat[0].numel() or 1))
    for lo in range(0, flat.shape[0], per):
        part = flat[lo:lo + per]
        part.copy_(normal(generator, tuple(part.shape), device).mul_(scale))
    return out


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def moe_specs(axes: Axes, shared_expert: bool, fsdp: bool = False,
              expert_fsdp: int = -1) -> dict:
    """Spec tree of ``init_moe``'s output (the reference's): experts split
    over tp on the expert axis (expert parallelism), the router
    replicated.  ``expert_fsdp``: -1 follows ``fsdp``; 0 keeps expert
    weights tp-split only, 1 also splits their d_in over dp."""
    tp = axes.tp
    fs = tuple(axes.dp) if fsdp else None
    efs = fs if expert_fsdp == -1 else (
        tuple(axes.dp) if expert_fsdp else None)
    p = {
        "router": P(None, None),
        "w_gate": P(tp, efs, None),
        "w_up": P(tp, efs, None),
        "w_down": P(tp, efs, None),
    }
    if shared_expert:
        p["shared"] = {"w_gate": P(fs, tp), "w_up": P(fs, tp),
                       "w_down": P(tp, fs)}
    return p


def _position_in_expert(expert_ids: torch.Tensor, n_experts: int
                        ) -> torch.Tensor:
    """Rank of each routed slot among slots sent to the same expert.

    expert_ids: (M,) int.  A stable argsort groups same-expert slots;
    position = index within group, scattered back to the original slot
    order.
    """
    m = expert_ids.shape[0]
    ids = expert_ids.long()
    order = torch.argsort(ids, stable=True)
    sorted_e = ids[order]
    start = torch.searchsorted(sorted_e, torch.arange(
        n_experts, dtype=torch.long, device=ids.device))
    pos_sorted = torch.arange(m, dtype=torch.long,
                              device=ids.device) - start[sorted_e]
    return torch.empty_like(pos_sorted).index_put_((order,), pos_sorted)


def _top_k(probs: torch.Tensor, k: int):
    """(values, ids) of each row's ``k`` largest, the lower id first among
    equal values (``jax.lax.top_k``'s order)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """(probs, gate, sel): the router's f32 softmax over (T, E) and each
    token's ``top_k`` probabilities and experts."""
    logits = upcast(x) @ upcast(router)
    probs = torch.softmax(logits, dim=-1)
    gate, sel = _top_k(probs, top_k)
    return probs, gate, sel


def _aux(probs: torch.Tensor, first: torch.Tensor, n_experts: int
         ) -> torch.Tensor:
    """The switch-style load-balance loss: E * sum(density * mean(probs)),
    density the share of tokens whose first choice is each expert (no
    gradient)."""
    density = torch.mean(F.one_hot(first, n_experts).to(probs.dtype), dim=0)
    return n_experts * torch.sum(density * torch.mean(probs, dim=0))


def _experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor) -> torch.Tensor:
    """(E, C, D) -> (E, C, D): each expert's SwiGLU on its slots."""
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def _ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def _pad_row_slot(y: torch.Tensor) -> torch.Tensor:
    """(E, C, D) -> (E + 1, C + 1, D), zeros in the new row and slot."""
    return F.pad(y, (0, 0, 0, 1, 0, 1))


def moe_fwd(params: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float, axes: Axes | None = None):
    """x: (T, D) token-major. Returns (out (T, D), aux_loss scalar)."""
    t, d = x.shape
    cap = int(max(top_k * capacity_factor * t / n_experts, 4))

    probs, gate, sel = _route(x, params["router"], top_k)      # (T, k)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)        # renormalize
    aux = _aux(probs, sel[:, 0], n_experts)

    # ---- scatter dispatch: (E, cap + 1, D), slot ``cap`` the drop slot
    flat_e = sel.reshape(-1)                                   # (T*k,)
    pos = _position_in_expert(flat_e, n_experts)
    keep = pos < cap
    slot = torch.where(keep, pos, cap)
    x_rep = torch.repeat_interleave(x, top_k, dim=0)           # (T*k, D)

    def _c(a):
        return a if axes is None else constrain(a, P(axes.tp, None, None))

    buf = _c(_c(x.new_zeros((n_experts, cap + 1, d))).index_put(
        (flat_e, slot), x_rep))

    y = _c(_experts(buf, params["w_gate"], params["w_up"], params["w_down"]))

    # ---- combine: the drop slot's rows never reach the output
    out_rep = y[flat_e, slot] * gate.reshape(-1, 1).to(y.dtype)
    out_rep = torch.where(keep[:, None], out_rep, 0.0)
    out = torch.sum(out_rep.reshape(t, top_k, d), dim=1)

    out = out.to(x.dtype)   # gate is f32; don't promote the residual
    if "shared" in params:
        out = out + _ffn(params["shared"], x)
    return out, aux


# ---------------------------------------------------------------------------
# the mesh's all-to-all
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """Row ``j`` of ``t`` (len(peers), ...) to rank ``peers[j]``, row ``j``
    of the result from it (``all_to_all_single``, empty splits to every
    other rank).  Its own transpose: the backward exchanges the cotangent
    the same way."""

    @staticmethod
    def forward(ctx, t, mesh, peers):
        ctx.mesh, ctx.peers = mesh, peers
        return _exchange(t, mesh, peers)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, ctx.peers), None, None


def _exchange(t: torch.Tensor, mesh, peers: list[int]) -> torch.Tensor:
    import torch.distributed as dist
    order = sorted(range(len(peers)), key=lambda j: peers[j])  # rank order
    rows = t.reshape(t.shape[0], -1)[order].contiguous()
    splits = [int(r in peers) for r in range(mesh.world)]
    got = torch.empty_like(rows)
    dist.all_to_all_single(got, rows, splits, splits, group=mesh.group)
    out = torch.empty_like(got)
    out[order] = got
    return out.reshape(t.shape)


class _QuantizedConcat(torch.autograd.Function):
    """The group-less quantized gather: each shard quantized on its own,
    dequantized and concatenated along ``axis``; the backward hands each
    shard its slice of the cotangent (straight through)."""

    @staticmethod
    def forward(ctx, axis, *shards):
        ctx.axis, ctx.sizes = axis, [s.shape[axis] for s in shards]
        return torch.cat([dequantize(*quantize(s, axis), s.dtype)
                          for s in shards], dim=axis)

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(torch.split(g, ctx.sizes, dim=ctx.axis))


def make_quantized_all_gather(axis_names, axis: int, mesh=None):
    """int8-compressed weight all-gather over the mesh axes ``axis_names``
    (forward) with the exact transpose of the gather (backward).

    Each shard is quantized to int8 with per-(expert, column) scales
    ``max|w| / 127 + 1e-12`` over ``axis``, gathered, dequantized and
    concatenated along ``axis``; the backward is a reduce-scatter of the
    cotangent (quantization treated as identity).  Without a group
    (``mesh`` None or group-less) the process holds every shard, so the
    returned ``qag`` takes them all, a sequence in gather order; with one,
    ``qag`` takes this rank's shard and gathers those of the ranks whose
    cells differ from its own only on ``axis_names``.
    """
    if mesh is None or mesh.group is None:
        def qag(shards):
            return _QuantizedConcat.apply(axis, *shards)
        return qag
    peers = peer_cells(mesh, mesh.rank, tuple(axis_names))

    def qag_group(w_loc):
        return AllGather.apply(w_loc, mesh, peers, axis, True)
    return qag_group


def _expert_weights(grid: Grid, w: torch.Tensor, di: int, ti: int,
                    e_local: int, fsdp: bool, quant: bool) -> torch.Tensor:
    """Cell (di, ti)'s experts of ``w`` (E, d_in, d_out): the tp shard of
    E / tp experts, under ``fsdp`` gathered over dp from each dp cell's
    d_in / dp rows (int8 under ``quant``)."""
    block = w[ti * e_local:(ti + 1) * e_local]
    if not fsdp:
        return block
    rows = block.shape[1] // grid.dp_n
    if grid.group is None:
        if not quant:   # the dp shards concatenated are the block
            return block
        return make_quantized_all_gather(grid.dp, 1)(
            torch.split(block, rows, dim=1))
    shard = block[:, di * rows:(di + 1) * rows]
    if quant:
        return make_quantized_all_gather(grid.dp, 1, grid.mesh)(shard)
    return AllGather.apply(shard, grid.mesh,
                           peer_cells(grid.mesh, grid.mesh.rank, grid.dp), 1,
                           False)


def _replicated(grid: Grid, *tensors):
    """With a group, the cells' copies of inputs every rank holds: their
    gradients are summed over the group in the backward."""
    if grid.group is None:
        return tensors
    return tuple(SumGrads.apply(t, grid.mesh, everyone(grid.mesh))
                 for t in tensors)


def _mean_aux(grid: Grid, auxes: list[torch.Tensor]) -> torch.Tensor:
    """The mean over every cell of the mesh of each cell's aux."""
    if grid.group is None:
        return torch.mean(torch.stack(auxes))
    return Sum.apply(torch.stack(auxes).sum(), grid.mesh,
                     everyone(grid.mesh)) \
        / grid.mesh.n_cells


def _combine(grid: Grid, parts: dict[int, torch.Tensor], n_chunks: int
             ) -> torch.Tensor:
    """(T, D) from the row chunks ``parts`` (chunk index -> rows, ``n_chunks``
    chunks of equal size): without a group they are every chunk,
    concatenated; with one, this rank's chunks in place in zeros, summed
    over the group (the reference's psum over tp, then its output's
    gather)."""
    if grid.group is None:
        return torch.cat([parts[c] for c in sorted(parts)])
    first = next(iter(parts.values()))
    n = first.shape[0]
    full = first.new_zeros((n_chunks * n,) + tuple(first.shape[1:]))
    for c, part in parts.items():
        full = full.index_copy(0, torch.arange(c * n, (c + 1) * n,
                                               device=part.device), part)
    return Sum.apply(full, grid.mesh, everyone(grid.mesh))


# ---------------------------------------------------------------------------
# expert-parallel dispatch: the psum-combine path
# ---------------------------------------------------------------------------


def moe_fwd_sharded(params: dict, x: torch.Tensor, *, n_experts: int,
                    top_k: int, capacity_factor: float, axes: Axes,
                    fsdp: bool = False, expert_fsdp: int = -1,
                    gather_quant: bool = False):
    """x: (T, D) token-major, its rows split over dp. Requires axes.mesh.

    Cell (di, ti) routes dp shard di's tokens, keeps the (token, slot)
    pairs owned by its E / tp experts (the others go to a sentinel
    bucket), runs its experts at a capacity per (dp shard, expert), and
    the tp cells' partial outputs are summed."""
    e_fsdp = fsdp if expert_fsdp == -1 else bool(expert_fsdp)
    if is_device_mesh(axes.mesh):
        return _moe_fwd_sharded_dtensor(
            params, x, n_experts=n_experts, top_k=top_k,
            capacity_factor=capacity_factor, axes=axes, e_fsdp=e_fsdp,
            gather_quant=gather_quant)
    t, d = x.shape
    grid = Grid(axes.mesh, axes.dp, axes.tp)
    dp_n, tp_n = grid.dp_n, grid.tp_n
    t_local = t // dp_n
    e_local = n_experts // tp_n
    cap = int(max(capacity_factor * top_k * t_local / n_experts, 4))
    xs, router, wg, wu, wd = _replicated(
        grid, x, params["router"], params["w_gate"], params["w_up"],
        params["w_down"])

    partials, auxes = {}, []
    for di, ti in grid.local:
        ws = [_expert_weights(grid, w, di, ti, e_local, e_fsdp, gather_quant)
              for w in (wg, wu, wd)]
        x_loc = xs[di * t_local:(di + 1) * t_local]
        part, aux = _sharded_cell(x_loc, router, *ws, e0=ti * e_local,
                                  e_local=e_local, n_experts=n_experts,
                                  top_k=top_k, cap=cap)
        auxes.append(aux)
        # the psum over tp: the tp cells' partials in tp order
        partials[di] = part if di not in partials else partials[di] + part
    out = _combine(grid, partials, dp_n)
    out = out.to(x.dtype)
    if "shared" in params:
        out = out + _ffn(params["shared"], x)
    return out, _mean_aux(grid, auxes)


def _sharded_cell(x_loc, router, wg, wu, wd, *, e0: int, e_local: int,
                  n_experts: int, top_k: int, cap: int):
    """One (dp, tp) cell of ``moe_fwd_sharded``: (partial (T_loc, D),
    aux)."""
    t_local, d = x_loc.shape
    probs, gate, sel = _route(x_loc, router, top_k)           # (T_loc, k)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    aux = _aux(probs, sel[:, 0], n_experts)

    flat_e = sel.reshape(-1)                                  # (T_loc*k,)
    mine = (flat_e >= e0) & (flat_e < e0 + e_local)
    eloc = torch.where(mine, flat_e - e0, e_local)            # sentinel
    pos = _position_in_expert(eloc, e_local + 1)
    keep = mine & (pos < cap)
    slot = torch.where(keep, pos, cap)
    erow = torch.where(keep, eloc, e_local)
    x_rep = torch.repeat_interleave(x_loc, top_k, dim=0)

    buf = x_loc.new_zeros((e_local + 1, cap + 1, d)).index_put(
        (erow, slot), x_rep)[:e_local, :cap]                  # LOCAL scatter
    y = _experts(buf, wg, wu, wd)                             # (E_loc, cap, D)

    out_rep = _pad_row_slot(y)[erow, slot] * gate.reshape(-1, 1).to(y.dtype)
    out_rep = torch.where(keep[:, None], out_rep, 0.0)
    return torch.sum(out_rep.reshape(t_local, top_k, d), dim=1), aux


# ---------------------------------------------------------------------------
# expert-parallel dispatch: top-1 through two all-to-alls
# ---------------------------------------------------------------------------


def moe_fwd_a2a(params: dict, x: torch.Tensor, *, n_experts: int,
                capacity_factor: float, axes: Axes, fsdp: bool = False,
                gather_quant: bool = False):
    """Top-1 expert-parallel dispatch through all-to-alls.

    Tokens are split over dp and tp (cell c = di * tp + ti takes chunk c);
    each cell routes its T / (dp * tp) tokens, buckets them by destination
    tp cell (capacity per destination), exchanges buckets with one
    all-to-all over its dp row, runs its experts (capacity per expert),
    and a second all-to-all returns the outputs to the tokens' owners."""
    if is_device_mesh(axes.mesh):
        return _moe_fwd_a2a_dtensor(
            params, x, n_experts=n_experts, capacity_factor=capacity_factor,
            axes=axes, fsdp=fsdp, gather_quant=gather_quant)
    grid = Grid(axes.mesh, axes.dp, axes.tp)
    tp_n = grid.tp_n
    t_cell, e_local, cap_d, cap_e = _a2a_sizes(
        x.shape[0], grid.dp_n, tp_n, n_experts, capacity_factor)
    xs, router, wg, wu, wd = _replicated(
        grid, x, params["router"], params["w_gate"], params["w_up"],
        params["w_down"])

    # 1. route and bucket by destination tp cell
    state, sends, auxes = {}, {}, []
    for di, ti in grid.local:
        c = di * tp_n + ti
        send, send_e, state[(di, ti)], aux = _a2a_buckets(
            xs[c * t_cell:(c + 1) * t_cell], router, n_experts=n_experts,
            e_local=e_local, tp_n=tp_n, cap_d=cap_d)
        auxes.append(aux)
        sends[(di, ti)] = (send, send_e)

    # 2. one all-to-all each way over the dp row
    recvs = _all_to_all(grid, sends)
    backs = {}
    for (di, ti), (recv, recv_e) in recvs.items():
        ws = [_expert_weights(grid, w, di, ti, e_local, fsdp, gather_quant)
              for w in (wg, wu, wd)]
        backs[(di, ti)] = (_a2a_experts(recv, recv_e, ws, e_local=e_local,
                                        cap_e=cap_e),)
    backs = _all_to_all(grid, backs)

    # 3. the outputs back at their tokens (top-1: the gate is 1)
    outs = {k[0] * tp_n + k[1]: _a2a_unbucket(back, *state[k])
            for k, (back,) in backs.items()}
    out = _combine(grid, outs, grid.dp_n * tp_n).to(x.dtype)
    if "shared" in params:
        out = out + _ffn(params["shared"], x)
    return out, _mean_aux(grid, auxes)


def _a2a_sizes(t: int, dp_n: int, tp_n: int, n_experts: int,
               capacity_factor: float) -> tuple[int, int, int, int]:
    """(tokens a cell, experts a tp cell, slots a destination, rows an
    expert) of ``moe_fwd_a2a``."""
    t_cell = t // (dp_n * tp_n)
    e_local = n_experts // tp_n
    cap_d = int(max(capacity_factor * t_cell / tp_n, 4))
    cap_e = int(max(capacity_factor * t_cell / e_local, 4))
    return t_cell, e_local, cap_d, cap_e


def _a2a_buckets(x_loc, router, *, n_experts: int, e_local: int, tp_n: int,
                 cap_d: int):
    """One cell's tokens routed top-1 and bucketed by destination tp cell:
    (rows (tp, cap_d, D), their local expert ids (tp, cap_d), ``e_local``
    in an empty slot, (keep, row, slot) that put the outputs back, aux)."""
    d = x_loc.shape[1]
    probs, _, sel = _route(x_loc, router, 1)
    sel = sel[:, 0]                                           # (Tc,)
    aux = _aux(probs, sel, n_experts)
    dest = torch.div(sel, e_local, rounding_mode="floor")
    pos = _position_in_expert(dest, tp_n)
    keep = pos < cap_d
    slot = torch.where(keep, pos, cap_d)
    row = torch.where(keep, dest, tp_n)
    send = x_loc.new_zeros((tp_n + 1, cap_d + 1, d)).index_put(
        (row, slot), x_loc)[:tp_n, :cap_d]
    send_e = torch.full((tp_n + 1, cap_d + 1), e_local, dtype=torch.int32,
                        device=x_loc.device).index_put(
        (row, slot), (sel % e_local).to(torch.int32))[:tp_n, :cap_d]
    return send, send_e, (keep, row, slot), aux


def _a2a_experts(recv, recv_e, ws, *, e_local: int, cap_e: int):
    """The received rows (tp, cap_d, D) through this cell's experts
    (``cap_e`` rows an expert): their outputs, zero where dropped or
    empty."""
    tp_n, cap_d, d = recv.shape
    rflat = recv.reshape(tp_n * cap_d, d)
    eflat = recv_e.reshape(tp_n * cap_d)                      # e_local = pad
    pos_e = _position_in_expert(eflat, e_local + 1)
    keep_e = (eflat < e_local) & (pos_e < cap_e)
    erow = torch.where(keep_e, eflat.long(), e_local)
    eslot = torch.where(keep_e, pos_e, cap_e)
    buf = rflat.new_zeros((e_local + 1, cap_e + 1, d)).index_put(
        (erow, eslot), rflat)[:e_local, :cap_e]
    y = _experts(buf, *ws)                                    # (E_loc,cap_e,D)
    y_slots = torch.where(keep_e[:, None], _pad_row_slot(y)[erow, eslot],
                          0.0)
    return y_slots.reshape(tp_n, cap_d, d)


def _a2a_unbucket(back, keep, row, slot):
    """The returned outputs (tp, cap_d, D) at their tokens (top-1: the
    gate is 1), zero for a dropped token."""
    return torch.where(keep[:, None], _pad_row_slot(back)[row, slot], 0.0)


def _all_to_all(grid: Grid, sends: dict) -> dict:
    """Each local cell's tensors (tp, ...): row j to the cell of tp index j
    in its dp row; row j of the result from that cell."""
    if grid.group is None:
        return {(di, ti): tuple(torch.stack([sends[(di, tj)][n][ti]
                                             for tj in range(grid.tp_n)])
                                for n in range(len(sends[(di, ti)])))
                for di, ti in sends}
    peers = peer_cells(grid.mesh, grid.mesh.rank, (grid.tp,))
    return {k: tuple(_AllToAll.apply(t, grid.mesh, peers) for t in ts)
            for k, ts in sends.items()}


# ---------------------------------------------------------------------------
# the expert-parallel paths on a DeviceMesh: the reference's shard_maps
# ---------------------------------------------------------------------------
#
# The tokens and weights are DTensors.  Each rank takes its local shards
# (``to_local``, naming the placement of each one's gradient: partial over
# the axes whose cells share an input and add to its gradient), runs its
# (dp, tp) cell as the group-less path runs it, and hands its outputs back
# as DTensors whose pending sums (the psum over tp, the aux's mean) DTensor
# reduces.  The fsdp weight gathers are DTensor redistributions, or the
# int8 ``AllGather`` over the dp group under ``gather_quant``; the
# all-to-alls are ``_AllToAll`` over the tp group.


def _dt(t, dm, pl, shape):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, dm, pl, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def _local_experts(w, axes: Axes, efs, gather_quant: bool):
    """This cell's experts of the DTensor ``w`` (E, d_in, d_out), split
    over tp on E (and over dp on d_in under ``efs``): (E / tp, d_in,
    d_out), gathered over dp where split there."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm = axes.mesh
    w = constrain(w, P(axes.tp, efs, None))
    if efs is None:
        return w.to_local(grad_placements=mesh_placements(
            dm, axes.dp, Partial(), Shard(0)))
    if gather_quant:
        dpm = axes_mesh(dm, axes.dp)
        return AllGather.apply(w.to_local(), dpm, everyone(dpm), 1, True)
    return w.redistribute(dm, mesh_placements(dm, axes.dp, Replicate(),
                                              Shard(0))).to_local(
        grad_placements=mesh_placements(dm, axes.dp, Partial(), Shard(0)))


def _mesh_aux(aux: torch.Tensor, dm) -> torch.Tensor:
    """The mean over every cell of each cell's aux."""
    from torch.distributed.tensor import Partial
    n = math.prod(dm.shape)
    return _dt(aux, dm, [Partial()] * dm.ndim, ()) / n


def _moe_fwd_sharded_dtensor(params, x, *, n_experts, top_k,
                             capacity_factor, axes: Axes, e_fsdp: bool,
                             gather_quant: bool):
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm, dp = axes.mesh, tuple(axes.dp)
    t, d = x.shape
    dp_n = math.prod(dm.size(dm.mesh_dim_names.index(a)) for a in dp)
    tp_n = dm.size(dm.mesh_dim_names.index(axes.tp))
    t_local = t // dp_n
    e_local = n_experts // tp_n
    cap = int(max(capacity_factor * top_k * t_local / n_experts, 4))
    _, ti = device_cell(dm, dp, axes.tp)
    x = constrain(x, P(dp, None))
    x_loc = x.to_local(grad_placements=mesh_placements(
        dm, dp, Shard(0), Partial()))
    router = constrain(params["router"], P(None, None)).to_local(
        grad_placements=[Partial()] * dm.ndim)
    efs = dp if e_fsdp else None
    ws = [_local_experts(params[k], axes, efs, gather_quant)
          for k in ("w_gate", "w_up", "w_down")]
    part, aux = _sharded_cell(x_loc, router, *ws, e0=ti * e_local,
                              e_local=e_local, n_experts=n_experts,
                              top_k=top_k, cap=cap)
    out = _dt(part, dm, mesh_placements(dm, dp, Shard(0), Partial()),
              tuple(x.shape))
    out = out.redistribute(dm, mesh_placements(dm, dp, Shard(0),
                                               Replicate()))
    out = out.to(x.dtype)
    if "shared" in params:
        out = out + _ffn(params["shared"], x)
    return out, _mesh_aux(aux, dm)


def _moe_fwd_a2a_dtensor(params, x, *, n_experts, capacity_factor,
                         axes: Axes, fsdp: bool, gather_quant: bool):
    from torch.distributed.tensor import Partial
    dm, dp = axes.mesh, tuple(axes.dp)
    dp_n = math.prod(dm.size(dm.mesh_dim_names.index(a)) for a in dp)
    tp_n = dm.size(dm.mesh_dim_names.index(axes.tp))
    _, e_local, cap_d, cap_e = _a2a_sizes(x.shape[0], dp_n, tp_n, n_experts,
                                          capacity_factor)
    x = constrain(x, P(dp + (axes.tp,), None))
    x_loc = x.to_local(grad_placements=x.placements)
    router = constrain(params["router"], P(None, None)).to_local(
        grad_placements=[Partial()] * dm.ndim)
    ws = [_local_experts(params[k], axes, dp if fsdp else None,
                         gather_quant)
          for k in ("w_gate", "w_up", "w_down")]
    tpm = axes_mesh(dm, (axes.tp,))
    peers = everyone(tpm)

    send, send_e, state, aux = _a2a_buckets(
        x_loc, router, n_experts=n_experts, e_local=e_local, tp_n=tp_n,
        cap_d=cap_d)
    recv = _AllToAll.apply(send, tpm, peers)
    recv_e = _AllToAll.apply(send_e, tpm, peers)
    back = _AllToAll.apply(_a2a_experts(recv, recv_e, ws, e_local=e_local,
                                        cap_e=cap_e), tpm, peers)
    out = _dt(_a2a_unbucket(back, *state), dm, x.placements,
              tuple(x.shape)).to(x.dtype)
    if "shared" in params:
        out = out + _ffn(params["shared"], x)
    return out, _mesh_aux(aux, dm)
