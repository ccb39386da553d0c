"""The mesh layers' cells and collectives: what ``models/moe.py``'s
expert-parallel paths and ``models/mace.py``'s sharded message passing
share over the port's ``core.sharded_index.Mesh``.

``Grid`` lays a mesh out as (dp, tp) cells and lists those this process
holds: every cell without a process group, this rank's one with a group.
With a group the collectives run over the whole group, a rank's chunk
for a rank outside the peers being empty or zero.  ``torch.distributed``
collectives carry no gradient of their own, so each is a
``torch.autograd.Function`` whose backward is its transpose:

- ``AllGather``: the peers' shards concatenated (``all_gather_into_tensor``,
  int8 with per-column scales under ``quant``); backward the reduce-scatter
  of the cotangent.
- ``Sum``: the sum over the peers; backward the cotangent unchanged, since
  every rank holds the same loss of the sum.
- ``SumGrads``: the identity; backward the cotangent summed over the peers,
  the gradient of an input every peer holds a copy of.
- ``Concat``: the peers' shards concatenated on dim 0; backward this
  rank's rows of the cotangent (every rank holds the same loss of the
  whole).

On a ``DeviceMesh`` (a cell program's DTensors) a layer runs the same
cells one rank a cell: ``device_cell`` is this rank's (dp, tp) cell, and
``axes_mesh`` a ``core.sharded_index.Mesh`` over the process group of the
ranks that differ from this one only on the named axes, which the
collectives above take as their whole group.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


class Grid:
    """The (dp, tp) layout of ``mesh``: ``local`` lists the cells this
    process holds (every cell, or with a group this rank's one) as (dp
    index, the ``dp`` axes raveled in their order; tp index)."""

    def __init__(self, mesh, dp: Sequence[str], tp: str):
        dp = tuple(dp)
        if sorted(dp + (tp,)) != sorted(mesh.axis_names):
            raise ValueError(f"dp axes {dp} + tp axis {tp!r} must name each "
                             f"axis of mesh {mesh.axis_names} once")
        if mesh.group is not None and mesh.world != mesh.n_cells:
            raise ValueError(
                f"a mesh layer takes one rank a cell: {mesh.world} ranks "
                f"for the {mesh.n_cells} cells of mesh "
                f"{tuple(mesh.shape.values())}")
        self.mesh, self.group, self.dp, self.tp = mesh, mesh.group, dp, tp
        self.dp_n = math.prod(mesh.shape[a] for a in dp)
        self.tp_n = mesh.shape[tp]
        sizes = [mesh.shape[a] for a in mesh.axis_names]
        self.local = []
        for flat in mesh.local_cells():
            c = dict(zip(mesh.axis_names, np.unravel_index(flat, sizes)))
            di = int(np.ravel_multi_index([c[a] for a in dp],
                                          [mesh.shape[a] for a in dp])) \
                if dp else 0
            self.local.append((di, int(c[tp])))


def peer_cells(mesh, cell: int, axes: tuple[str, ...]) -> list[int]:
    """Flat cells that share ``cell``'s coordinates off ``axes``, raveled
    over ``axes`` in their order."""
    sizes = [mesh.shape[a] for a in mesh.axis_names]
    mine = dict(zip(mesh.axis_names, np.unravel_index(cell, sizes)))
    out = []
    for idx in np.ndindex(*[mesh.shape[a] for a in axes]):
        c = dict(mine, **dict(zip(axes, idx)))
        out.append(int(np.ravel_multi_index([c[a] for a in mesh.axis_names],
                                            sizes)))
    return out


def everyone(mesh) -> list[int]:
    """Every rank of the mesh's group, in rank order."""
    return list(range(mesh.world))


def gather_over_group(t: torch.Tensor, mesh) -> torch.Tensor:
    """(world, *t.shape): every rank's ``t``, in rank order."""
    import torch.distributed as dist
    t = t.contiguous()
    out = t.new_empty((mesh.world * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=mesh.group)
    return out.view((mesh.world,) + tuple(t.shape))


def _sum(t: torch.Tensor, mesh, ranks: list[int]) -> torch.Tensor:
    """The sum of ``t`` over ``ranks``: an ``all_reduce`` where they are
    the whole group, else every rank's ``t`` gathered and summed in their
    order."""
    if sorted(ranks) == everyone(mesh):
        import torch.distributed as dist
        out = t.contiguous().clone()
        dist.all_reduce(out, group=mesh.group)
        return out
    every = gather_over_group(t, mesh)
    out = every[ranks[0]]
    for r in ranks[1:]:
        out = out + every[r]
    return out


def quantize(w: torch.Tensor, axis: int):
    """int8 of ``w`` and its scales max|w| / 127 + 1e-12 over ``axis``
    (one per (expert, column))."""
    scale = torch.amax(torch.abs(w), dim=axis, keepdim=True) / 127.0
    scale = scale + 1e-12
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype
               ) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


class AllGather(torch.autograd.Function):
    """The shards of ranks ``peers`` concatenated along ``dim`` (forward:
    ``all_gather_into_tensor``) and the reduce-scatter of the cotangent
    (backward: this rank's slice summed over ``peers``).  Under ``quant``
    each shard travels as int8 with its per-column scales and is
    dequantized after the gather; the backward goes straight through the
    quantization."""

    @staticmethod
    def forward(ctx, shard, mesh, peers, dim, quant):
        ctx.mesh, ctx.peers, ctx.dim = mesh, peers, dim
        if quant:
            q, scale = quantize(shard, dim)
            qs = gather_over_group(q, mesh)
            ss = gather_over_group(scale, mesh)
            parts = [dequantize(qs[r], ss[r], shard.dtype) for r in peers]
        else:
            every = gather_over_group(shard, mesh)
            parts = [every[r] for r in peers]
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        mesh, peers = ctx.mesh, ctx.peers
        parts = torch.chunk(g, len(peers), dim=ctx.dim)
        zero = torch.zeros_like(parts[0])
        send = torch.cat([parts[peers.index(r)] if r in peers else zero
                          for r in range(mesh.world)]).contiguous()
        out = torch.empty_like(zero)
        dist.reduce_scatter_tensor(out, send, group=mesh.group)
        return out, None, None, None, None


class Sum(torch.autograd.Function):
    """Forward: the sum over ``peers``.  Backward: the cotangent
    unchanged, since every rank holds the same loss of the sum."""

    @staticmethod
    def forward(ctx, t, mesh, peers):
        return _sum(t, mesh, peers)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class SumGrads(torch.autograd.Function):
    """Forward: the identity.  Backward: the cotangent summed over
    ``peers``, the gradient of an input every peer holds a copy of and
    uses for its own cell."""

    @staticmethod
    def forward(ctx, t, mesh, peers):
        ctx.mesh, ctx.peers = mesh, peers
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.mesh, ctx.peers), None, None


class Concat(torch.autograd.Function):
    """Forward: the shards of ``peers`` concatenated on dim 0.  Backward:
    this rank's rows of the cotangent (every rank holds the same loss of
    the whole)."""

    @staticmethod
    def forward(ctx, t, mesh, peers):
        ctx.lo = peers.index(mesh.rank) * t.shape[0]
        ctx.n = t.shape[0]
        every = gather_over_group(t, mesh)
        return torch.cat([every[r] for r in peers])

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo:ctx.lo + ctx.n], None, None


def device_cell(dm, dp: Sequence[str], tp: str) -> tuple[int, int]:
    """This rank's cell of the DeviceMesh ``dm``: (dp index, the ``dp``
    axes raveled in their order; tp index), as ``Grid.local`` lists it."""
    names = tuple(dm.mesh_dim_names)
    coord = dm.get_coordinate()
    sizes = dict(zip(names, dm.shape))
    di = 0
    for a in dp:
        di = di * sizes[a] + coord[names.index(a)]
    return di, coord[names.index(tp)]


def axes_mesh(dm, names: Sequence[str]):
    """A one-axis ``core.sharded_index.Mesh`` over the group of ``dm``'s
    ranks that share this rank's coordinates off ``names`` (in the order
    of their coordinates on ``names``, raveled)."""
    from repro_torch.core.sharded_index import Mesh
    names = tuple(names)
    sub = dm[names[0]] if len(names) == 1 else dm[names]._flatten()
    return Mesh((sub.size(),), ("_".join(names),), device=dm.device_type,
                group=sub.get_group())


def mesh_placements(dm, dp: Sequence[str], on_dp, on_tp) -> list:
    """Placements over ``dm``: ``on_dp`` on each dp axis, ``on_tp`` on the
    other (the tp axis)."""
    return [on_dp if name in tuple(dp) else on_tp
            for name in dm.mesh_dim_names]
