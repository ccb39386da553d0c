"""Core NN layers as plain functions over tensors (port of
``repro/models/layers.py``).

The initializers draw from an explicit ``torch.Generator`` on the device
they allocate on; on the ``meta`` device they allocate nothing and take no
generator, which is how the cell programs read shapes without memory (the
reference's ``jax.eval_shape``).  Norms compute in f32 and return the input
dtype, as the reference's do.  "f32" means at least f32 throughout
(``upcast``): a float64 input computes in float64, which a float64
gradient check of the port needs and the reference never meets.

Sharding: the reference's ``*_specs`` functions return ``PartitionSpec``
trees; the port's return the same trees as plain tuples, an entry a
tensor dimension: ``None`` (replicated), an axis name, or a tuple of axis
names (the dimension split over those axes, the first the slowest).
``placements`` turns such a spec into a ``torch.distributed`` DTensor's
placements over a ``DeviceMesh`` with the reference's axis names, and
``constrain`` is the reference's ``with_sharding_constraint``: it
redistributes a DTensor and returns a plain tensor unchanged.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Axes:
    """Mesh axis naming: dp = batch/data axes (includes 'pod' when multi-pod),
    tp = tensor-model axis; ``mesh`` the mesh the cell runs on: the port's
    logical ``core.sharded_index.Mesh``, or a ``DeviceMesh`` whose
    ``mesh_dim_names`` are the axes, over which the cell's tensors are
    DTensors."""

    dp: tuple[str, ...] = ("data",)
    tp: str = "model"
    mesh: object = None

    @property
    def device_mesh(self):
        """``mesh`` if it is a ``DeviceMesh``, else None."""
        return self.mesh if is_device_mesh(self.mesh) else None


def is_device_mesh(mesh) -> bool:
    return mesh is not None and hasattr(mesh, "mesh_dim_names")


def mesh_sizes(mesh) -> dict[str, int]:
    """axis name -> size, of a ``core.sharded_index.Mesh`` or a
    ``DeviceMesh`` (the reference's ``mesh.shape``)."""
    if is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry: () for None."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class P(tuple):
    """A partition spec, the reference's ``PartitionSpec``: ``P(None,
    "model")``.  A tuple that ``repro_torch.tree`` reads as a leaf, so a
    spec tree mirrors the tree of tensors it places."""

    _is_partition_spec = True

    def __new__(cls, *entries):
        # a one-axis tuple is that axis, as PartitionSpec normalizes it
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements over ``mesh`` (a ``DeviceMesh``) of a tensor
    whose dimensions are split as ``spec`` says: ``Shard(d)`` on each mesh
    axis that dimension ``d`` names, ``Replicate()`` on the others and on
    an axis of size 1 (a split over one card holds the whole, and DTensor's
    view rules refuse some reshapes of a split dimension even there).  A
    dimension over several axes must name them in the mesh's order (the
    slowest first, as the reference's flattened axes are); an axis named
    twice, an axis the mesh lacks or axes out of order raise."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        prev = -1
        for name in spec_axes(entry):
            if name not in names:
                raise ValueError(f"spec {spec} names axis {name!r}, which "
                                 f"mesh {names} lacks")
            i = names.index(name)
            if not isinstance(out[i], Replicate) or i <= prev:
                raise ValueError(f"spec {spec}: axis {name!r} named twice "
                                 f"or out of the mesh's order {names}")
            out[i], prev = Shard(d), i
    return tuple(Replicate() if n == 1 else p for p, n in zip(out, sizes))


def whole(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with dimension ``dim`` held whole on every rank: a DTensor
    split there is gathered (its other placements kept); anything else is
    returned as it is.  The sequence-parallel residual is gathered so
    before the products that flatten (batch, sequence) into rows, where a
    split sequence under a split batch would need DTensor's strided shards
    (and, on a mesh of three axes, its slow graph-search planner)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(
        t.device_mesh, pl)


class _GradWhole(torch.autograd.Function):
    """The identity, whose backward holds dimension ``dim`` of the
    cotangent whole (``whole``)."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim = dim
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return whole(g, ctx.dim), None


def grad_whole(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` unchanged, its gradient gathered on ``dim`` (``whole``) on
    the way back: a branch's output meets the sequence-parallel residual,
    whose gradient comes back split on the sequence, and must be gathered
    before the branch's products flatten (batch, sequence) into rows.  A
    plain tensor is returned as it is."""
    return _GradWhole.apply(t, dim) if is_dtensor(t) else t


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with pending sums (``Partial``, as a gather over a split
    vocabulary leaves it) summed into replicas; anything else unchanged."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def row_split_gather(table, ids, local_fn, weights=None, bag: bool = False):
    """Rows of the DTensor ``table`` (rows split over some mesh axes,
    ``Shard(0)``, replicated over the others) for ``ids``: a gather
    (*ids.shape, D), or with ``bag`` a bag over the last id axis (B, D).
    DTensor has no rule for the port's gathers, so this is written by
    hand, vocab-parallel: the ids (a DTensor on the table's mesh, or a
    plain tensor every rank holds whole) and ``weights`` are gathered over
    the axes that split the rows; ``local_fn(table shard, first row of the
    shard, ids, weights)`` gives this rank's part, zero for the ids outside
    its rows; the parts are summed over those axes and the result placed
    as the ids were.  The table's gradient is partial over the axes the
    ids are split on, as each rank's ids add to it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    rows_on = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if any(not isinstance(p, Replicate) and i not in rows_on
           for i, p in enumerate(table.placements)):
        raise NotImplementedError(f"a table placed {table.placements}: "
                                  f"only row splits are written")

    def dt(t):
        return t if is_dtensor(t) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    ids = dt(ids)
    want = tuple(ids.placements)
    if any(isinstance(p, Shard) and p.dim != 0 or p.is_partial()
           for p in want):
        raise NotImplementedError(f"ids placed {want}")
    # every rank of a row group sees the same ids
    full = [Replicate() if i in rows_on else p for i, p in enumerate(want)]
    ids_loc = ids.redistribute(mesh, full).to_local()
    w_loc = (None if weights is None
             else dt(weights).redistribute(mesh, full).to_local())
    _, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    grad_pl = [Partial() if isinstance(p, Shard) else table.placements[i]
               for i, p in enumerate(full)]
    out = local_fn(table.to_local(grad_placements=grad_pl), offset[0],
                   ids_loc, w_loc)
    part = [Partial() if i in rows_on else p for i, p in enumerate(full)]
    shape = (tuple(ids.shape[:1]) if bag else tuple(ids.shape)) + (
        out.shape[-1],)
    out = DTensor.from_local(out, mesh, part, run_check=False, shape=shape,
                             stride=contiguous_stride(shape))
    return out.redistribute(mesh, want)


def constrain(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """``with_sharding_constraint``: a DTensor redistributed to ``spec``'s
    placements on its mesh; a plain tensor unchanged."""
    if not is_dtensor(x):
        return x
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "float64": torch.float64}[name]


def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in float64 where it is float64 (the reference's
    ``astype(jnp.float32)``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def normal(generator: torch.Generator | None, shape: tuple[int, ...],
           device: torch.device) -> torch.Tensor:
    """Standard-normal f32 draws of ``shape`` on ``device`` from
    ``generator``; uninitialized on the ``meta`` device."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=generator, device=device)


def dense_init(generator: torch.Generator | None, d_in: int, d_out: int,
               dtype: torch.dtype, scale: float | None = None,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """(d_in, d_out) normal weights scaled by ``scale`` (1 / sqrt(d_in))."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(generator, (d_in, d_out), torch.device(device)
                  ).mul_(scale).to(dtype)


def embed_init(generator: torch.Generator | None, vocab: int, d: int,
               dtype: torch.dtype, device: torch.device | str = "cpu"
               ) -> torch.Tensor:
    return normal(generator, (vocab, d), torch.device(device)
                  ).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.to(xf.dtype))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * gamma.float() + beta.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, base: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                        device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float
               ) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    x1f, x2f = upcast(x[..., :half]), upcast(x[..., half:])
    freqs = rope_freqs(x.shape[-1], base, x.device).to(x1f.dtype)  # (half,)
    angle = positions[..., None].to(x1f.dtype) * freqs    # (..., S, half)
    cos = torch.cos(angle)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(angle)[..., None, :]
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last axis; on a DTensor split there (a
    vocabulary split over tp), vocab-parallel: the max and the sum of
    exponentials reduced over the split (two small all-reduces) instead of
    the logits gathered."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    m = settle(torch.amax(x, dim=-1, keepdim=True)).detach()
    return (torch.log(settle(torch.sum(torch.exp(x - m), dim=-1)))
            + m[..., 0])


def label_logits(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """``logits[..., labels]`` (the shape of ``labels``).  On a DTensor
    split on its last axis (a vocabulary split over tp), vocab-parallel:
    each rank takes the labels in its columns (zero for the others) and
    the parts are summed over the split, so the gradient is a scatter into
    the rank's own columns.  DTensor's rule for the gather would gather
    the logits whole, and its backward allocate the global logits' shape
    on every rank."""
    if not is_dtensor(logits):
        return torch.take_along_dim(logits, labels.long()[..., None],
                                    dim=-1)[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab_on = [i for i, p in enumerate(logits.placements)
                if p == Shard(last)]
    if not vocab_on:
        return settle(torch.take_along_dim(logits, labels.long()[..., None],
                                           dim=-1))[..., 0]
    if any(p.is_partial() for p in logits.placements):
        raise NotImplementedError(f"logits placed {logits.placements}")
    lab_pl = [Replicate() if i in vocab_on else p
              for i, p in enumerate(logits.placements)]
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, lab_pl).to_local().long()
    _, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    loc = logits.to_local()
    rel = lab - offset[last]
    mine = (rel >= 0) & (rel < loc.shape[last])
    part = torch.take_along_dim(loc, rel.clamp(0, loc.shape[last] - 1)
                                [..., None], dim=-1)[..., 0]
    part = torch.where(mine, part, 0.0)
    out_pl = [Partial() if i in vocab_on else p for i, p in enumerate(lab_pl)]
    shape = tuple(labels.shape)
    return settle(DTensor.from_local(part, mesh, out_pl, run_check=False,
                                     shape=shape,
                                     stride=contiguous_stride(shape)))


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    strides for ``DTensor.from_local``)."""
    out, n = [], 1
    for size in reversed(tuple(shape)):
        out.append(n)
        n *= size
    return tuple(reversed(out))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          z_loss: float = 0.0) -> torch.Tensor:
    """logits (..., V) f32-upcast CE with optional z-loss; labels int
    (...,)."""
    logits = upcast(logits)
    lse = logsumexp_last(logits)
    loss = lse - label_logits(logits, labels)
    if z_loss:
        loss = loss + z_loss * lse ** 2
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(loss)


def pad_vocab(v: int, multiple: int) -> int:
    return ((v + multiple - 1) // multiple) * multiple
