"""Production and test meshes (port of ``repro/launch/mesh.py``).

The reference's meshes are TPU device grids: single pod (data=16,
model=16), multi-pod (pod=2, data=16, model=16).  The port has two kinds:

* the logical ``core.sharded_index.Mesh`` of the sharded index
  (``make_production_mesh``, ``make_test_mesh``): the same axis names and
  sizes, every cell run in turn on one device, or one rank a cell over a
  process group;
* a ``torch.distributed`` ``DeviceMesh`` with the reference's axis names
  (``make_device_mesh``), over which the cell programs' tensors are
  DTensors.  Rank r holds the mesh's row-major coordinate r, the cell a
  ``core.sharded_index.Mesh`` of the same shape over the same group gives
  rank r.  ``make_fake_production_mesh`` builds the
  production meshes for the dry run over PyTorch's fake process group:
  this process is rank 0 of 256 or 512, and no collective moves data.

Functions, not constants: importing this module touches no device and
starts no process group.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.sharded_index import Mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device)


def make_test_mesh(shape: Sequence[int] = (4, 2),
                   axes: Sequence[str] = ("data", "model"),
                   device=None) -> Mesh:
    """Small mesh for CI-size tests."""
    return Mesh(shape, axes, device=device)


def dp_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def production_shape(multi_pod: bool) -> tuple[tuple[int, ...],
                                               tuple[str, ...]]:
    """(shape, axis names) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_device_mesh(shape: Sequence[int],
                     axes: Sequence[str] = ("data", "model"),
                     device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group, which
    must be started and hold ``prod(shape)`` ranks; its dimensions named
    ``axes``.  Rank r sits at the row-major coordinate r."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs a started process group "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_fake_mesh(shape: Sequence[int],
                   axes: Sequence[str] = ("data", "model"),
                   device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over PyTorch's fake process group,
    this process its rank 0: for the dry run, whose tensors live on
    ``meta`` and whose collectives move nothing.  A default group of
    another kind is refused; a fake one of another size is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 1
    for s in shape:
        world *= int(s)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is "
                               f"running: the dry run's fake group cannot "
                               f"start beside it")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return make_device_mesh(shape, axes, device_type)


def make_fake_production_mesh(*, multi_pod: bool = False,
                              device_type: str = "cpu"):
    """The production mesh over the fake process group, this process rank
    0 of 256 (or 512 with ``multi_pod``)."""
    return make_fake_mesh(*production_shape(multi_pod), device_type)
