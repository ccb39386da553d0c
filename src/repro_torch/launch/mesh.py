"""Production and test meshes (port of ``repro/launch/mesh.py``).

The reference's meshes are TPU device grids: single pod (data=16,
model=16), multi-pod (pod=2, data=16, model=16).  Here they are the
logical ``core.sharded_index.Mesh`` of the sharded index: the same axis
names and sizes, every cell run in turn on one device.  Functions, not
constants: importing this module touches no device.
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
