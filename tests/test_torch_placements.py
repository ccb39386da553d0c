"""The port's production sharding held against the reference's: for every
registered cell that is not skipped, on the single-pod (16, 16) and the
multi-pod (2, 16, 16) meshes, ``CellProgram.placements`` equals the
reference's ``in_shardings`` specs leaf for leaf (as tuples), and rank 0's
DTensor shard of every argument has the shape the reference's
``NamedSharding(mesh, spec).shard_shape`` gives.

The reference's programs are built over an ``AbstractMesh`` (no device
needed; its specs depend on the mesh's axis sizes alone).  The port's
shards are read over the fake process group as rank 0 of 256 / 512
(``launch/mesh.make_fake_production_mesh``).  Where a split does not divide
a dimension, ``shard_shape`` refuses and the reference's jit pads every
shard to the ceiling; rank 0 holds that ceiling in both packages, which is
what the test holds the port to there.
"""
import math

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from jax_release import release_compiled_executables  # noqa: F401
from repro.launch import steps as jsteps
from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models.layers import P, placements
from repro_torch.tree import flatten_with_names, leaves

CELLS = [(a, c.name) for a in ASSIGNED for c in get_arch(a).cells
         if not c.skip]
CASES = [(a, c, mp) for a, c in CELLS for mp in (False, True)]


def _abstract(multi_pod: bool) -> AbstractMesh:
    shape, axes = tmesh.production_shape(multi_pod)
    return AbstractMesh(shape, axes)


@pytest.fixture(scope="module")
def reference():
    from repro.models import mace as jmace
    jmace._paths_and_cg(2)      # fill the CG cache before any eval_shape
    cache = {}

    def build(arch, cell, multi_pod):
        key = (arch, cell, multi_pod)
        if key not in cache:
            cache[key] = jsteps.build_cell(arch, cell, _abstract(multi_pod),
                                           multi_pod)
        return cache[key]
    return build


@pytest.fixture(scope="module")
def fake_meshes():
    import torch.distributed as dist
    meshes = {}

    def get(multi_pod):
        if multi_pod not in meshes or dist.get_world_size() != math.prod(
                meshes[multi_pod].shape):
            meshes[multi_pod] = tmesh.make_fake_production_mesh(
                multi_pod=multi_pod)
        return meshes[multi_pod]
    yield get
    if dist.is_initialized():
        dist.destroy_process_group()


def _ref_leaves(jprog):
    shardings = jax.tree_util.tree_leaves(
        jprog.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    args = jax.tree_util.tree_leaves(jprog.args)
    assert len(shardings) == len(args)
    return [(tuple(s.spec), tuple(a.shape), s) for s, a in zip(shardings,
                                                              args)]


def _port(arch, cell, multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device="meta")
    return steps.build_cell(arch, cell, mesh, multi_pod)


@pytest.mark.parametrize("arch,cell,multi_pod", CASES,
                         ids=[f"{a}/{c}/{'multipod' if m else 'single'}"
                              for a, c, m in CASES])
def test_specs_and_shards_match_reference(arch, cell, multi_pod, reference,
                                          fake_meshes):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    prog = _port(arch, cell, multi_pod)
    want = _ref_leaves(reference(arch, cell, multi_pod))
    specs = leaves(prog.placements)
    shapes = [s.shape for s in leaves(prog.args)]
    assert all(isinstance(s, P) for s in specs)
    assert len(specs) == len(want) == len(shapes)
    assert [tuple(s) for s in specs] == [w[0] for w in want]
    assert shapes == [w[1] for w in want]
    # rank 0's shard
    mesh = fake_meshes(multi_pod)
    for spec, shape, (_, _, sharding) in zip(specs, shapes, want):
        local, _ = compute_local_shape_and_global_offset(
            shape, mesh, placements(spec, mesh))
        try:
            ref = sharding.shard_shape(shape)
        except ValueError:      # an uneven split: jit pads to the ceiling
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            ref = tuple(-(-n // math.prod(sizes[a] for a in (
                e if isinstance(e, tuple) else (e,) if e else ())))
                for n, e in zip(shape, tuple(spec) + (None,) * (
                    len(shape) - len(spec))))
        assert tuple(local) == tuple(ref), (spec, shape)


def test_placement_helper():
    """``P`` normalizes a one-axis tuple as ``PartitionSpec`` does;
    ``placements`` puts ``Shard(d)`` on each axis of dimension d (but an
    axis of size 1) and refuses an axis twice, out of order or missing."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 2)

    class Card:
        mesh_dim_names = ("data", "model")
        shape = (1, 1)

    assert tuple(P(("data",), None)) == ("data", None)
    assert placements(P(("pod", "data"), "model"), Mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert placements(P(), Mesh) == (Replicate(),) * 3
    assert placements(P(None, ("data", "model")), Mesh) == (
        Replicate(), Shard(1), Shard(1))
    # a split over one card holds the whole
    assert placements(P("data", "model"), Card) == (Replicate(),) * 2
    for bad in (P("model", "model"), P(("model", "data")), P("tp")):
        with pytest.raises(ValueError):
            placements(bad, Mesh)
    assert flatten_with_names({"a": P(None), "b": [P("data")]}) == [
        ("a", P(None)), ("b/0", P("data"))]
