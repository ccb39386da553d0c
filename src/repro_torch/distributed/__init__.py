"""Distribution utilities (port of ``repro/distributed``: re-exports; the
implementations live with their users).

  * meshes:               launch/mesh.py  (make_production_mesh, dp_axes),
                          over core/sharded_index.Mesh (one rank a cell
                          with a torch.distributed group); the same meshes
                          as a DeviceMesh (make_device_mesh; the dry run's
                          make_fake_production_mesh over the fake group)
  * logical->mesh axes:   models/layers.Axes + per-model *_specs functions
                          (trees of models/layers.P), whose ``placements``
                          are a DTensor's; ``constrain`` is the
                          reference's with_sharding_constraint;
                          launch/steps.shard_args places a cell's arguments
  * collectives:          core/search.merge_topk_pairs (the global top-k
                          merge of core/sharded_index), models/collectives
                          (the gathers and sums of models/moe and
                          models/mace), and DTensor's own redistributions
  * gradient compression: train/grad_compress (int8 error-feedback sum)
  * elastic resharding:   checkpoint/checkpointer.Checkpointer.restore

``__all__`` keeps the reference's five names; the placement helpers are
importable from here beside them.
"""
from repro_torch.core.search import merge_topk_pairs
from repro_torch.launch.mesh import (dp_axes, make_device_mesh,
                                     make_fake_production_mesh,
                                     make_production_mesh, make_test_mesh)
from repro_torch.launch.steps import shard_args
from repro_torch.models.layers import Axes, P, constrain, placements

__all__ = ["Axes", "dp_axes", "make_production_mesh", "make_test_mesh",
           "merge_topk_pairs"]
