"""Distribution utilities (port of ``repro/distributed``: re-exports; the
implementations live with their users).

  * meshes:               launch/mesh.py  (make_production_mesh, dp_axes),
                          over core/sharded_index.Mesh (one rank a cell
                          with a torch.distributed group)
  * logical->mesh axes:   models/layers.Axes
  * collectives:          core/search.merge_topk_pairs (the global top-k
                          merge of core/sharded_index), models/collectives
                          (the gathers and sums of models/moe and
                          models/mace)
  * gradient compression: train/grad_compress (int8 error-feedback sum)
  * elastic resharding:   checkpoint/checkpointer.Checkpointer.restore
"""
from repro_torch.core.search import merge_topk_pairs
from repro_torch.launch.mesh import (dp_axes, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models.layers import Axes

__all__ = ["Axes", "dp_axes", "make_production_mesh", "make_test_mesh",
           "merge_topk_pairs"]
