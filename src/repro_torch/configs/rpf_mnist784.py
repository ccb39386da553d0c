"""The paper's own MNIST-784 configuration (Zhong 2015, section 4 / Fig. 4;
port of ``repro/configs/rpf_mnist784.py``).

N = 60000 unit-normalized 784-D rows; L = 80 trees, C = 12, r = 0.3, K = 1;
Euclidean distance; recall against exact nearest neighbours.  The serving
cell queries batches of 1024.
"""
from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.core.forest import ForestConfig

CONFIG = ForestConfig(n_trees=80, capacity=12, split_ratio=0.3, n_proj=1)

L_SWEEP = (1, 2, 5, 10, 20, 40, 80, 160, 320, 640)
N_DB = 60_000
N_TEST = 10_000
DIM = 784
METRIC = "l2"
QUERY_BATCH = 1024

CELLS = (
    ShapeCell("index_build", "train", batch=N_DB),
    ShapeCell("query_batch", "serve", batch=QUERY_BATCH),
)

ARCH = ArchSpec(arch_id="rpf-mnist784", family="ann", config=CONFIG,
                cells=CELLS, notes="paper Fig. 4 reproduction")
