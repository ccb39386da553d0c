"""The paper's ISS-595 shape-descriptor experiment (Zhong 2015, section 4 /
Fig. 5; port of ``repro/configs/rpf_iss595.py``).

N = 250,736 descriptors of 72 vehicle models, 595-D non-negative
histograms, chi-square divergence; L = 160 trees, C = 12, r = 0.3, K = 1;
recall@1 against the exact chi-square nearest neighbour, and the paper's
wall-clock speedup of the forest over that exact scan.  The serving cell
queries batches of 1024.
"""
from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.core.forest import ForestConfig

CONFIG = ForestConfig(n_trees=160, capacity=12, split_ratio=0.3, n_proj=1)

L_SWEEP = (10, 20, 40, 80, 160, 320)
N_DB = 250_736
N_TEST = 30_000
DIM = 595
METRIC = "chi2"
N_MODELS = 72
QUERY_BATCH = 1024

CELLS = (
    ShapeCell("index_build", "train", batch=N_DB),
    ShapeCell("query_batch", "serve", batch=QUERY_BATCH),
)

ARCH = ArchSpec(arch_id="rpf-iss595", family="ann", config=CONFIG,
                cells=CELLS, notes="paper Fig. 5 + 81x speedup reproduction")
