"""mace [gnn] — n_layers=2 d_hidden=128 l_max=2 correlation_order=3 n_rbf=8,
E(3)-equivariant ACE message passing. [arXiv:2206.07697; paper]

Shape cells are generic-GNN datasets (the assignment pairs MACE with them):
  full_graph_sm  = Cora-like   (2708 nodes / 10556 edges / 1433 feats, 7 cls)
  minibatch_lg   = Reddit-like (232965 nodes / 114.6M edges, fanout 15-10,
                   602 feats, 41 cls) — REAL CSR neighbor sampler in data/
  ogb_products   = 2.45M nodes / 61.86M edges / 100 feats, 47 cls
  molecule       = 128 graphs x 30 nodes x 64 edges, energy (+forces) target
Positions are synthesized for the citation/product graphs (MACE is geometric);
node attributes enter through cfg.d_feat_in -> species-embedding projection.
"""
from repro_torch.configs.base import ArchSpec, MACEConfig, ShapeCell

CONFIG = MACEConfig(
    name="mace",
    n_layers=2,
    d_hidden=128,
    l_max=2,
    correlation_order=3,
    n_rbf=8,
    r_cut=5.0,
    n_species=16,
)

CELLS = (
    ShapeCell("full_graph_sm", "train", n_nodes=2708, n_edges=10556,
              d_feat=1433),
    ShapeCell("minibatch_lg", "train", n_nodes=232965, n_edges=114615892,
              batch_nodes=1024, fanout=(15, 10), d_feat=602),
    ShapeCell("ogb_products", "train", n_nodes=2449029, n_edges=61859140,
              d_feat=100),
    ShapeCell("molecule", "train", n_nodes=30, n_edges=64, n_graphs=128),
)

N_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47,
             "molecule": 0}

ARCH = ArchSpec(arch_id="mace", family="gnn", config=CONFIG, cells=CELLS)
