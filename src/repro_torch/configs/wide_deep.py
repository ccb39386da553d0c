"""wide-deep [recsys] — n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat. [arXiv:1606.07792; paper]

40 fields: 8 high-cardinality hashed (1M), 16 medium (10k), 16 small (100) —
the Google-Play-style app/impression feature mix from the paper.
"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, ShapeCell

TABLE_SIZES = tuple([1_000_000] * 8 + [10_000] * 16 + [100] * 16)

CONFIG = RecsysConfig(
    name="wide-deep",
    model="widedeep",
    n_sparse=40,
    embed_dim=32,
    table_sizes=TABLE_SIZES,
    mlp=(1024, 512, 256),
    row_pad_to=2048,     # divisible by 512 chips for all-axis row sharding
)

CELLS = (
    ShapeCell("train_batch", "train", batch=65536),
    ShapeCell("serve_p99", "serve", batch=512),
    ShapeCell("serve_bulk", "serve", batch=262144),
    ShapeCell("retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
)

ARCH = ArchSpec(arch_id="wide-deep", family="recsys", config=CONFIG,
                cells=CELLS)
