"""autoint [recsys] — n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32 interaction=self-attn. [arXiv:1810.11921; paper]

39 fields = 13 bucketized-numeric (64 buckets each) + 26 categorical hashed
to <=100k (the paper hashes rare values; sizes below mirror Criteo post-hash).
"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, ShapeCell

TABLE_SIZES = tuple([64] * 13 + [
    100000, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 100000,
    100000, 100000, 10, 2208, 11938, 155, 4, 976, 14, 100000,
    100000, 100000, 100000, 12972, 108, 36,
])

CONFIG = RecsysConfig(
    name="autoint",
    model="autoint",
    n_sparse=39,
    embed_dim=16,
    table_sizes=TABLE_SIZES,
    n_attn_layers=3,
    n_attn_heads=2,
    d_attn=32,
)

CELLS = (
    ShapeCell("train_batch", "train", batch=65536),
    ShapeCell("serve_p99", "serve", batch=512),
    ShapeCell("serve_bulk", "serve", batch=262144),
    ShapeCell("retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
)

ARCH = ArchSpec(arch_id="autoint", family="recsys", config=CONFIG, cells=CELLS)
