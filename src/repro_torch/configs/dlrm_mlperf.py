"""dlrm-mlperf [recsys] — n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot.
MLPerf DLRM benchmark config (Criteo 1TB). [arXiv:1906.00091; paper]

Table sizes are the 26 Criteo-Terabyte categorical cardinalities from the
MLPerf reference implementation (~187.8M rows total -> 24B embedding params
at dim 128). Big tables (>=1M rows) are row-sharded over ALL mesh axes.
"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, ShapeCell

# MLPerf/Criteo-1TB categorical cardinalities (facebookresearch/dlrm reference)
TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

CONFIG = RecsysConfig(
    name="dlrm-mlperf",
    model="dlrm",
    n_dense=13,
    n_sparse=26,
    embed_dim=128,
    table_sizes=TABLE_SIZES,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    row_pad_to=2048,     # divisible by 512 chips for all-axis row sharding
)

CELLS = (
    ShapeCell("train_batch", "train", batch=65536),
    ShapeCell("serve_p99", "serve", batch=512),
    ShapeCell("serve_bulk", "serve", batch=262144),
    ShapeCell("retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
)

ARCH = ArchSpec(arch_id="dlrm-mlperf", family="recsys", config=CONFIG,
                cells=CELLS)
