"""mind [recsys] — embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest (B2I dynamic routing). [arXiv:1904.08030; unverified]

1M-item catalog; retrieval_cand scores all 1M items against the 4 user
interest capsules — THE cell where the paper's RPF index plugs in
(brute-force fused matmul_topk vs forest-pruned rerank; EXPERIMENTS.md §Perf).
"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, ShapeCell

CONFIG = RecsysConfig(
    name="mind",
    model="mind",
    embed_dim=64,
    n_interests=4,
    capsule_iters=3,
    hist_len=50,
    item_vocab=1_000_000,
    table_sizes=(1_000_000,),
)

CELLS = (
    ShapeCell("train_batch", "train", batch=65536),
    ShapeCell("serve_p99", "serve", batch=512),
    ShapeCell("serve_bulk", "serve", batch=262144),
    ShapeCell("retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
)

ARCH = ArchSpec(arch_id="mind", family="recsys", config=CONFIG, cells=CELLS)
