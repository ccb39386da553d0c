"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152,
llama-arch small, tied embeddings. [hf:HuggingFaceTB/SmolLM-135M; hf]

9 heads / 3 KV heads don't divide tp=16 -> sequence-sharded attention.
"""
from repro_torch.configs.base import ArchSpec, LMConfig, ShapeCell

CONFIG = LMConfig(
    name="smollm-135m",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    attn_shard="sequence",
    tie_embeddings=True,
)

CELLS = (
    ShapeCell("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeCell("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeCell("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeCell("long_500k", "decode", seq_len=524288, global_batch=1,
              skip=True,
              skip_reason="pure full attention; no sub-quadratic structure "
                          "(DESIGN.md §5)"),
)

ARCH = ArchSpec(arch_id="smollm-135m", family="lm", config=CONFIG, cells=CELLS)
