"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b; hf]
"""
from repro_torch.configs.base import ArchSpec, LMConfig, ShapeCell

CONFIG = LMConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    attn_shard="heads",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fsdp=True,
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

ARCH = ArchSpec(arch_id="stablelm-12b", family="lm", config=CONFIG, cells=CELLS)
